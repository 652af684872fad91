"""The in-memory cache of environment tensors.

Port of ``Storage``, ``DictCache`` and ``_PrefixedCache`` from
``tenpy_tpu/tools/cache.py``: a dict-like cache with a short-term layer
over a storage, and sub-caches that share one storage under a key prefix.
The environments of the sweep engines keep their ``LP``/``RP`` tensors
here.  Only the in-memory storage is ported; the file-backed storages
(pickle, HDF5, threaded) are not.
"""

from __future__ import annotations

__all__ = ['Storage', 'DictCache']


class Storage:
    """In-memory key-value storage."""

    trivial = True

    def __init__(self):
        self.data = {}

    @classmethod
    def open(cls, **kwargs):
        return cls()

    def close(self):
        self.data.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def keys(self):
        return self.data.keys()

    def __contains__(self, key):
        return key in self.data

    def save(self, key, value):
        self.data[key] = value

    def load(self, key):
        return self.data[key]

    def delete(self, key):
        self.data.pop(key, None)

    def preload(self, *keys):
        pass


class DictCache:
    """A dict-like cache: keys declared short-term stay in a RAM layer,
    everything is saved to ``storage``."""

    def __init__(self, storage=None):
        self.storage = storage if storage is not None else Storage()
        self.short_term_cache = {}
        self.short_term_keys = set()

    @classmethod
    def trivial(cls):
        return cls(Storage())

    def close(self):
        self.storage.close()
        self.short_term_cache.clear()

    def __contains__(self, key):
        return key in self.short_term_cache or key in self.storage

    def __getitem__(self, key):
        if key in self.short_term_cache:
            return self.short_term_cache[key]
        val = self.storage.load(key)
        if key in self.short_term_keys:
            self.short_term_cache[key] = val
        return val

    def __setitem__(self, key, value):
        if key in self.short_term_keys:
            self.short_term_cache[key] = value
        self.storage.save(key, value)

    def __delitem__(self, key):
        self.short_term_cache.pop(key, None)
        self.storage.delete(key)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def keys(self):
        return set(self.short_term_cache) | set(self.storage.keys())

    def set_short_term_keys(self, *keys):
        """Declare which keys to keep in RAM; others leave the RAM layer."""
        self.short_term_keys = keys = set(keys)
        for k in list(self.short_term_cache.keys()):
            if k not in keys:
                del self.short_term_cache[k]

    def preload(self, *keys, raise_missing=False):
        """Hint that ``keys`` will be loaded soon."""
        for k in keys:
            if k not in self and raise_missing:
                raise KeyError(k)
        self.short_term_keys |= set(keys)
        self.storage.preload(*[k for k in keys
                               if k not in self.short_term_cache])

    def create_subcache(self, name):
        """A nested cache sharing the storage under a key prefix."""
        return _PrefixedCache(self, str(name) + '/')


class _PrefixedCache:
    def __init__(self, parent, prefix):
        self.parent = parent
        self.prefix = prefix

    def _k(self, key):
        return self.prefix + str(key)

    def __contains__(self, key):
        return self._k(key) in self.parent

    def __getitem__(self, key):
        return self.parent[self._k(key)]

    def __setitem__(self, key, value):
        self.parent[self._k(key)] = value

    def __delitem__(self, key):
        del self.parent[self._k(key)]

    def get(self, key, default=None):
        return self.parent.get(self._k(key), default)

    def set_short_term_keys(self, *keys):
        self.parent.set_short_term_keys(*[self._k(k) for k in keys])

    def preload(self, *keys, **kw):
        self.parent.preload(*[self._k(k) for k in keys], **kw)

    def create_subcache(self, name):
        return _PrefixedCache(self.parent, self.prefix + str(name) + '/')

    def close(self):
        pass
