"""The cache of environment tensors, in memory or on disk.

Port of ``tenpy_tpu/tools/cache.py``: a dict-like cache
(:class:`DictCache`) with a short-term layer over a storage, and
sub-caches that share one storage under a key prefix.  The environments of
the sweep engines keep their ``LP``/``RP`` tensors here.  The storages:
:class:`Storage` (in memory), :class:`PickleStorage` (a file per key in a
directory), :class:`Hdf5Storage` (a group per key of one HDF5 file, h5py
imported when it is opened) and :class:`ThreadedStorage` (another storage
driven by a worker thread, with preloading); :class:`CacheFile` opens one
from a simulation's ``cache_params``.  The file-backed storages move CUDA
tensors to the host before they write.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile

from .thread import Worker

logger = logging.getLogger(__name__)

__all__ = ['Storage', 'PickleStorage', 'Hdf5Storage', 'ThreadedStorage',
           'DictCache', 'CacheFile']


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


class PickleStorage(Storage):
    """One pickle file per key in a directory (a temporary one by
    default, removed on close with ``delete``)."""

    trivial = False

    def __init__(self, directory, delete=True):
        super().__init__()
        self.directory = str(directory)
        self._delete_on_close = delete
        os.makedirs(self.directory, exist_ok=True)
        self._keys = set()

    @classmethod
    def open(cls, directory=None, tmpdir=None, delete=True, **kwargs):
        if directory is None:
            directory = tempfile.mkdtemp(prefix='tenpy_tpu_torch_cache_',
                                         dir=tmpdir)
        return cls(directory, delete)

    def close(self):
        if self._delete_on_close and os.path.isdir(self.directory):
            shutil.rmtree(self.directory, ignore_errors=True)
        self._keys.clear()

    def _fn(self, key):
        return os.path.join(self.directory,
                            str(key).replace('/', '_') + '.pkl')

    def keys(self):
        return set(self._keys)

    def __contains__(self, key):
        return key in self._keys

    def save(self, key, value):
        from .io import save_pickle
        with open(self._fn(key), 'wb') as f:
            save_pickle(value, f)
        self._keys.add(key)

    def load(self, key):
        from .io import load_pickle
        with open(self._fn(key), 'rb') as f:
            return load_pickle(f)

    def delete(self, key):
        if key in self._keys:
            try:
                os.remove(self._fn(key))
            except OSError:
                pass
            self._keys.discard(key)


class Hdf5Storage(Storage):
    """One group per key in one HDF5 file (a temporary one by default,
    removed on close with ``delete``), written and read by
    :mod:`~tenpy_tpu_torch.tools.io`'s HDF5 format."""

    trivial = False

    def __init__(self, h5file, filename=None, delete=True):
        super().__init__()
        self.h5file = h5file
        self.filename = filename
        self._delete_on_close = delete
        self._keys = set()

    @classmethod
    def open(cls, filename=None, tmpdir=None, delete=True, mode='w',
             **kwargs):
        import h5py
        if filename is None:
            fd, filename = tempfile.mkstemp(
                suffix='.h5', prefix='tenpy_tpu_torch_cache_', dir=tmpdir)
            os.close(fd)
        return cls(h5py.File(filename, mode), filename, delete)

    def close(self):
        if self.h5file is not None:
            self.h5file.close()
            self.h5file = None
        if self._delete_on_close and self.filename and \
                os.path.isfile(self.filename):
            os.remove(self.filename)
        self._keys.clear()

    @staticmethod
    def _grp(key):
        return str(key).replace('/', '_')

    def keys(self):
        return set(self._keys)

    def __contains__(self, key):
        return key in self._keys

    def save(self, key, value):
        from .io import save_to_hdf5
        name = self._grp(key)
        if name in self.h5file:
            del self.h5file[name]
        save_to_hdf5(self.h5file, value, name)
        self._keys.add(key)

    def load(self, key):
        from .io import load_from_hdf5
        if key not in self._keys:
            raise KeyError(key)
        return load_from_hdf5(self.h5file, self._grp(key))

    def delete(self, key):
        if key in self._keys:
            name = self._grp(key)
            if name in self.h5file:
                del self.h5file[name]
            self._keys.discard(key)


class ThreadedStorage(Storage):
    """Another storage whose saves and preloads run on a worker thread.

    ``preload`` fetches keys in the background; ``save``, ``load`` and
    ``delete`` first wait for the queued tasks, so no read overtakes a
    write."""

    trivial = False

    def __init__(self, storage, worker=None):
        super().__init__()
        self.storage = storage
        self._own_worker = worker is None
        self.worker = worker or Worker('cache_io').__enter__()
        self._preloaded = {}

    @classmethod
    def open(cls, storage=None, **kwargs):
        if storage is None:
            storage = PickleStorage.open(**kwargs)
        return cls(storage)

    def close(self):
        self.worker.join_tasks()
        if self._own_worker:
            self.worker.__exit__(None, None, None)
        self.storage.close()
        self._preloaded.clear()

    def keys(self):
        return self.storage.keys()

    def __contains__(self, key):
        return key in self._preloaded or key in self.storage

    def save(self, key, value):
        self.worker.join_tasks()
        self._preloaded.pop(key, None)
        self.worker.put_task(self.storage.save, key, value)

    def load(self, key):
        self.worker.join_tasks()
        if key in self._preloaded:
            return self._preloaded.pop(key)
        return self.storage.load(key)

    def delete(self, key):
        self.worker.join_tasks()
        self._preloaded.pop(key, None)
        self.storage.delete(key)

    def preload(self, *keys):
        for key in keys:
            if key in self._preloaded or key not in self.storage:
                continue
            self.worker.put_task(self.storage.load, key,
                                 return_dict=self._preloaded, return_key=key)


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


class CacheFile(DictCache):
    """A :class:`DictCache` opened from options (a simulation's
    ``cache_params``): ``storage_class`` ('Storage', 'PickleStorage' or
    'Hdf5Storage', which takes 'PickleStorage' where h5py is absent),
    ``use_threading``, ``delete``, ``tmpdir``."""

    @classmethod
    def open(cls, storage_class='Storage', use_threading=False, delete=True,
             tmpdir=None, **kwargs):
        if storage_class == 'Storage':
            storage = Storage.open()
        elif storage_class == 'PickleStorage':
            storage = PickleStorage.open(tmpdir=tmpdir, delete=delete)
        elif storage_class == 'Hdf5Storage':
            try:
                storage = Hdf5Storage.open(tmpdir=tmpdir, delete=delete)
            except ImportError:
                logger.warning("Hdf5Storage unavailable (no h5py); using "
                               "PickleStorage")
                storage = PickleStorage.open(tmpdir=tmpdir, delete=delete)
        else:
            raise ValueError(f"unknown storage_class {storage_class!r}")
        if use_threading and not storage.trivial:
            storage = ThreadedStorage.open(storage)
        return cls(storage)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
