"""Option dictionaries that record their defaults, and YAML parameter
files.

Port of ``Config``, ``asConfig`` and ``load_yaml_with_py_eval`` from
``tenpy_tpu/tools/params.py``: ``get(key, default)`` stores the default it
returns, so the options a model or an engine was built with are complete
afterwards (a simulation saves them with its results), and keys never read
stay in ``unused`` (:meth:`Config.warn_unused` reports them: typos).
Nested option dicts (``trunc_params``, ``lanczos_params``, ...) become
sub-Configs by :meth:`Config.subconfig`; the dict interface is what the
sweep engines use to adapt options while they run.  PyYAML is imported
only by :func:`load_yaml_with_py_eval`.
"""

from __future__ import annotations

import logging
import warnings

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ['Config', 'asConfig', 'load_yaml_with_py_eval']


class Config:
    """Options with default recording and unused-key tracking.

    Parameters
    ----------
    config : dict
        The option values.
    name : str
        Name used in log messages and warnings.
    """

    def __init__(self, config, name):
        self.options = dict(config)
        self.name = str(name)
        self.unused = set(self.options.keys())

    # --------------------------------------------------------- dict interface
    def __getitem__(self, key):
        self.unused.discard(key)
        return self.options[key]

    def __setitem__(self, key, value):
        if key not in self.options:
            self.unused.add(key)
        self.options[key] = value

    def __delitem__(self, key):
        self.unused.discard(key)
        del self.options[key]

    def __contains__(self, key):
        return key in self.options

    def __iter__(self):
        return iter(self.options)

    def __len__(self):
        return len(self.options)

    def keys(self):
        return self.options.keys()

    def values(self):
        return self.options.values()

    def items(self):
        return self.options.items()

    def copy(self):
        res = Config(dict(self.options), self.name)
        res.unused = set(self.unused)
        return res

    def as_dict(self):
        """A plain-dict snapshot (sub-Configs converted recursively)."""
        return {k: v.as_dict() if isinstance(v, Config) else v
                for k, v in self.options.items()}

    def update(self, other):
        for k, v in dict(other).items():
            self[k] = v

    def setdefault(self, key, default):
        if key not in self.options:
            self.options[key] = default
        return self.get(key, default)

    # ---------------------------------------------------------------- reading
    def get(self, key, default, expect_type=None):
        """Read an option, storing ``default`` if the key is absent.

        ``expect_type`` (a type, ``'real'`` or ``None``) warns on a
        mismatch."""
        if key not in self.options:
            self.options[key] = default
            logger.debug("%s: reading option %r (default) = %r", self.name,
                         key, default)
        self.unused.discard(key)
        val = self.options[key]
        if expect_type is not None and val is not None:
            self._check_type(key, val, expect_type)
        return val

    def silent_get(self, key, default):
        """Like :meth:`get`, without storing the default or marking the key
        as used."""
        return self.options.get(key, default)

    def touch(self, *keys):
        """Mark ``keys`` as used without reading them."""
        for k in keys:
            self.unused.discard(k)
        return self

    def warn_unused(self, recursive=False):
        """Warn about the options never read (with ``recursive``, in the
        sub-Configs too)."""
        unused = sorted(self.unused)
        if unused:
            warnings.warn(f"unused options in config {self.name!r}: "
                          f"{unused}", UserWarning, stacklevel=2)
        if recursive:
            for v in self.options.values():
                if isinstance(v, Config):
                    v.warn_unused(True)

    def subconfig(self, key, default=None):
        """The nested option dict ``key`` as a sub-:class:`Config` (stored
        in place of the dict, so later reads share it)."""
        self.unused.discard(key)
        if key not in self.options:
            self.options[key] = {} if default is None else default
        val = self.options[key]
        if isinstance(val, Config):
            return val
        sub = Config(val if isinstance(val, dict) else {},
                     f"{self.name}.{key}")
        self.options[key] = sub
        return sub

    def _check_type(self, key, val, expect_type):
        ok = True
        if expect_type == 'real':
            ok = np.isrealobj(val) if not np.isscalar(val) \
                else not isinstance(val, complex)
        elif isinstance(expect_type, type):
            if expect_type is int:
                ok = isinstance(val, (int, np.integer)) \
                    and not isinstance(val, bool)
            elif expect_type is float:
                ok = isinstance(val, (int, float, np.integer, np.floating))
            else:
                ok = isinstance(val, expect_type)
        if not ok:
            warnings.warn(f"{self.name}: option {key!r}={val!r} not of "
                          f"expected type {expect_type}", UserWarning,
                          stacklevel=4)

    def __repr__(self):
        return f"Config({self.name!r}, <{len(self.options)} options>)"

    def __getstate__(self):
        return {'options': self.as_dict(), 'name': self.name,
                'unused': sorted(self.unused)}

    def __setstate__(self, state):
        self.options = dict(state['options'])
        self.name = state['name']
        self.unused = set(state.get('unused', ()))


def asConfig(config, name):
    """Wrap a dict as :class:`Config` (a Config passes through)."""
    if isinstance(config, Config):
        return config
    return Config(config, name)


def load_yaml_with_py_eval(filename=None, yaml_content=None, context=None):
    """Load YAML (a file, or the string ``yaml_content``) in which the tag
    ``!py_eval`` evaluates a python expression (``np`` and ``context`` in
    scope)."""
    import yaml

    context_ns = {'np': np}
    if context:
        context_ns.update(context)

    class PyEvalLoader(yaml.SafeLoader):
        pass

    def _py_eval(loader, node):
        return eval(loader.construct_scalar(node), context_ns)  # noqa: S307

    PyEvalLoader.add_constructor('!py_eval', _py_eval)
    if yaml_content is not None:
        return yaml.load(yaml_content, Loader=PyEvalLoader)
    with open(filename, 'r') as f:
        return yaml.load(f, Loader=PyEvalLoader)
