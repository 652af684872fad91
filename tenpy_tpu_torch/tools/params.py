"""Option dictionaries that record their defaults.

Port of ``Config`` and ``asConfig`` from ``tenpy_tpu/tools/params.py``:
``get(key, default)`` stores the default it returns, so the options a model
or an engine was built with are complete afterwards, and keys never read
stay in ``unused``.  Nested option dicts (``trunc_params``,
``lanczos_params``, ...) become sub-Configs by :meth:`Config.subconfig`;
the dict interface (``cfg[key] = value``, ``in``, ``setdefault``) is what
the sweep engines use to adapt options while they run.
"""

from __future__ import annotations

import logging
import warnings

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ['Config', 'asConfig']


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

    def __contains__(self, key):
        return key in self.options

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


def asConfig(config, name):
    """Wrap a dict as :class:`Config` (a Config passes through)."""
    if isinstance(config, Config):
        return config
    return Config(config, name)
