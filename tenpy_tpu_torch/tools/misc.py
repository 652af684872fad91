"""Small helpers for models, lattices, eigensolvers and simulations.

Port of ``tenpy_tpu/tools/misc.py``: ``to_iterable``, ``to_array``,
``argsort``, ``inverse_permutation``, ``find_subclass`` (by class name
among the loaded subclasses, or by a dotted ``module.Class`` path), the
recursive-dict helpers of the simulation options (``get_recursive``,
``set_recursive``, ``update_recursive``, ``merge_recursive``,
``flatten``), ``setup_logging``, ``consistency_check`` and
``convert_memory_units``.

Module paths given by name (a dotted class in ``find_subclass``, a
measurement or post-processing module of a simulation, a global of an
HDF5 file) may name the reference library (``tenpy.``) or the JAX package
(``tenpy_tpu.``); :func:`port_module_name` maps both onto this package, so
that nothing of either is ever imported.
"""

from __future__ import annotations

import importlib
import logging.config
import os

import numpy as np

__all__ = ['to_iterable', 'to_iterable_of_len', 'to_array', 'argsort',
           'inverse_permutation', 'find_subclass', 'port_module_name',
           'import_port_module',
           'get_recursive', 'set_recursive', 'update_recursive',
           'merge_recursive', 'flatten', 'setup_logging',
           'consistency_check', 'TenpyInconsistencyError',
           'convert_memory_units']

_UNSET = object()


class TenpyInconsistencyError(Exception):
    """Raised by :func:`consistency_check` when a guard rail is violated."""


def to_iterable(a):
    """Wrap a scalar or a string into a list; pass iterables through."""
    if isinstance(a, str):
        return [a]
    try:
        iter(a)
        return a
    except TypeError:
        return [a]


def to_iterable_of_len(a, L):
    """Like :func:`to_iterable`, with a length-1 result tiled to ``L``."""
    a = list(to_iterable(a))
    if len(a) == 1:
        return a * L
    if len(a) != L:
        raise ValueError(f"length {len(a)} != {L}")
    return a


def to_array(a, shape=(None,), dtype=None, allow_incommensurate=False):
    """An ndarray of ``shape``: scalars broadcast, other arrays must have
    ``len(shape)`` axes and are tiled periodically along each (an
    incommensurate axis raises, or is tiled past ``shape`` and cropped with
    ``allow_incommensurate``)."""
    a = np.array(a, dtype=dtype)
    if a.ndim != len(shape):
        if a.size != 1:
            raise ValueError("cannot cast to required number of dimensions")
        a = np.reshape(a, [1] * len(shape))
    reps = [1] * a.ndim
    crop = [slice(None)] * a.ndim
    for i, want in enumerate(shape):
        if want is None:
            continue
        q, r = divmod(want, a.shape[i])
        if r != 0:
            if not allow_incommensurate:
                raise ValueError(f"incommensurate tiling {a.shape[i]} -> "
                                 f"{want}")
            q += 1
            crop[i] = slice(None, want)
        reps[i] = q
    return np.tile(a, reps)[tuple(crop)]


def argsort(a, sort=None):
    """``np.argsort`` by ``sort``: 'm>'/'LM' (largest magnitude first),
    'm<'/'SM', '>'/'LR'/'LA' (largest real part first), '<'/'SR'/'SA', or
    None (the identity); ties keep their order."""
    if sort is None:
        return np.arange(len(a))
    a = np.asarray(a)
    if sort in ('m>', 'LM'):
        return np.argsort(-np.abs(a), kind='stable')
    if sort in ('m<', 'SM'):
        return np.argsort(np.abs(a), kind='stable')
    if sort in ('>', 'LR', 'LA'):
        return np.argsort(-np.real(a), kind='stable')
    if sort in ('<', 'SR', 'SA'):
        return np.argsort(np.real(a), kind='stable')
    raise ValueError(f"unknown sort order {sort!r}")


def inverse_permutation(perm):
    perm = np.asarray(perm, np.intp)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def port_module_name(module):
    """``module`` with a ``tenpy.`` or ``tenpy_tpu.`` prefix mapped onto
    ``tenpy_tpu_torch.`` (other names pass through)."""
    for prefix in ('tenpy_tpu.', 'tenpy.'):
        if module.startswith(prefix):
            return 'tenpy_tpu_torch.' + module[len(prefix):]
    if module in ('tenpy', 'tenpy_tpu'):
        return 'tenpy_tpu_torch'
    return module


def import_port_module(module):
    """Import ``module`` after :func:`port_module_name`."""
    return importlib.import_module(port_module_name(module))


def find_subclass(base_class, subclass_name):
    """The loaded subclass of ``base_class`` named ``subclass_name``, or
    the class at a dotted path ``'module.Class'`` (its module mapped by
    :func:`port_module_name`); a subclass itself passes through."""
    if not isinstance(subclass_name, str):
        if isinstance(subclass_name, type) and \
                issubclass(subclass_name, base_class):
            return subclass_name
        raise TypeError(f"expect str or subclass of {base_class}, got "
                        f"{subclass_name!r}")
    if '.' in subclass_name:
        mod_name, cls_name = subclass_name.rsplit('.', 1)
        cls = getattr(import_port_module(mod_name), cls_name)
        if not (isinstance(cls, type) and issubclass(cls, base_class)):
            raise ValueError(f"{subclass_name} is not a subclass of "
                             f"{base_class.__name__}")
        return cls
    found, to_check, seen = set(), [base_class], set()
    while to_check:
        cls = to_check.pop()
        if cls in seen:
            continue
        seen.add(cls)
        if cls.__name__ == subclass_name:
            found.add(cls)
        to_check.extend(cls.__subclasses__())
    if len(found) == 1:
        return found.pop()
    if found:
        raise ValueError(f"multiple subclasses named {subclass_name!r}")
    raise ValueError(f"no subclass of {base_class.__name__} named "
                     f"{subclass_name!r} is loaded")


# ----------------------------------------------------------- recursive dicts
def get_recursive(nested_data, recursive_key, separator='.', default=_UNSET):
    """``nested_data[k0][k1]...`` for ``recursive_key = 'k0.k1...'``."""
    data = nested_data
    try:
        for k in recursive_key.lstrip(separator).split(separator):
            data = data[k]
    except KeyError:
        if default is _UNSET:
            raise
        return default
    return data


def set_recursive(nested_data, recursive_key, value, separator='.',
                  insert_dicts=False):
    """Set ``nested_data[k0][k1]... = value`` (missing levels inserted as
    dicts with ``insert_dicts``)."""
    keys = recursive_key.lstrip(separator).split(separator)
    data = nested_data
    for k in keys[:-1]:
        if insert_dicts and k not in data:
            data[k] = {}
        data = data[k]
    data[keys[-1]] = value


def update_recursive(nested_data, update_data, separator='.',
                     insert_dicts=True):
    """:func:`set_recursive` for every ``key: value`` of ``update_data``."""
    for k, v in update_data.items():
        set_recursive(nested_data, k, v, separator, insert_dicts)


def merge_recursive(*nested_data, conflict='error', path=None):
    """Merge nested dicts; on different values at one key ``conflict``
    says which wins: 'first', 'last', or 'error' (raise)."""
    if not nested_data:
        raise ValueError("need at least one dict")
    if len(nested_data) == 1:
        return nested_data[0]
    merged = dict(nested_data[0])
    for data in nested_data[1:]:
        for key, val in data.items():
            if key not in merged:
                merged[key] = val
                continue
            old = merged[key]
            if isinstance(old, dict) and isinstance(val, dict):
                merged[key] = merge_recursive(
                    old, val, conflict=conflict,
                    path=(path or []) + [repr(key)])
            elif old is not val and old != val:
                if conflict == 'error':
                    loc = '.'.join((path or []) + [repr(key)])
                    raise ValueError(f"conflicting values for {loc}: "
                                     f"{old!r} vs {val!r}")
                if conflict == 'last':
                    merged[key] = val
                elif conflict != 'first':
                    raise ValueError(f"unknown conflict resolution "
                                     f"{conflict!r}")
    return merged


def flatten(mapping, separator='.'):
    """Nested dicts as one dict with joined keys."""
    res = {}
    for k, v in mapping.items():
        if isinstance(v, dict):
            for k2, v2 in flatten(v, separator).items():
                res[k + separator + k2] = v2
        else:
            res[k] = v
    return res


# ------------------------------------------------------------------ logging
def setup_logging(options=None, output_filename=None, **kwargs):
    """Configure python's logging: a stdout handler and a log file beside
    the output (``<output without extension>.log``).

    Options: ``skip_setup``, ``to_stdout`` ('INFO'; None or False: no
    stdout handler), ``to_file`` ('INFO'), ``filename``, ``format``,
    ``datefmt``, ``levels`` ({logger name: level}), ``capture_warnings``
    (True), ``dict_config`` (replaces all of the above)."""
    from .params import asConfig
    options = asConfig(options if options is not None else {}, 'log')
    options.update(kwargs)
    if options.get('skip_setup', False):
        return
    dict_config = options.get('dict_config', None)
    if dict_config is None:
        to_stdout = options.get('to_stdout', 'INFO')
        to_file = options.get('to_file', 'INFO')
        fmt = options.get('format', '%(levelname)-8s : %(message)s')
        datefmt = options.get('datefmt', None)
        filename = options.get('filename', None)
        if filename is None and output_filename is not None and to_file:
            filename = os.path.splitext(output_filename)[0] + '.log'
        handlers = {}
        if to_stdout:
            handlers['to_stdout'] = {'class': 'logging.StreamHandler',
                                     'level': to_stdout,
                                     'formatter': 'custom',
                                     'stream': 'ext://sys.stdout'}
        if to_file and filename is not None:
            handlers['to_file'] = {'class': 'logging.FileHandler',
                                   'level': to_file, 'formatter': 'custom',
                                   'filename': filename, 'mode': 'a'}
        dict_config = {
            'version': 1,
            'disable_existing_loggers': False,
            'formatters': {'custom': {'format': fmt, 'datefmt': datefmt}},
            'handlers': handlers,
            'root': {'handlers': list(handlers), 'level': 'DEBUG'},
            'loggers': {name: {'level': level} for name, level in
                        options.get('levels', {}).items()},
        }
    logging.config.dictConfig(dict_config)
    if options.get('capture_warnings', True):
        logging.captureWarnings(True)


def consistency_check(value, options, threshold_key, threshold_default, msg,
                      compare='<='):
    """Raise :class:`TenpyInconsistencyError` unless ``value compare
    threshold``, the threshold read from ``options[threshold_key]``
    (default ``threshold_default``; None disables the check)."""
    threshold = options.get(threshold_key, threshold_default)
    if threshold is None:
        return
    if compare == '<=':
        ok = value <= threshold
    elif compare == '<':
        ok = value < threshold
    elif compare == '>=':
        ok = value >= threshold
    elif compare == '>':
        ok = value > threshold
    else:
        raise ValueError(f"unknown compare {compare!r}")
    if not ok:
        raise TenpyInconsistencyError(
            f"{msg} (got {value!r}, threshold {threshold_key}="
            f"{threshold!r}; raise the threshold option to silence this "
            f"check)")


def convert_memory_units(value, unit_from='bytes', unit_to=None):
    """``(value, unit)`` converted between bytes, KB, MB, GB and TB (powers
    of 1024); ``unit_to=None`` picks the largest unit below 1024."""
    units = ['bytes', 'KB', 'MB', 'GB', 'TB']
    val = float(value) * 1024 ** units.index(unit_from)
    if unit_to is None:
        i = 0
        while val >= 1024 and i < len(units) - 1:
            val /= 1024.
            i += 1
        return val, units[i]
    return val / 1024 ** units.index(unit_to), unit_to
