"""Small helpers for models, lattices and eigensolvers.

Port of ``to_array``, ``argsort``, ``inverse_permutation`` and
``find_subclass`` from ``tenpy_tpu/tools/misc.py``: the helpers that the
sites, lattices, models and the eigensolvers import.
"""

from __future__ import annotations

import numpy as np

__all__ = ['to_array', 'argsort', 'inverse_permutation', 'find_subclass']


def to_array(a, shape=(None,), dtype=None):
    """An ndarray of ``shape``: scalars broadcast, other arrays must have
    ``len(shape)`` axes and are tiled periodically along each."""
    a = np.array(a, dtype=dtype)
    if a.ndim != len(shape):
        if a.size != 1:
            raise ValueError("cannot cast to required number of dimensions")
        a = np.reshape(a, [1] * len(shape))
    reps = [1] * a.ndim
    for i, want in enumerate(shape):
        if want is None:
            continue
        q, r = divmod(want, a.shape[i])
        if r != 0:
            raise ValueError(f"incommensurate tiling {a.shape[i]} -> {want}")
        reps[i] = q
    return np.tile(a, reps)


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


def find_subclass(base_class, subclass_name):
    """The loaded subclass of ``base_class`` named ``subclass_name`` (a
    subclass itself passes through)."""
    if not isinstance(subclass_name, str):
        if isinstance(subclass_name, type) and \
                issubclass(subclass_name, base_class):
            return subclass_name
        raise TypeError(f"expect str or subclass of {base_class}, got "
                        f"{subclass_name!r}")
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
