r"""Size-bucketed zero padding of charge legs.

Port of ``tenpy_tpu/linalg/padding.py`` (``bucket_size``, ``pad_leg``,
``embed_leg_map``, ``embed_array``).  Rounding every sector size up to a few
bucket sizes gives the packed layout few distinct block shapes, so one bucket
GEMM covers many charge blocks; zero padding keeps every contraction exact.
"""

from __future__ import annotations

import numpy as np

from .charges import LegCharge, QTYPE
from .host_array import HostArray

__all__ = ['bucket_size', 'pad_leg', 'embed_leg_map', 'embed_array']


def bucket_size(n, multiple=64):
    """Round a sector size up: powers of two up to ``multiple``, then
    multiples of ``multiple``."""
    if n <= 0:
        return n
    p = 8
    while p < multiple:
        if n <= p:
            return p
        p *= 2
    return ((n + multiple - 1) // multiple) * multiple


def pad_leg(leg, multiple=64):
    """LegCharge with every sector size rounded up by :func:`bucket_size`.

    Returns ``(padded_leg, orig_sizes)``; charges and qconj are unchanged."""
    sizes = np.diff(leg.slices)
    new_sizes = np.array([bucket_size(int(s), multiple) for s in sizes])
    slices = np.concatenate([[0], np.cumsum(new_sizes)])
    return LegCharge(leg.chinfo, slices, leg.charges, leg.qconj), \
        np.asarray(sizes)


def embed_leg_map(leg, big_leg):
    """Sector-index map from ``leg`` into the charge-superset ``big_leg``.

    Returns ``m`` with ``big_leg.charges[m[s]] == leg.charges[s]``; raises if
    a sector is missing or too small."""
    pos = {tuple(np.asarray(big_leg.charges[b], QTYPE)): b
           for b in range(big_leg.block_number)}
    m = np.zeros(leg.block_number, np.intp)
    for s in range(leg.block_number):
        b = pos.get(tuple(np.asarray(leg.charges[s], QTYPE)))
        if b is None:
            raise ValueError("embed_leg_map: sector missing in big_leg")
        if (big_leg.slices[b + 1] - big_leg.slices[b]
                < leg.slices[s + 1] - leg.slices[s]):
            raise ValueError("embed_leg_map: target sector too small")
        m[s] = b
    return m


def embed_array(a, big_legs):
    """Zero-pad a :class:`HostArray`'s blocks onto charge-superset legs.

    ``big_legs``: dict label/axis -> LegCharge with the same qconj; the
    target legs may hold additional sectors, indices are re-mapped by
    charge."""
    axes = {}
    for key, leg in big_legs.items():
        ax = a.get_leg_index(key)
        if leg.qconj != a.legs[ax].qconj:
            raise ValueError("embed_array: qconj mismatch")
        axes[ax] = (leg, embed_leg_map(a.legs[ax], leg))
    new_legs = [axes[i][0] if i in axes else a.legs[i] for i in range(a.rank)]
    res = HostArray(new_legs, a.dtype, a.qtotal, a.get_leg_labels())
    qdata = np.array(a._qdata, QTYPE).reshape(-1, a.rank)
    for row in qdata:
        for ax, (_, m) in axes.items():
            row[ax] = m[row[ax]]
    new_data = []
    for row, block in zip(qdata, a._data):
        shape = tuple(
            int(new_legs[i].slices[row[i] + 1] - new_legs[i].slices[row[i]])
            for i in range(a.rank))
        if shape == block.shape:
            new_data.append(block)
            continue
        padded = np.zeros(shape, dtype=block.dtype)
        padded[tuple(slice(0, s) for s in block.shape)] = block
        new_data.append(padded)
    res._set_blocks(qdata, new_data)
    return res
