r"""Abelian charge bookkeeping: :class:`ChargeInfo` and :class:`LegCharge`.

Port of the part of ``tenpy_tpu/linalg/charges.py`` that the packed layout
uses.  Both classes are immutable and hashable: the packed tensordot and the
split cache their host-side plans on leg structures.

Conventions (as in ``tenpy_tpu``):

* A charge vector has ``qnumber`` integer entries; entry ``k`` is defined
  modulo ``mod[k]``, where ``mod[k] == 1`` is a U(1) charge.
* A :class:`LegCharge` partitions ``[0, ind_len)`` into contiguous sectors
  ``slices[i]:slices[i+1]`` with charge vector ``charges[i]``.
* ``qconj`` is +1 for an incoming leg and -1 otherwise; every stored block
  satisfies ``sum_legs qconj * charges[sector] == qtotal (mod)``.
"""

from __future__ import annotations

import numpy as np

__all__ = ['QTYPE', 'ChargeInfo', 'LegCharge']

QTYPE = np.int64


def _as_immutable(arr):
    a = np.ascontiguousarray(arr, dtype=QTYPE)
    a.setflags(write=False)
    return a


class ChargeInfo:
    """Number of charges and their modulo (``mod[k] == 1`` for U(1))."""

    __slots__ = ('mod', 'names', '_hash')

    def __init__(self, mod=(), names=None):
        mod = tuple(int(m) for m in mod)
        if any(m < 1 for m in mod):
            raise ValueError("mod entries must be >= 1")
        if names is None:
            names = ('',) * len(mod)
        names = tuple(str(n) for n in names)
        if len(names) != len(mod):
            raise ValueError("names / mod length mismatch")
        self.mod = mod
        self.names = names
        self._hash = hash(('ChargeInfo', mod, names))

    @property
    def qnumber(self):
        return len(self.mod)

    def make_valid(self, charges=None):
        """Map charge values into the canonical range (mod N for Z_N charges)."""
        if charges is None:
            return np.zeros((self.qnumber,), QTYPE)
        charges = np.asarray(charges, dtype=QTYPE)
        if charges.shape[-1] != self.qnumber:
            raise ValueError(f"charges last dim {charges.shape} != qnumber "
                             f"{self.qnumber}")
        if self.qnumber == 0:
            return charges
        mod = np.array(self.mod, dtype=QTYPE)
        return np.where(mod == 1, charges, np.mod(charges, mod))

    def __eq__(self, other):
        if self is other:
            return True
        if not isinstance(other, ChargeInfo):
            return NotImplemented
        return self.mod == other.mod

    def __hash__(self):
        return self._hash

    def __repr__(self):
        return f"ChargeInfo({list(self.mod)}, {list(self.names)})"


class LegCharge:
    """Charge structure of one tensor leg: contiguous sectors with charges."""

    __slots__ = ('chinfo', 'slices', 'charges', 'qconj', '_hash')

    def __init__(self, chinfo, slices, charges, qconj=1):
        self.chinfo = chinfo
        self.slices = _as_immutable(slices)
        n_sec = len(self.slices) - 1
        self.charges = _as_immutable(
            np.asarray(charges, dtype=QTYPE).reshape(n_sec, chinfo.qnumber))
        self.qconj = int(qconj)
        if self.qconj not in (1, -1):
            raise ValueError("qconj must be +-1")
        if self.slices.ndim != 1:
            raise ValueError("slices must be 1-D")
        self._hash = hash((self.chinfo, self.slices.tobytes(),
                           self.charges.tobytes(), self.qconj))

    @property
    def ind_len(self):
        return int(self.slices[-1])

    @property
    def block_number(self):
        return len(self.charges)

    def conj(self):
        """Flip ``qconj`` keeping ``charges``: the contractible partner."""
        return LegCharge(self.chinfo, self.slices, self.charges, -self.qconj)

    def project(self, mask):
        """Keep only indices where boolean ``mask`` is True.

        Returns ``(map_qind, block_masks, projected_leg)``: ``map_qind[old]``
        is the new sector index (-1 if the sector vanished) and
        ``block_masks[old]`` the mask within the old sector.
        """
        mask = np.asarray(mask, dtype=bool)
        if len(mask) != self.ind_len:
            raise ValueError("mask length mismatch")
        block_masks = [mask[self.slices[i]:self.slices[i + 1]]
                       for i in range(self.block_number)]
        new_sizes = np.array([int(m.sum()) for m in block_masks], dtype=QTYPE)
        keep = new_sizes > 0
        map_qind = np.full(self.block_number, -1, dtype=QTYPE)
        map_qind[keep] = np.arange(int(keep.sum()))
        slices = np.concatenate([[0], np.cumsum(new_sizes[keep])])
        leg = LegCharge(self.chinfo, slices, self.charges[keep], self.qconj)
        return map_qind, block_masks, leg

    def test_contractible(self, other):
        """Raise unless ``self`` and ``other`` can be contracted."""
        if self.chinfo != other.chinfo:
            raise ValueError("different ChargeInfo")
        if self.ind_len != other.ind_len:
            raise ValueError(f"incompatible leg length {self.ind_len} vs "
                             f"{other.ind_len}")
        if self.qconj != -other.qconj:
            raise ValueError("same qconj on contracted legs")
        if not np.array_equal(self.slices, other.slices):
            raise ValueError("different sector boundaries")
        if not np.array_equal(self.charges, other.charges):
            raise ValueError("different charges")

    def __eq__(self, other):
        if self is other:
            return True
        if not isinstance(other, LegCharge):
            return NotImplemented
        return (self.qconj == other.qconj and self.chinfo == other.chinfo
                and self.slices.shape == other.slices.shape
                and np.array_equal(self.slices, other.slices)
                and np.array_equal(self.charges, other.charges))

    def __hash__(self):
        return self._hash

    def __repr__(self):
        return (f"LegCharge(qconj={self.qconj:+d}, len={self.ind_len}, "
                f"sectors={self.block_number})")
