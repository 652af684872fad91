r"""Abelian charge bookkeeping: :class:`ChargeInfo`, :class:`LegCharge`,
:class:`LegPipe`.

Port of ``tenpy_tpu/linalg/charges.py``, with
:class:`DipolarChargeInfo` (dipole conservation: charges that shift with
a site's position) and the charge mappings of legs (``from_add_charge``,
``from_drop_charge``, ``from_change_charge``, ``apply_charge_mapping``).
Every class is immutable and hashable: the packed tensordot and the split
cache their host-side plans on leg structures.  ``save_hdf5``/``from_hdf5``
write and read the reference library's HDF5 layout
(:mod:`~tenpy_tpu_torch.tools.io`).

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

__all__ = ['QTYPE', 'ChargeInfo', 'DipolarChargeInfo', 'LegCharge',
           'LegPipe']

QTYPE = np.int64


def _as_immutable(arr):
    a = np.ascontiguousarray(arr, dtype=QTYPE)
    a.setflags(write=False)
    return a


class ChargeInfo:
    """Number of charges and their modulo (``mod[k] == 1`` for U(1))."""

    __slots__ = ('mod', 'names', '_hash')

    # translations act trivially on these charges (no dipole conservation)
    trivial_shift = True

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

    @classmethod
    def trivial(cls):
        return cls(())

    @classmethod
    def add(cls, chinfos):
        """The charges of several ChargeInfos side by side."""
        mods, names = [], []
        for ci in chinfos:
            mods.extend(ci.mod)
            names.extend(ci.names)
        return cls(mods, names)

    @classmethod
    def drop(cls, chinfo, charge=None):
        """``chinfo`` without the charge ``charge`` (index or name; None:
        without every charge)."""
        if charge is None:
            return cls()
        if isinstance(charge, str):
            charge = chinfo.names.index(charge)
        mod, names = list(chinfo.mod), list(chinfo.names)
        del mod[charge], names[charge]
        return cls(mod, names)

    @classmethod
    def change(cls, chinfo, charge, new_qmod, new_name=''):
        """``chinfo`` with the modulus (and name) of one charge changed."""
        if isinstance(charge, str):
            charge = chinfo.names.index(charge)
        mod, names = list(chinfo.mod), list(chinfo.names)
        mod[charge] = int(new_qmod)
        names[charge] = new_name
        return cls(mod, names)

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

    def check_valid(self, charges):
        return np.array_equal(self.make_valid(charges),
                              np.asarray(charges, QTYPE))

    def shift_charges(self, charges, dx):
        """The charges after a translation by ``dx`` (unchanged here)."""
        return np.asarray(charges, QTYPE)

    def shift_charges_horizontal(self, charges, dx_0):
        """The charges after a translation by ``dx_0`` along axis 0
        (unchanged here)."""
        return np.asarray(charges, QTYPE)

    def __eq__(self, other):
        if self is other:
            return True
        if not isinstance(other, ChargeInfo):
            return NotImplemented
        return type(self) is type(other) and self.mod == other.mod

    def __ne__(self, other):
        res = self.__eq__(other)
        return res if res is NotImplemented else not res

    def __hash__(self):
        return self._hash

    def __repr__(self):
        return f"ChargeInfo({list(self.mod)}, {list(self.names)})"

    def save_hdf5(self, hdf5_saver, h5gr, subpath):
        """The reference layout: ``mod`` as dataset ``'U1_ZN'``,
        ``names``, attribute ``num_charges``."""
        h5gr.attrs['num_charges'] = self.qnumber
        hdf5_saver.save(np.array(self.mod, QTYPE), subpath + 'U1_ZN')
        hdf5_saver.save(list(self.names), subpath + 'names')

    @classmethod
    def from_hdf5(cls, hdf5_loader, h5gr, subpath):
        qmod = np.asarray(hdf5_loader.load(subpath + 'U1_ZN'), QTYPE)
        names = hdf5_loader.load(subpath + 'names') if 'names' in h5gr \
            else None
        obj = cls(tuple(int(m) for m in qmod), names)
        hdf5_loader.memorize_load(h5gr, obj)
        return obj


class DipolarChargeInfo(ChargeInfo):
    r"""A :class:`ChargeInfo` that conserves dipole moments.

    Each dipole charge ``p = r q`` is the moment of another charge ``q``,
    with ``r`` the integer lattice position along ``dipole_dims[n]``
    (origin at the lattice's first site).  A translation by ``dx`` adds
    ``dx[dim] * q`` to ``p``, so sites are charge-shifted by their position
    (``Lattice.mps_sites``) and :attr:`trivial_shift` is False.

    Parameters
    ----------
    mod, names : as for :class:`ChargeInfo`
    charge_idcs : list of int
        Per dipole charge: the index of its charge ``q``.
    dipole_idcs : list of int
        Per dipole charge: the index of the dipole charge ``p``.
    dipole_dims : list of int, optional
        Per dipole charge: the lattice axis of its moment (default 0).
    """

    __slots__ = ('charge_idcs', 'dipole_idcs', 'dipole_dims')

    trivial_shift = False

    def __init__(self, mod=(), names=None, charge_idcs=(), dipole_idcs=(),
                 dipole_dims=None):
        if dipole_dims is None:
            dipole_dims = [0] * len(dipole_idcs)
        mod = tuple(int(m) for m in mod)
        for n, i in enumerate(charge_idcs):
            if not 0 <= i < len(mod):
                raise ValueError(f"charge_idcs[{n}] out of bounds")
        for n, i in enumerate(dipole_idcs):
            if not 0 <= i < len(mod):
                raise ValueError(f"dipole_idcs[{n}] out of bounds")
            if i in charge_idcs:
                raise ValueError("dipole_idcs and charge_idcs must be "
                                 "disjoint")
        for n, i in enumerate(dipole_idcs):
            qmod_p, qmod_q = mod[i], mod[charge_idcs[n]]
            if dipole_dims[n] > 0 and qmod_p == 1:
                raise ValueError("a U(1) dipole charge along a periodic "
                                 "direction (dipole_dim > 0)")
            if qmod_q > 1 and (qmod_p == 1 or qmod_q % qmod_p != 0):
                raise ValueError(f"dipole qmod={qmod_p} is not a subgroup "
                                 f"of charge qmod={qmod_q}")
        self.charge_idcs = tuple(int(i) for i in charge_idcs)
        self.dipole_idcs = tuple(int(i) for i in dipole_idcs)
        self.dipole_dims = tuple(int(i) for i in dipole_dims)
        super().__init__(mod, names)
        self._hash = hash(('DipolarChargeInfo', self.mod, self.names,
                           self.charge_idcs, self.dipole_idcs,
                           self.dipole_dims))

    def shift_charges(self, charges, dx):
        """``p -> p + dx[dim] q`` for every dipole charge; ``dx`` is a
        lattice index with a last (unit-cell) entry of 0."""
        charges = np.array(charges, QTYPE)
        dx = np.asarray(dx)
        if dx[-1] != 0:
            raise NotImplementedError(
                "shifts between sublattice positions are not supported")
        for c, d, dim in zip(self.charge_idcs, self.dipole_idcs,
                             self.dipole_dims):
            charges[..., d] += int(dx[dim]) * charges[..., c]
        return self.make_valid(charges)

    def shift_charges_horizontal(self, charges, dx_0):
        charges = np.array(charges, QTYPE)
        for c, d, dim in zip(self.charge_idcs, self.dipole_idcs,
                             self.dipole_dims):
            if dim == 0:
                charges[..., d] += int(dx_0) * charges[..., c]
        return self.make_valid(charges)

    def __eq__(self, other):
        res = ChargeInfo.__eq__(self, other)
        if res is not True:
            return res
        return (self.charge_idcs == other.charge_idcs
                and self.dipole_idcs == other.dipole_idcs
                and self.dipole_dims == other.dipole_dims)

    def __hash__(self):
        return self._hash

    def __repr__(self):
        return (f"DipolarChargeInfo({list(self.mod)}, {list(self.names)}, "
                f"{list(self.charge_idcs)}, {list(self.dipole_idcs)}, "
                f"{list(self.dipole_dims)})")

    def save_hdf5(self, hdf5_saver, h5gr, subpath):
        """:class:`ChargeInfo`'s layout and the datasets ``charge_idcs``,
        ``dipole_idcs`` and ``dipole_dims``."""
        super().save_hdf5(hdf5_saver, h5gr, subpath)
        hdf5_saver.save(list(self.charge_idcs), subpath + 'charge_idcs')
        hdf5_saver.save(list(self.dipole_idcs), subpath + 'dipole_idcs')
        hdf5_saver.save(list(self.dipole_dims), subpath + 'dipole_dims')

    @classmethod
    def from_hdf5(cls, hdf5_loader, h5gr, subpath):
        qmod = np.asarray(hdf5_loader.load(subpath + 'U1_ZN'), QTYPE)
        names = hdf5_loader.load(subpath + 'names') if 'names' in h5gr \
            else None
        obj = cls(tuple(int(m) for m in qmod), names,
                  [int(i) for i in hdf5_loader.load(subpath + 'charge_idcs')],
                  [int(i) for i in hdf5_loader.load(subpath + 'dipole_idcs')],
                  [int(i) for i in hdf5_loader.load(subpath + 'dipole_dims')])
        hdf5_loader.memorize_load(h5gr, obj)
        return obj


class LegCharge:
    """Charge structure of one tensor leg: contiguous sectors with charges."""

    __slots__ = ('chinfo', 'slices', 'charges', 'qconj', 'sorted', 'bunched',
                 '_key', '_hash')

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
        self.sorted = bool(self._compute_sorted())
        self.bunched = bool(self._compute_bunched())
        # slices and charges are read-only: their bytes (one dtype, the
        # charges' width fixed by chinfo) decide equality
        self._key = (self.slices.tobytes(), self.charges.tobytes())
        self._hash = hash((self.chinfo, self._key, self.qconj))

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_trivial(cls, ind_len, chinfo=None, qconj=1):
        """Leg with a single sector of zero charge."""
        if chinfo is None:
            chinfo = ChargeInfo.trivial()
        return cls(chinfo, [0, ind_len], [chinfo.make_valid()], qconj)

    @classmethod
    def from_qflat(cls, chinfo, qflat, qconj=1):
        """From one charge vector per flat index (adjacent equal charges
        merged)."""
        qflat = np.asarray(qflat, dtype=QTYPE)
        if chinfo.qnumber == 0:
            qflat = qflat.reshape(len(qflat), 0)
        else:
            qflat = qflat.reshape(-1, chinfo.qnumber)
        if len(qflat) == 0:
            return cls(chinfo, [0], np.zeros((0, chinfo.qnumber), QTYPE),
                       qconj)
        diffs = _find_row_differences(qflat)
        return cls(chinfo, diffs, qflat[diffs[:-1]], qconj)

    @classmethod
    def from_qind(cls, chinfo, slices, charges, qconj=1):
        """From sector boundaries and one charge vector per sector."""
        return cls(chinfo, slices, charges, qconj)

    @classmethod
    def from_qdict(cls, chinfo, qdict, qconj=1):
        """From a ``{charge tuple: slice}`` mapping whose slices tile
        ``0:ind_len`` (the inverse of :meth:`to_qdict`)."""
        items = sorted(qdict.items(), key=lambda kv: kv[1].start)
        slices, charges = [0], []
        for q, sl in items:
            if sl.start != slices[-1]:
                raise ValueError("qdict slices not contiguous")
            slices.append(sl.stop)
            charges.append(q)
        return cls(chinfo, slices, charges, qconj)

    @classmethod
    def from_add_charge(cls, legs, chargeinfo=None):
        """The charges of several legs of one length side by side (sector
        boundaries: the union of theirs; neither sorted nor bunched)."""
        legs = list(legs)
        chinfo = ChargeInfo.add([l.chinfo for l in legs])
        if chargeinfo is not None:
            if chinfo != chargeinfo:
                raise ValueError("incompatible chargeinfo")
            chinfo = chargeinfo
        ind_len, qconj = legs[0].ind_len, legs[0].qconj
        if any(l.ind_len != ind_len for l in legs):
            raise ValueError("different leg lengths")
        if any(l.qconj != qconj for l in legs):
            raise ValueError("different qconj")
        bounds = np.unique(np.concatenate([np.asarray(l.slices)
                                           for l in legs]))
        rows = [np.concatenate([
            l.charges[int(np.searchsorted(l.slices, b, 'right')) - 1]
            for l in legs]) for b in bounds[:-1]]
        charges = np.array(rows, QTYPE).reshape(len(rows), chinfo.qnumber)
        return cls(chinfo, bounds, charges, qconj)

    @classmethod
    def from_drop_charge(cls, leg, charge=None, chargeinfo=None):
        """``leg`` without the charge ``charge`` (index or name; None:
        without every charge)."""
        if charge is None:
            return cls.from_trivial(leg.ind_len, chargeinfo, leg.qconj)
        chinfo = ChargeInfo.drop(leg.chinfo, charge)
        if chargeinfo is not None:
            if chinfo != chargeinfo:
                raise ValueError("incompatible chargeinfo")
            chinfo = chargeinfo
        if isinstance(charge, str):
            charge = leg.chinfo.names.index(charge)
        return cls(chinfo, leg.slices, np.delete(leg.charges, charge, axis=1),
                   leg.qconj)

    @classmethod
    def from_change_charge(cls, leg, charge, new_qmod, new_name='',
                           chargeinfo=None):
        """``leg`` with the modulus of one charge changed (its charges
        wrapped into the new range)."""
        chinfo = ChargeInfo.change(leg.chinfo, charge, new_qmod, new_name)
        if chargeinfo is not None:
            if chinfo != chargeinfo:
                raise ValueError("incompatible chargeinfo")
            chinfo = chargeinfo
        return cls(chinfo, leg.slices, chinfo.make_valid(leg.charges),
                   leg.qconj)

    # -------------------------------------------------------------- properties
    @property
    def ind_len(self):
        return int(self.slices[-1])

    @property
    def block_number(self):
        return len(self.charges)

    def sector_sizes(self):
        return self.slices[1:] - self.slices[:-1]

    def get_slice(self, qindex):
        return slice(int(self.slices[qindex]), int(self.slices[qindex + 1]))

    def get_charge(self, qindex):
        """The charge of sector ``qindex`` as it counts toward a total
        charge (times ``qconj``)."""
        return self.chinfo.make_valid(self.charges[qindex] * self.qconj)

    def get_qindex(self, flat_index):
        """``(qindex, index_within_sector)`` of a flat leg index."""
        if flat_index < 0:
            flat_index += self.ind_len
        if not 0 <= flat_index < self.ind_len:
            raise IndexError(flat_index)
        qi = int(np.searchsorted(self.slices, flat_index, side='right')) - 1
        return qi, flat_index - int(self.slices[qi])

    def to_qflat(self):
        out = np.empty((self.ind_len, self.chinfo.qnumber), QTYPE)
        for i in range(self.block_number):
            out[self.slices[i]:self.slices[i + 1]] = self.charges[i]
        return out

    def to_qdict(self):
        """``{charge tuple: slice}`` of every sector (the last sector of a
        repeated charge wins)."""
        return {tuple(int(x) for x in self.charges[i]):
                slice(int(self.slices[i]), int(self.slices[i + 1]))
                for i in range(self.block_number)}

    # --------------------------------------------------------- transformations
    def conj(self):
        """Flip ``qconj`` keeping ``charges``: the contractible partner."""
        return LegCharge(self.chinfo, self.slices, self.charges, -self.qconj)

    def apply_charge_mapping(self, func, func_kwargs=None):
        """The leg with ``charges = func(charges, **func_kwargs)`` (for
        example a position shift of dipole charges)."""
        charges = func(np.array(self.charges, QTYPE), **(func_kwargs or {}))
        return LegCharge(self.chinfo, self.slices, charges, self.qconj)

    def flip_charges_qconj(self):
        """Opposite ``qconj`` and negated charges: the same leg, counted the
        other way."""
        return LegCharge(self.chinfo, self.slices,
                         self.chinfo.make_valid(-self.charges), -self.qconj)

    def extend(self, extra_len, charge=None):
        """``extra_len`` more indices in a new last sector of charge
        ``charge`` (default 0)."""
        if charge is None:
            charge = self.chinfo.make_valid()
        slices = np.concatenate([self.slices, [self.ind_len + extra_len]])
        charges = np.concatenate(
            [self.charges, np.asarray(charge, QTYPE).reshape(1, -1)], axis=0)
        return LegCharge(self.chinfo, slices, charges, self.qconj)

    def sort(self, bunch=True):
        """``(perm_flat, sorted_leg)`` with sectors sorted lexicographically."""
        if self.block_number > 1 and self.chinfo.qnumber > 0:
            perm_qind = np.lexsort(self.charges.T)
        else:
            perm_qind = np.arange(self.block_number)
        new_sizes = self.sector_sizes()[perm_qind]
        new_slices = np.concatenate([[0], np.cumsum(new_sizes)])
        perm_flat = np.concatenate(
            [np.arange(self.slices[qi], self.slices[qi + 1])
             for qi in perm_qind]) if self.block_number > 0 \
            else np.zeros(0, np.intp)
        leg = LegCharge(self.chinfo, new_slices, self.charges[perm_qind],
                        self.qconj)
        if bunch:
            _, leg = leg.bunch()
        return perm_flat, leg

    def bunch(self):
        """Merge adjacent sectors with equal charge: ``(idx_kept, leg)``."""
        if self.block_number < 2:
            return np.arange(self.block_number + 1), self
        keep = _find_row_differences(self.charges)
        return keep, LegCharge(self.chinfo, self.slices[keep],
                               self.charges[keep[:-1]], self.qconj)

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

    def charge_sectors(self):
        """The distinct charges of the leg's sectors, sorted."""
        return np.unique(self.charges, axis=0)

    # ------------------------------------------------------------------ checks
    def _compute_sorted(self):
        if self.block_number < 2:
            return True
        c = self.charges
        return all(tuple(c[i][::-1]) <= tuple(c[i + 1][::-1])
                   for i in range(len(c) - 1))

    def _compute_bunched(self):
        if self.block_number < 2:
            return True
        return bool(np.all(np.any(self.charges[1:] != self.charges[:-1],
                                  axis=1)))

    def is_sorted(self):
        return self.sorted

    def is_bunched(self):
        return self.bunched

    def test_sanity(self):
        """Assert ascending slices from 0 and valid charges."""
        assert np.all(self.slices[1:] >= self.slices[:-1])
        assert self.slices[0] == 0
        assert self.chinfo.check_valid(self.charges)

    def test_contractible(self, other):
        """Raise unless ``self`` and ``other`` can be contracted."""
        if self.chinfo != other.chinfo:
            raise ValueError("different ChargeInfo")
        if self.ind_len != other.ind_len:
            raise ValueError(f"incompatible leg length {self.ind_len} vs "
                             f"{other.ind_len}")
        if self.qconj != -other.qconj:
            raise ValueError("same qconj on contracted legs")
        if self._key[0] != other._key[0]:
            raise ValueError("different sector boundaries")
        if self._key[1] != other._key[1]:
            raise ValueError("different charges")

    def test_equal(self, other):
        """Raise unless ``self`` and ``other`` describe the same structure
        (an opposite ``qconj`` with negated charges counts as equal)."""
        if self.chinfo != other.chinfo:
            raise ValueError("different ChargeInfo")
        if not np.array_equal(self.slices, other.slices):
            raise ValueError("unequal legs")
        charges = self.charges if self.qconj == other.qconj \
            else self.chinfo.make_valid(-self.charges)
        if not np.array_equal(charges, other.charges):
            raise ValueError("unequal legs")

    def __eq__(self, other):
        if self is other:
            return True
        if not isinstance(other, LegCharge):
            return NotImplemented
        return (self.qconj == other.qconj and self.chinfo == other.chinfo
                and self._key == other._key)

    def __ne__(self, other):
        res = self.__eq__(other)
        return res if res is NotImplemented else not res

    def __setstate__(self, state):
        # a pickle of any version: the saved slots, the key and the hash
        # (salted per process) made anew
        for name, value in state[1].items():
            object.__setattr__(self, name, value)
        self._key = (self.slices.tobytes(), self.charges.tobytes())
        self._hash = hash((self.chinfo, self._key, self.qconj))

    def __hash__(self):
        return self._hash

    def __repr__(self):
        return (f"LegCharge(qconj={self.qconj:+d}, len={self.ind_len}, "
                f"sectors={self.block_number})")

    def save_hdf5(self, hdf5_saver, h5gr, subpath):
        """The reference ``'blocks'`` layout: datasets ``slices`` and
        ``charges``, child ``chinfo``, attributes ``format``, ``ind_len``,
        ``qconj``, ``block_number``, ``sorted``, ``bunched``."""
        h5gr.attrs['format'] = 'blocks'
        h5gr.attrs['ind_len'] = self.ind_len
        h5gr.attrs['qconj'] = self.qconj
        h5gr.attrs['block_number'] = self.block_number
        h5gr.attrs['sorted'] = bool(self.sorted)
        h5gr.attrs['bunched'] = bool(self.bunched)
        hdf5_saver.save(self.chinfo, subpath + 'chinfo')
        hdf5_saver.save(np.asarray(self.slices), subpath + 'slices')
        hdf5_saver.save(np.asarray(self.charges), subpath + 'charges')

    @classmethod
    def from_hdf5(cls, hdf5_loader, h5gr, subpath):
        """Reads the ``'blocks'``, ``'compact'`` and ``'flat'`` layouts."""
        fmt = hdf5_loader.get_attr(h5gr, 'format')
        qconj = int(hdf5_loader.get_attr(h5gr, 'qconj'))
        chinfo = hdf5_loader.load(subpath + 'chinfo')
        if fmt == 'blocks':
            obj = cls(chinfo, hdf5_loader.load(subpath + 'slices'),
                      hdf5_loader.load(subpath + 'charges'), qconj)
        elif fmt == 'compact':
            bc = np.asarray(hdf5_loader.load(subpath + 'blockcharges'))
            obj = cls(chinfo, np.concatenate([bc[:, 0], bc[-1:, 1]]),
                      np.asarray(bc[:, 2:], QTYPE), qconj)
        elif fmt == 'flat':
            obj = cls.from_qflat(chinfo, np.asarray(
                hdf5_loader.load(subpath + 'charges')), qconj)
        else:
            raise ValueError(f"unknown LegCharge hdf5 format {fmt!r}")
        hdf5_loader.memorize_load(h5gr, obj)
        return obj


class LegPipe(LegCharge):
    """A :class:`LegCharge` made by fusing several legs into one.

    The fused leg enumerates combinations of the constituent sectors, sorted
    and bunched by fused charge; ``q_map`` keeps where each combination went,
    so :meth:`~tenpy_tpu_torch.linalg.np_conserved.Array.split_legs` undoes
    the fusion exactly.

    Attributes
    ----------
    legs : tuple of LegCharge
    q_map : np.ndarray (n_comb, 3 + nlegs)
        Rows ``[start, stop, fused_qindex, s_0, ..., s_{n-1}]``: the
        combination of constituent sectors ``(s_0, ...)`` occupies
        ``start:stop`` within fused sector ``fused_qindex``.
    q_map_slices : np.ndarray
        Row range of ``q_map`` belonging to each fused sector.
    """

    __slots__ = ('legs', 'subshape', 'subqshape', 'q_map', 'q_map_slices',
                 '_map_dict')

    def __init__(self, legs, qconj=1):
        legs = tuple(legs)
        if len(legs) == 0:
            raise ValueError("need at least one leg")
        chinfo = legs[0].chinfo
        if any(l.chinfo != chinfo for l in legs[1:]):
            raise ValueError("different ChargeInfo")
        self.legs = legs
        self.subshape = tuple(l.ind_len for l in legs)
        self.subqshape = tuple(l.block_number for l in legs)
        qconj = int(qconj)
        nlegs = len(legs)
        qnumber = chinfo.qnumber
        # every sector combination, C order (last leg fastest)
        grids = np.meshgrid(*[np.arange(n) for n in self.subqshape],
                            indexing='ij')
        combs = np.stack([g.ravel() for g in grids], axis=1)
        n_comb = combs.shape[0]
        sizes = np.ones(n_comb, dtype=QTYPE)
        fused_q = np.zeros((n_comb, qnumber), QTYPE)
        for k, l in enumerate(legs):
            sizes *= l.sector_sizes()[combs[:, k]]
            fused_q += l.charges[combs[:, k]] * l.qconj
        fused_q = chinfo.make_valid(fused_q * qconj)
        # stable sort by fused charge keeps C order within a charge
        order = np.lexsort(fused_q.T) if (n_comb > 1 and qnumber > 0) \
            else np.arange(n_comb)
        fused_q_s = fused_q[order]
        sizes_s = sizes[order]
        combs_s = combs[order]
        diffs = _find_row_differences(fused_q_s) if n_comb > 0 \
            else np.array([0])
        n_sector = len(diffs) - 1
        charges = fused_q_s[diffs[:-1]]
        sector_sizes = np.add.reduceat(sizes_s, diffs[:-1]) if n_sector \
            else np.zeros(0, QTYPE)
        slices = np.concatenate([[0], np.cumsum(sector_sizes)]).astype(QTYPE)
        q_map = np.empty((n_comb, 3 + nlegs), QTYPE)
        within = np.zeros(n_comb, QTYPE)
        for s in range(n_sector):
            lo, hi = diffs[s], diffs[s + 1]
            within[lo:hi] = np.concatenate([[0],
                                            np.cumsum(sizes_s[lo:hi])])[:-1]
            q_map[lo:hi, 2] = s
        q_map[:, 0] = within
        q_map[:, 1] = within + sizes_s
        q_map[:, 3:] = combs_s
        self.q_map = _as_immutable(q_map)
        self.q_map_slices = diffs
        self._map_dict = {tuple(int(x) for x in q_map[r, 3:]): r
                          for r in range(n_comb)}
        LegCharge.__init__(self, chinfo, slices, charges, qconj)

    @property
    def nlegs(self):
        return len(self.legs)

    def save_hdf5(self, hdf5_saver, h5gr, subpath):
        """The :class:`LegCharge` layout and the constituent ``legs``."""
        LegCharge.save_hdf5(self, hdf5_saver, h5gr, subpath)
        hdf5_saver.save(list(self.legs), subpath + 'legs')

    @classmethod
    def from_hdf5(cls, hdf5_loader, h5gr, subpath):
        qconj = int(hdf5_loader.get_attr(h5gr, 'qconj'))
        obj = cls(hdf5_loader.load(subpath + 'legs'), qconj)
        hdf5_loader.memorize_load(h5gr, obj)
        return obj

    def conj(self):
        """Flip qconj of the pipe and of every constituent leg."""
        return LegPipe([l.conj() for l in self.legs], qconj=-self.qconj)

    def outer_conj(self):
        """Flip the pipe's qconj only, keeping the constituent legs."""
        return LegPipe(self.legs, qconj=-self.qconj)

    def map_comb(self, comb):
        """``(offset_start, offset_stop, fused_qindex)`` of a sector
        combination."""
        row = self.q_map[self._map_dict[tuple(int(c) for c in comb)]]
        return int(row[0]), int(row[1]), int(row[2])

    def map_incoming_flat(self, incoming):
        """The flat index on the pipe of flat indices ``incoming`` on the
        constituent legs (C order within a sector combination)."""
        qis, pos = [], 0
        for l, i in zip(self.legs, incoming):
            qi, rem = l.get_qindex(i)
            qis.append(qi)
            pos = pos * int(l.sector_sizes()[qi]) + rem
        start, _, fqi = self.map_comb(qis)
        return int(self.slices[fqi]) + start + pos

    def to_LegCharge(self):
        """The pipe as a plain :class:`LegCharge` (same sectors)."""
        return LegCharge(self.chinfo, self.slices, self.charges, self.qconj)

    def __repr__(self):
        return (f"LegPipe(nlegs={self.nlegs}, qconj={self.qconj:+d}, "
                f"len={self.ind_len}, sectors={self.block_number})")


def _find_row_differences(arr):
    """Indices ``i`` where row ``arr[i]`` differs from ``arr[i-1]``, framed
    by 0 and ``len(arr)``."""
    if len(arr) == 0:
        return np.array([0], QTYPE)
    if arr.ndim == 1:
        arr = arr[:, None]
    diff = np.any(arr[1:] != arr[:-1], axis=1)
    return np.concatenate([[0], np.nonzero(diff)[0] + 1,
                           [len(arr)]]).astype(QTYPE)
