r"""The exchange file: host tensors of an iDMRG/DMRG state, free of JAX.

An exchange file carries a state (its B tensors, Schmidt values and
canonical forms), which :func:`load_mps` reads into the port's
:class:`~tenpy_tpu_torch.networks.mps.MPS`.  Files written by
``tests/torch_exchange.py`` also hold what ``tenpy_tpu``'s engine packs
after its host-side setup (charge gauge, MPO charge rescale, environment
initialisation), as values to hold the port's own setup against:

* ``B[i]``: the site tensors in B form, legs ``(vL, p, vR)``;
* ``W[i]``: the MPO tensors, legs ``(wL, wR, p, p*)``;
* ``S[i]``: the Schmidt values on bond ``i`` (``n_bonds`` entries: ``L``
  for infinite, ``L + 1`` for finite bc);
* ``LP0``: the left environment of site 0, legs ``(vR*, wR, vR)``;
* ``RP[i]``: the right environment of site ``i``, legs ``(wL, vL, vL*)``.

A uniform MPS (VUMPS's AL, AR, AC and C per site, and its singular values
where it stores them) goes under a prefix of its own
(:func:`uniform_to_flat`, :func:`load_uniform`).

Each block-sparse array is stored as its legs (slices, charges, qconj),
total charge, labels, charge-sector rows (``qdata``) and the concatenated
blocks; everything goes into one ``np.savez_compressed`` file that loads
without pickle.  The charge info is stored once, under ``meta.chinfo_*``:
its kind (``ChargeInfo`` or ``DipolarChargeInfo``), moduli, names and,
for dipole conservation, the indices of the charges and their moments and
the moments' axes (:func:`chinfo_to_flat`).  :func:`load_mps` raises
where they, or the physical legs, differ from the sites it is given.
Extra arrays (for example reference energies) ride along under keys
starting with ``ref.``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..linalg.charges import (ChargeInfo, DipolarChargeInfo, LegCharge,
                               QTYPE)
from ..linalg.np_conserved import Array
from .charge_gauge import apply_bond_charge_shift, scale_psi_charges
from .mps import MPS

__all__ = ['ExchangeState', 'flatten_array', 'unflatten_array',
           'chinfo_to_flat', 'chinfo_from_flat',
           'state_to_flat', 'save_flat', 'load', 'load_flat', 'load_mps',
           'uniform_to_flat', 'load_uniform']


def flatten_array(prefix, a):
    """Flat dict of numpy arrays describing block-sparse array ``a``.

    ``a`` needs ``legs``, ``qtotal``, ``get_leg_labels()``, ``_qdata`` and
    ``_data``: the port's :class:`~tenpy_tpu_torch.linalg.np_conserved.Array`,
    or any array type with that layout (``tenpy_tpu``'s Array too)."""
    legs = a.legs
    blocks = [np.asarray(b) for b in a._data]
    dtype = np.result_type(*blocks) if blocks else np.dtype(np.float64)
    return {
        prefix + '.slices': np.concatenate(
            [np.asarray(l.slices, QTYPE) for l in legs]),
        prefix + '.n_slices': np.array([len(l.slices) for l in legs], QTYPE),
        prefix + '.charges': np.concatenate(
            [np.asarray(l.charges, QTYPE).reshape(-1) for l in legs]),
        prefix + '.qconj': np.array([l.qconj for l in legs], QTYPE),
        prefix + '.qtotal': np.asarray(a.qtotal, QTYPE).reshape(-1),
        prefix + '.labels': np.array([str(l) for l in a.get_leg_labels()]),
        prefix + '.qdata': np.asarray(a._qdata, QTYPE).reshape(-1, len(legs)),
        prefix + '.blocks': np.concatenate(
            [b.reshape(-1) for b in blocks] + [np.zeros(0, dtype)]),
    }


def unflatten_array(prefix, flat, chinfo):
    """Inverse of :func:`flatten_array`: an
    :class:`~tenpy_tpu_torch.linalg.np_conserved.Array` (CPU blocks)."""
    n_slices = flat[prefix + '.n_slices']
    slices_all = flat[prefix + '.slices']
    charges_all = flat[prefix + '.charges']
    qconj = flat[prefix + '.qconj']
    legs = []
    s0 = c0 = 0
    for ns, qc in zip(n_slices, qconj):
        ns = int(ns)
        nc = (ns - 1) * chinfo.qnumber
        legs.append(LegCharge(chinfo, slices_all[s0:s0 + ns],
                              charges_all[c0:c0 + nc], int(qc)))
        s0 += ns
        c0 += nc
    blocks_flat = flat[prefix + '.blocks']
    labels = [str(l) for l in flat[prefix + '.labels']]
    res = Array(legs, blocks_flat.dtype, flat[prefix + '.qtotal'], labels)
    qdata = flat[prefix + '.qdata'].reshape(-1, len(legs))
    blocks = []
    off = 0
    for row in qdata:
        shape = tuple(int(l.slices[s + 1] - l.slices[s])
                      for l, s in zip(legs, row))
        size = int(np.prod(shape, dtype=np.int64))
        blocks.append(torch.from_numpy(
            np.array(blocks_flat[off:off + size]).reshape(shape)))
        off += size
    if off != blocks_flat.size:
        raise ValueError(f"{prefix}: block data size mismatch")
    res._set_blocks(qdata, blocks)
    return res


def chinfo_to_flat(chinfo, prefix='meta.chinfo_'):
    """The flat form of a charge info (the port's or ``tenpy_tpu``'s):
    ``kind``, ``mod``, ``names`` and, for dipole conservation,
    ``charge_idcs``, ``dipole_idcs``, ``dipole_dims``."""
    dipolar = hasattr(chinfo, 'dipole_idcs')
    flat = {prefix + 'kind': np.array('DipolarChargeInfo' if dipolar
                                      else 'ChargeInfo'),
            prefix + 'mod': np.asarray(chinfo.mod, QTYPE),
            prefix + 'names': np.array([str(n) for n in chinfo.names])}
    if dipolar:
        for key in ('charge_idcs', 'dipole_idcs', 'dipole_dims'):
            flat[prefix + key] = np.asarray(getattr(chinfo, key), QTYPE)
    return flat


def chinfo_from_flat(flat, prefix='meta.chinfo_'):
    """The port's charge info of :func:`chinfo_to_flat` (a flat form
    without ``kind`` is a
    :class:`~tenpy_tpu_torch.linalg.charges.ChargeInfo`)."""
    kind = str(flat.get(prefix + 'kind', 'ChargeInfo'))
    mod = [int(m) for m in flat[prefix + 'mod']]
    names = [str(n) for n in flat[prefix + 'names']]
    if kind == 'ChargeInfo':
        return ChargeInfo(mod, names)
    if kind == 'DipolarChargeInfo':
        return DipolarChargeInfo(
            mod, names, *[[int(i) for i in flat[prefix + key]] for key in
                          ('charge_idcs', 'dipole_idcs', 'dipole_dims')])
    raise ValueError(f"unknown charge info kind {kind!r}")


def state_to_flat(bc, chi, B, W, S, LP0, RP, chinfo, gauge=None, forms=None,
                  reference=None):
    """Flat dict of the exchange format (see module docstring).

    ``chinfo`` is stored by :func:`chinfo_to_flat`; the arrays are
    flattened with :func:`flatten_array`.  ``gauge``: dict with ``k``
    (charge-unit scale) and ``o`` (bond charge offsets), or None.
    ``forms``: per-site canonical form of ``B`` (default all ``'B'``)."""
    L = len(B)
    flat = {
        'meta.bc': np.array(str(bc)),
        'meta.chi': np.asarray(chi, QTYPE),
        'meta.forms': np.array(list(forms) if forms is not None
                               else ['B'] * L),
    }
    flat.update(chinfo_to_flat(chinfo))
    for i in range(L):
        flat.update(flatten_array(f'B.{i}', B[i]))
    for i, Wi in enumerate(W or []):
        flat.update(flatten_array(f'W.{i}', Wi))
    for i, Si in enumerate(S):
        flat[f'S.{i}'] = np.asarray(Si, np.float64)
    if LP0 is not None:
        flat.update(flatten_array('LP0', LP0))
    for i, Ri in enumerate(RP or []):
        flat.update(flatten_array(f'RP.{i}', Ri))
    if gauge is not None:
        flat['gauge.k'] = np.asarray(gauge['k'], QTYPE)
        flat['gauge.o'] = np.asarray(gauge['o'], QTYPE).reshape(
            L, len(chinfo.mod))
    for key, val in (reference or {}).items():
        flat['ref.' + key] = np.asarray(val)
    return flat


class ExchangeState:
    """Host tensors of a state, loaded from the exchange format.

    Attributes: ``bc``, ``L``, ``chi``, ``chinfo``, ``B``, ``W``, ``S``,
    ``LP0``, ``RP``, ``forms``, ``gauge`` (dict or None), ``reference``
    (dict of the ``ref.`` arrays, prefix stripped)."""

    def __init__(self, flat):
        self.bc = str(flat['meta.bc'])
        self.chi = [int(c) for c in flat['meta.chi']]
        self.chinfo = chinfo_from_flat(flat)
        self.forms = [str(f) for f in flat['meta.forms']]
        self.L = len(self.forms)
        ch = self.chinfo
        self.B = [unflatten_array(f'B.{i}', flat, ch) for i in range(self.L)]
        self.W = [unflatten_array(f'W.{i}', flat, ch) for i in range(self.L)
                  if f'W.{i}.qdata' in flat]
        self.S = [np.asarray(flat[f'S.{i}'])
                  for i in range(self.L + 1) if f'S.{i}' in flat]
        self.LP0 = unflatten_array('LP0', flat, ch) \
            if 'LP0.qdata' in flat else None
        self.RP = [unflatten_array(f'RP.{i}', flat, ch) for i in range(self.L)
                   if f'RP.{i}.qdata' in flat]
        self.gauge = ({'k': np.asarray(flat['gauge.k']),
                       'o': list(np.asarray(flat['gauge.o']))}
                      if 'gauge.k' in flat else None)
        self.reference = {k[4:]: np.asarray(v) for k, v in flat.items()
                          if k.startswith('ref.')}

    @property
    def finite(self):
        return self.bc == 'finite'


def save_flat(path, flat):
    """Write a flat exchange dict with ``np.savez_compressed``."""
    np.savez_compressed(path, **flat)


def load_flat(path):
    """Read a flat exchange dict (no pickle)."""
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def load(path):
    """Read an exchange file into an :class:`ExchangeState`."""
    return ExchangeState(load_flat(path))


def load_mps(path_or_flat, sites):
    """The state of an exchange file as an :class:`~tenpy_tpu_torch.networks.
    mps.MPS` on ``sites`` (for example ``model.lat.mps_sites()``).

    The file's tensors are in the uniform charge gauge of the engine that
    wrote them (bond charge shifts, and for a unit-cell charge not
    divisible by ``L`` charge units rescaled by ``k``); its stored gauge is
    inverted here, so the MPS carries the charges of the sites' own
    frame.  The file's charge info must equal the sites' (kind, moduli
    and dipole indices), and each physical leg the site's leg (for dipole
    conservation: the site's position); else ValueError."""
    flat = path_or_flat if isinstance(path_or_flat, dict) \
        else load_flat(path_or_flat)
    st = ExchangeState(flat)
    if len(sites) != st.L:
        raise ValueError(f"{len(sites)} sites for a state of length {st.L}")
    if st.chinfo != sites[0].leg.chinfo:
        raise ValueError(f"the state's charges {st.chinfo!r} differ from "
                         f"the sites' {sites[0].leg.chinfo!r}")
    S = list(st.S)
    if not st.finite:
        S.append(S[0])
    psi = MPS(sites, st.B, S, bc=st.bc, form=st.forms)
    if st.gauge is not None:
        if any(np.any(o != 0) for o in st.gauge['o']):
            apply_bond_charge_shift(psi, [-np.asarray(o) for o in
                                          st.gauge['o']])
        scale_psi_charges(psi, st.gauge['k'], div=True, sites=False)
    for i, (B, site) in enumerate(zip(psi._B, sites)):
        leg = B.get_leg('p')
        if not (np.array_equal(leg.slices, site.leg.slices)
                and np.array_equal(leg.charges, site.leg.charges)
                and leg.qconj == site.leg.qconj):
            raise ValueError(f"site {i}: the state's physical leg differs "
                             f"from the site's")
    return psi


def uniform_to_flat(prefix, u):
    """A uniform MPS (the port's or any with ``get_AL``, ``get_AR``,
    ``get_AC``, ``get_C``, ``_S`` and ``diagonal_gauge``) as flat arrays
    under ``prefix``."""
    flat = {f'{prefix}.L': np.asarray(u.L),
            f'{prefix}.diagonal_gauge': np.asarray(bool(u.diagonal_gauge))}
    for i in range(u.L):
        for name, get in (('AL', u.get_AL), ('AR', u.get_AR),
                          ('AC', u.get_AC), ('C', u.get_C)):
            flat.update(flatten_array(f'{prefix}.{name}.{i}', get(i)))
        if u._S[i] is not None:
            flat[f'{prefix}.S.{i}'] = np.asarray(u._S[i], np.float64)
    return flat


def load_uniform(flat, prefix, sites):
    """The uniform MPS :func:`uniform_to_flat` stored under ``prefix``, as
    the port's :class:`~tenpy_tpu_torch.networks.uniform_mps.UniformMPS`
    on ``sites``."""
    from .uniform_mps import UniformMPS
    chinfo = sites[0].leg.chinfo
    L = int(flat[f'{prefix}.L'])
    arrays = {name: [unflatten_array(f'{prefix}.{name}.{i}', flat, chinfo)
                     for i in range(L)]
              for name in ('AL', 'AR', 'AC', 'C')}
    u = UniformMPS(sites, arrays['AL'], arrays['AR'], arrays['AC'],
                   arrays['C'])
    for i in range(L):
        if f'{prefix}.S.{i}' in flat:
            u._S[i] = np.asarray(flat[f'{prefix}.S.{i}'])
    u._S[L] = u._S[0]
    u.diagonal_gauge = bool(flat[f'{prefix}.diagonal_gauge'])
    return u
