r"""The exchange file: host tensors of an iDMRG/DMRG state, free of JAX.

:class:`~tenpy_tpu_torch.algorithms.packed_dmrg.DeviceSweepEngine` starts
from the tensors that ``tenpy_tpu``'s engine packs after its host-side setup
(charge gauge, MPO charge rescale, environment initialisation):

* ``B[i]``: the site tensors in B form, legs ``(vL, p, vR)``;
* ``W[i]``: the MPO tensors, legs ``(wL, wR, p, p*)``;
* ``S[i]``: the Schmidt values on bond ``i`` (``n_bonds`` entries: ``L``
  for infinite, ``L + 1`` for finite bc);
* ``LP0``: the left environment of site 0, legs ``(vR*, wR, vR)``;
* ``RP[i]``: the right environment of site ``i``, legs ``(wL, vL, vL*)``.

Each block-sparse array is stored as its legs (slices, charges, qconj),
total charge, labels, charge-sector rows (``qdata``) and the concatenated
blocks; everything goes into one ``np.savez_compressed`` file that loads
without pickle.  Extra arrays (for example reference energies) ride along
under keys starting with ``ref.``.
"""

from __future__ import annotations

import numpy as np

from ..linalg.charges import ChargeInfo, LegCharge, QTYPE
from ..linalg.host_array import HostArray

__all__ = ['ExchangeState', 'flatten_array', 'unflatten_array',
           'state_to_flat', 'save_flat', 'load', 'load_flat']


def flatten_array(prefix, a):
    """Flat dict of numpy arrays describing block-sparse array ``a``.

    ``a`` needs ``legs``, ``qtotal``, ``get_leg_labels()``, ``_qdata`` and
    ``_data``: a :class:`HostArray`, or any array type with that layout."""
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
    """Inverse of :func:`flatten_array`: a :class:`HostArray`."""
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
    res = HostArray(legs, blocks_flat.dtype, flat[prefix + '.qtotal'], labels)
    qdata = flat[prefix + '.qdata'].reshape(-1, len(legs))
    blocks = []
    off = 0
    for row in qdata:
        shape = tuple(int(l.slices[s + 1] - l.slices[s])
                      for l, s in zip(legs, row))
        size = int(np.prod(shape, dtype=np.int64))
        blocks.append(blocks_flat[off:off + size].reshape(shape))
        off += size
    if off != blocks_flat.size:
        raise ValueError(f"{prefix}: block data size mismatch")
    res._set_blocks(qdata, blocks)
    return res


def state_to_flat(bc, chi, B, W, S, LP0, RP, chinfo, gauge=None, forms=None,
                  reference=None):
    """Flat dict of the exchange format (see module docstring).

    ``chinfo`` needs ``mod`` and ``names``; the arrays are flattened with
    :func:`flatten_array`.  ``gauge``: dict with ``k`` (charge-unit scale)
    and ``o`` (bond charge offsets), or None.  ``forms``: per-site canonical
    form of ``B`` (default all ``'B'``)."""
    L = len(B)
    flat = {
        'meta.bc': np.array(str(bc)),
        'meta.chi': np.asarray(chi, QTYPE),
        'meta.chinfo_mod': np.asarray(chinfo.mod, QTYPE),
        'meta.chinfo_names': np.array([str(n) for n in chinfo.names]),
        'meta.forms': np.array(list(forms) if forms is not None
                               else ['B'] * L),
    }
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
        self.chinfo = ChargeInfo(flat['meta.chinfo_mod'],
                                 [str(n) for n in flat['meta.chinfo_names']])
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
