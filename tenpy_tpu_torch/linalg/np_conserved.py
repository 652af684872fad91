r"""Charge-conserving block-sparse host tensors: :class:`Array` and friends.

Port of the part of ``tenpy_tpu/linalg/np_conserved.py`` that the host side
of the sweep engine runs: site operators, MPO construction, MPS tensors,
environments and their initialisation, the write-back's canonical form
and measurements (``svd``, ``qr``/``lq``, ``eigh``), the plane-wave
excitations' complement of an isometry (``orthogonal_columns``), and the
host DMRG engines (``concatenate`` for the subspace expansion, ``eigh``
with a sort order for the density-matrix mixer, ``gauge_total_charge``,
combining legs into given pipes).  An :class:`Array` holds its charge
structure (legs, ``qtotal``, labels, the block rows ``_qdata``) in numpy
and one CPU ``torch`` tensor per stored charge block in ``_data``.
It is also what :func:`~tenpy_tpu_torch.linalg.packed.pack` takes and
:func:`~tenpy_tpu_torch.linalg.packed.unpack` returns.

Every block product of :func:`tensordot` is one ``torch.matmul`` on the
host; the sweeps themselves run on the packed layout, never here.
"""

from __future__ import annotations

import itertools
import warnings
from collections import defaultdict

import numpy as np
import torch

from .charges import QTYPE, LegCharge, LegPipe

__all__ = ['Array', 'zeros', 'eye_like', 'diag', 'outer', 'inner',
           'tensordot', 'grid_outer', 'norm', 'trace', 'svd', 'qr', 'lq',
           'orthogonal_columns', 'polar', 'eigh', 'eigvalsh', 'expm',
           'concatenate',
           'detect_qtotal', 'conj_label', 'as_dtype', 'result_type']

_NP_TO_TORCH = {np.dtype(np.float64): torch.float64,
                np.dtype(np.float32): torch.float32,
                np.dtype(np.complex128): torch.complex128,
                np.dtype(np.complex64): torch.complex64,
                np.dtype(np.int64): torch.float64,
                np.dtype(np.int32): torch.float64,
                np.dtype(np.bool_): torch.float64}


def as_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or a python type
    (integer types become float64, as block data is floating point)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is None:
        return torch.float64
    return _NP_TO_TORCH[np.dtype(dtype)]


def _numpy_dtype(dtype):
    """The numpy dtype of a torch dtype."""
    return torch.empty(0, dtype=dtype).numpy().dtype


def result_type(*dtypes):
    """Promoted torch dtype of several dtypes (any form :func:`as_dtype`
    takes)."""
    res = as_dtype(dtypes[0])
    for d in dtypes[1:]:
        res = torch.promote_types(res, as_dtype(d))
    return res


def _scalar(x):
    """A python number (or 0-dim tensor) for block arithmetic."""
    if isinstance(x, np.generic) or (isinstance(x, np.ndarray)
                                     and x.ndim == 0):
        return x.item()
    return x


def _scalar_dtype(dtype, s):
    if isinstance(s, torch.Tensor):
        return torch.promote_types(dtype, s.dtype)
    if isinstance(s, complex) or np.iscomplexobj(s):
        return torch.promote_types(dtype, torch.complex128)
    return dtype


def _as_block(x, dtype=None):
    """A CPU torch tensor from a numpy array, a tensor or a scalar."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    if dtype is not None:
        x = x.to(as_dtype(dtype))
    return x


def _lexsort_rows(qdata):
    if qdata.shape[0] < 2:
        return np.arange(qdata.shape[0])
    return np.lexsort(qdata.T[::-1])


def _block_shape(legs, row):
    return tuple(int(l.slices[s + 1] - l.slices[s]) for l, s in zip(legs, row))


def _row_qtotal(legs, row):
    chinfo = legs[0].chinfo
    q = np.zeros(chinfo.qnumber, QTYPE)
    for l, s in zip(legs, row):
        q += l.charges[int(s)] * l.qconj
    return chinfo.make_valid(q)


def conj_label(lab):
    """``'a'`` <-> ``'a*'``; combined labels ``'(a.b)'`` conjugate each
    part."""
    if lab is None:
        return None
    if lab.startswith('(') and lab.endswith(')'):
        return '(' + '.'.join(conj_label(x) for x in
                              _split_combined_label(lab)) + ')'
    return lab[:-1] if lab.endswith('*') else lab + '*'


class Array:
    """A charge-conserving block-sparse tensor with CPU torch blocks.

    Parameters
    ----------
    legs : list of LegCharge
    dtype : torch dtype (or numpy dtype / python type)
    qtotal : charges or None
    labels : list of {str | None}, optional

    Attributes
    ----------
    legs, qtotal, dtype
    _qdata : np.ndarray (n_blocks, rank), rows lexsorted
    _data : list of torch.Tensor, one block per row of ``_qdata``
    """

    # numpy scalars defer to __rmul__/__radd__ instead of broadcasting
    __array_ufunc__ = None
    __array_priority__ = 10000

    def __init__(self, legs, dtype=torch.float64, qtotal=None, labels=None):
        legs = tuple(legs)
        if len(legs) == 0:
            raise ValueError("Array needs at least one leg")
        chinfo = legs[0].chinfo
        if any(l.chinfo != chinfo for l in legs[1:]):
            raise ValueError("legs with different ChargeInfo")
        self.legs = legs
        self.dtype = as_dtype(dtype)
        self.qtotal = tuple(int(q) for q in chinfo.make_valid(qtotal))
        self._labels = tuple(labels) if labels is not None \
            else (None,) * len(legs)
        self._qdata = np.zeros((0, len(legs)), QTYPE)
        self._data = []

    # ------------------------------------------------------------- properties
    @property
    def chinfo(self):
        return self.legs[0].chinfo

    @property
    def rank(self):
        return len(self.legs)

    ndim = rank

    @property
    def shape(self):
        return tuple(l.ind_len for l in self.legs)

    @property
    def stored_blocks(self):
        return len(self._data)

    def __repr__(self):
        return (f"<Array shape={self.shape} labels={list(self._labels)} "
                f"blocks={self.stored_blocks} dtype={self.dtype}>")

    # ----------------------------------------------------------------- labels
    def get_leg_index(self, label):
        if isinstance(label, (int, np.integer)):
            k = int(label)
            if k < 0:
                k += self.rank
            if not 0 <= k < self.rank:
                raise IndexError(label)
            return k
        try:
            return self._labels.index(label)
        except ValueError:
            raise KeyError(f"label {label!r} not in {self._labels}") from None

    def get_leg(self, label):
        return self.legs[self.get_leg_index(label)]

    def get_leg_labels(self):
        return self._labels

    def iset_leg_labels(self, labels):
        labels = tuple(labels)
        if len(labels) != self.rank:
            raise ValueError("wrong number of labels")
        self._labels = labels
        return self

    def ireplace_label(self, old, new):
        return self.ireplace_labels([old], [new])

    def replace_label(self, old, new):
        return self.copy(deep=False).ireplace_label(old, new)

    def ireplace_labels(self, olds, news):
        idx = [self.get_leg_index(o) for o in olds]
        lab = list(self._labels)
        for i, n in zip(idx, news):
            lab[i] = n
        self._labels = tuple(lab)
        return self

    def replace_labels(self, olds, news):
        return self.copy(deep=False).ireplace_labels(olds, news)

    # ----------------------------------------------------------- construction
    @classmethod
    def from_ndarray(cls, data_flat, legcharges, dtype=None, qtotal=None,
                     labels=None, raise_wrong_sector=False,
                     warn_wrong_sector=True):
        """Dense array -> block-sparse Array, given the legs' charges.

        Entries outside the charge-allowed blocks are dropped, with a warning
        (or an error) if their weight exceeds 1e-12 of the total."""
        data_flat = _as_block(data_flat, dtype)
        legs = tuple(legcharges)
        if tuple(data_flat.shape) != tuple(l.ind_len for l in legs):
            raise ValueError(f"shape mismatch {tuple(data_flat.shape)} vs "
                             f"legs")
        if qtotal is None:
            qtotal = detect_qtotal(data_flat, legs)
        res = cls(legs, data_flat.dtype, qtotal, labels)
        qdata, blocks = [], []
        kept = 0.
        for row in itertools.product(*[range(l.block_number) for l in legs]):
            if tuple(_row_qtotal(legs, row)) != res.qtotal:
                continue
            block = data_flat[tuple(l.get_slice(s)
                                    for l, s in zip(legs, row))]
            qdata.append(row)
            blocks.append(block.clone())
            kept += float((block.abs() ** 2).sum())
        total = float((data_flat.abs() ** 2).sum())
        if total - kept > 1e-24 * max(total, 1e-300) and total > 0:
            msg = (f"from_ndarray: dropped weight {total - kept:.3e} outside "
                   f"charge-allowed blocks (qtotal={res.qtotal})")
            if raise_wrong_sector:
                raise ValueError(msg)
            if warn_wrong_sector:
                warnings.warn(msg, stacklevel=2)
        res._set_blocks(np.array(qdata, QTYPE).reshape(len(qdata), len(legs)),
                        blocks)
        return res

    @classmethod
    def from_func(cls, func, legcharges, dtype=None, qtotal=None,
                  func_args=(), labels=None, shape_kw=None):
        """Every charge-allowed block filled by ``func(shape, *func_args)``
        (or ``func(*func_args, **{shape_kw: shape})``): a numpy array or a
        tensor, e.g. a random matrix of
        :mod:`~tenpy_tpu_torch.linalg.random_matrix`."""
        legs = tuple(legcharges)
        res = cls(legs, torch.float64 if dtype is None else dtype, qtotal,
                  labels)
        qdata, blocks = [], []
        for row in itertools.product(*[range(l.block_number) for l in legs]):
            if tuple(_row_qtotal(legs, row)) != res.qtotal:
                continue
            shape = _block_shape(legs, row)
            block = func(*func_args, **{shape_kw: shape}) \
                if shape_kw is not None else func(shape, *func_args)
            qdata.append(row)
            blocks.append(_as_block(block, dtype))
        if blocks:
            res.dtype = result_type(*[b.dtype for b in blocks])
            blocks = [b.to(res.dtype) for b in blocks]
        res._set_blocks(np.array(qdata, QTYPE).reshape(len(qdata), len(legs)),
                        blocks)
        return res

    def zeros_like(self):
        return Array(self.legs, self.dtype, self.qtotal, self._labels)

    def copy(self, deep=True):
        """A copy; ``deep`` copies the blocks too."""
        res = Array.__new__(Array)
        res.legs = self.legs
        res.dtype = self.dtype
        res.qtotal = self.qtotal
        res._labels = self._labels
        res._qdata = self._qdata
        res._data = [b.clone() for b in self._data] if deep \
            else list(self._data)
        return res

    def astype(self, dtype):
        dtype = as_dtype(dtype)
        res = self.copy(deep=False)
        res.dtype = dtype
        res._data = [b.to(dtype) for b in self._data]
        return res

    def real_if_close(self, tol=1e-12):
        """Real-dtype copy if every imaginary part is below ``tol`` of the
        largest entry, else ``self``."""
        if not self.dtype.is_complex:
            return self
        mx = max((float(b.imag.abs().max()) for b in self._data
                  if b.numel()), default=0.)
        scale = max((float(b.abs().max()) for b in self._data if b.numel()),
                    default=1.)
        if mx > tol * max(scale, 1e-300):
            return self
        res = self.copy(deep=False)
        res.dtype = self.dtype.to_real()
        res._data = [b.real.contiguous() for b in self._data]
        return res

    def _set_blocks(self, qdata, data):
        """Set blocks in canonical (row-lexsorted) order."""
        qdata = np.asarray(qdata, QTYPE).reshape(-1, self.rank)
        perm = _lexsort_rows(qdata)
        self._qdata = qdata[perm]
        self._qdata.setflags(write=False)
        self._data = [data[p] for p in perm]
        return self

    # --------------------------------------------------------------- dense
    def to_ndarray(self):
        """Dense torch tensor (zeros outside the stored blocks)."""
        out = torch.zeros(self.shape, dtype=self.dtype)
        for row, block in zip(self._qdata, self._data):
            out[tuple(l.get_slice(s) for l, s in zip(self.legs, row))] = \
                block.to(self.dtype)
        return out

    def to_numpy(self):
        return self.to_ndarray().numpy()

    # ------------------------------------------------------------------ hdf5
    def save_hdf5(self, hdf5_saver, h5gr, subpath):
        """The reference layout: children ``chinfo``, ``legs``, ``dtype``,
        ``total_charge``, ``labels``, ``blocks`` (numpy arrays) and
        ``block_inds``; attributes ``block_inds_sorted``, ``rank``,
        ``shape``."""
        hdf5_saver.save(self.chinfo, subpath + 'chinfo')
        hdf5_saver.save(list(self.legs), subpath + 'legs')
        hdf5_saver.save(_numpy_dtype(self.dtype), subpath + 'dtype')
        hdf5_saver.save(np.array(self.qtotal, QTYPE), subpath + 'total_charge')
        hdf5_saver.save(list(self._labels), subpath + 'labels')
        hdf5_saver.save([b.detach().cpu().resolve_conj().numpy()
                         for b in self._data], subpath + 'blocks')
        hdf5_saver.save(np.asarray(self._qdata), subpath + 'block_inds')
        h5gr.attrs['block_inds_sorted'] = True
        h5gr.attrs['rank'] = self.rank
        h5gr.attrs['shape'] = np.array(self.shape, np.intp)

    @classmethod
    def from_hdf5(cls, hdf5_loader, h5gr, subpath):
        """The blocks come back as CPU torch tensors."""
        obj = cls.__new__(cls)
        hdf5_loader.memorize_load(h5gr, obj)
        legs = tuple(hdf5_loader.load(subpath + 'legs'))
        dtype = hdf5_loader.load(subpath + 'dtype')
        qtotal = hdf5_loader.load(subpath + 'total_charge')
        labels = hdf5_loader.load(subpath + 'labels')
        blocks = hdf5_loader.load(subpath + 'blocks')
        qdata = np.asarray(hdf5_loader.load(subpath + 'block_inds'), QTYPE)
        obj.legs = legs
        obj.dtype = as_dtype(np.dtype(dtype))
        obj.qtotal = tuple(int(q) for q in legs[0].chinfo.make_valid(qtotal))
        obj._labels = tuple(labels)
        obj._set_blocks(qdata.reshape(len(blocks), len(legs)),
                        [torch.from_numpy(np.array(b)).to(obj.dtype)
                         for b in blocks])
        return obj

    def test_sanity(self):
        assert len(self._data) == len(self._qdata)
        for row, block in zip(self._qdata, self._data):
            assert tuple(_row_qtotal(self.legs, row)) == self.qtotal
            assert tuple(block.shape) == _block_shape(self.legs, row)
        rows = [tuple(r) for r in self._qdata]
        assert rows == sorted(rows) and len(set(rows)) == len(rows)

    # ----------------------------------------------------------- transpose
    def itranspose(self, perm=None):
        if perm is None:
            perm = tuple(range(self.rank))[::-1]
        perm = tuple(self.get_leg_index(p) for p in perm)
        if sorted(perm) != list(range(self.rank)):
            raise ValueError("invalid permutation")
        if perm == tuple(range(self.rank)):
            return self
        self.legs = tuple(self.legs[p] for p in perm)
        self._labels = tuple(self._labels[p] for p in perm)
        self._set_blocks(self._qdata[:, perm],
                         [b.permute(perm) for b in self._data])
        return self

    def transpose(self, perm=None):
        return self.copy(deep=False).itranspose(perm)

    def iconj(self, complex_conj=True):
        """Conjugate: flip every leg's qconj, negate qtotal, conjugate
        complex blocks and star-flip the labels."""
        self.legs = tuple(l.conj() for l in self.legs)
        self.qtotal = tuple(int(q) for q in self.chinfo.make_valid(
            -np.array(self.qtotal, QTYPE)))
        if complex_conj and self.dtype.is_complex:
            self._data = [b.conj() for b in self._data]
        self._labels = tuple(conj_label(l) for l in self._labels)
        return self

    def conj(self, complex_conj=True):
        return self.copy(deep=False).iconj(complex_conj)

    def gauge_total_charge(self, axis, newqtotal=None, new_qconj=None):
        """A copy with total charge ``newqtotal`` (default zero): the
        difference moves into the charges of leg ``axis`` (whose qconj
        becomes ``new_qconj``)."""
        axis = self.get_leg_index(axis)
        leg = self.legs[axis]
        chinfo = self.chinfo
        newqtotal = chinfo.make_valid(newqtotal)
        if new_qconj is None:
            new_qconj = leg.qconj
        dq = chinfo.make_valid(np.array(newqtotal, QTYPE)
                               - np.array(self.qtotal, QTYPE))
        q_new = chinfo.make_valid((leg.charges * leg.qconj + dq) * new_qconj)
        res = self.copy(deep=False)
        legs = list(res.legs)
        legs[axis] = LegCharge(chinfo, leg.slices, q_new, new_qconj)
        res.legs = tuple(legs)
        res.qtotal = tuple(int(q) for q in newqtotal)
        return res

    # ---------------------------------------------------------- arithmetic
    def _binary(self, other, op):
        if isinstance(other, Array):
            _check_same_structure(self, other)
            rows = {tuple(r): i for i, r in enumerate(self._qdata)}
            rows_o = {tuple(r): i for i, r in enumerate(other._qdata)}
            all_rows = sorted(set(rows) | set(rows_o))
            dtype = torch.promote_types(self.dtype, other.dtype)
            data = []
            for r in all_rows:
                a = self._data[rows[r]] if r in rows else None
                b = other._data[rows_o[r]] if r in rows_o else None
                if a is None:
                    a = torch.zeros(b.shape, dtype=dtype)
                if b is None:
                    b = torch.zeros(a.shape, dtype=dtype)
                data.append(op(a.to(dtype), b.to(dtype)))
            res = Array(self.legs, dtype, self.qtotal, self._labels)
            res._set_blocks(np.array(all_rows, QTYPE).reshape(len(all_rows),
                                                              self.rank),
                            data)
            return res
        if np.isscalar(other) or (isinstance(other, (torch.Tensor,
                                                     np.ndarray))
                                  and other.ndim == 0):
            other = _scalar(other)
            res = self.copy(deep=False)
            res._data = [op(b, other) for b in self._data]
            res.dtype = res._data[0].dtype if res._data \
                else _scalar_dtype(self.dtype, other)
            return res
        return NotImplemented

    def __add__(self, other):
        return self._binary(other, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._binary(other, lambda a, b: b - a)

    def __mul__(self, other):
        if isinstance(other, Array):
            raise TypeError("use tensordot for Array * Array")
        other = _scalar(other)
        res = self.copy(deep=False)
        res._data = [b * other for b in self._data]
        res.dtype = _scalar_dtype(self.dtype, other)
        return res

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self * (1. / _scalar(other))

    def __neg__(self):
        return self * (-1)

    # ----------------------------------------------------- scale / project
    def iscale_axis(self, s, axis=-1):
        """Scale leg ``axis`` by the full-length vector ``s``."""
        axis = self.get_leg_index(axis)
        s = _as_block(s)
        leg = self.legs[axis]
        if tuple(s.shape) != (leg.ind_len,):
            raise ValueError("scale vector length mismatch")
        dtype = torch.promote_types(self.dtype, s.dtype)
        data = []
        for row, block in zip(self._qdata, self._data):
            shp = [1] * self.rank
            shp[axis] = block.shape[axis]
            data.append(block * s[leg.get_slice(row[axis])].reshape(shp))
        self._data = data
        self.dtype = dtype
        return self

    def scale_axis(self, s, axis=-1):
        return self.copy(deep=False).iscale_axis(s, axis)

    def iproject(self, mask, axes):
        """Project legs onto boolean masks (in place)."""
        if not isinstance(axes, (list, tuple)):
            axes, mask = [axes], [mask]
        axes = [self.get_leg_index(a) for a in axes]
        map_qinds, block_masks = {}, {}
        legs = list(self.legs)
        for ax, m in zip(axes, mask):
            mq, bm, new_leg = self.legs[ax].project(np.asarray(m, bool))
            map_qinds[ax], block_masks[ax] = mq, bm
            legs[ax] = new_leg
        qdata, data = [], []
        for row, block in zip(self._qdata, self._data):
            new_row = np.array(row, QTYPE)
            if any(map_qinds[ax][row[ax]] < 0 for ax in axes):
                continue
            for ax in axes:
                new_row[ax] = map_qinds[ax][row[ax]]
                idx = torch.from_numpy(np.nonzero(block_masks[ax][row[ax]])[0])
                block = block.index_select(ax, idx)
            qdata.append(new_row)
            data.append(block)
        self.legs = tuple(legs)
        self._set_blocks(np.array(qdata, QTYPE).reshape(len(qdata), self.rank),
                         data)
        return self

    def norm(self):
        return norm(self)

    # ------------------------------------------------------- combine / split
    def combine_legs(self, combine_legs, pipes=None, qconj=None):
        """Fuse groups of legs into :class:`LegPipe` s.

        ``combine_legs`` is a list of groups of labels or indices; each group
        becomes one leg at the position of its first leg, the other legs
        keep their order.  ``pipes`` (one per group, None to build one)
        gives the pipes to combine into, e.g. those of another array whose
        legs must match."""
        if len(combine_legs) > 0 and not isinstance(combine_legs[0],
                                                    (list, tuple)):
            combine_legs = [combine_legs]
        groups = [[self.get_leg_index(l) for l in g] for g in combine_legs]
        flat = [i for g in groups for i in g]
        if len(set(flat)) != len(flat):
            raise ValueError("leg appears in multiple groups")
        if qconj is None:
            qconj = [1] * len(groups)
        elif not isinstance(qconj, (list, tuple)):
            qconj = [qconj] * len(groups)
        rest = [i for i in range(self.rank) if i not in flat]
        events = sorted([(min(g), ('g', k)) for k, g in enumerate(groups)]
                        + [(r, ('r', r)) for r in rest])
        perm, pipe_pos, pos = [], [], 0
        for _, (kind, v) in events:
            if kind == 'g':
                pipe_pos.append((pos, v))
                perm.extend(groups[v])
                pos += len(groups[v])
            else:
                perm.append(v)
                pos += 1
        a = self.transpose(perm)
        if pipes is None:
            pipes = [None] * len(groups)
        built = []
        for p0, gk in pipe_pos:
            glen = len(groups[gk])
            pipe = pipes[gk]
            if pipe is None:
                pipe = LegPipe(a.legs[p0:p0 + glen], qconj=qconj[gk])
            built.append((p0, glen, pipe))
        return _combine_consecutive(a, built)

    def split_legs(self, axes=None):
        """Undo :meth:`combine_legs` for the given (or all) LegPipe legs."""
        if axes is None:
            axes = [i for i, l in enumerate(self.legs)
                    if isinstance(l, LegPipe)]
        else:
            axes = [self.get_leg_index(a) for a in axes]
            for a in axes:
                if not isinstance(self.legs[a], LegPipe):
                    raise ValueError(f"leg {a} is not a LegPipe")
        if not axes:
            return self.copy(deep=False)
        return _split_legs_worker(self, sorted(axes))

    def add_leg(self, leg, i, axis=0, label=None):
        """Embed self at index ``i`` of a new leg inserted at ``axis``."""
        flat = np.zeros(leg.ind_len)
        flat[i] = 1.
        u = Array.from_ndarray(flat, [leg], qtotal=leg.to_qflat()[i] * leg.qconj,
                               labels=[label], warn_wrong_sector=False)
        res = outer(self, u)
        perm = list(range(self.rank))
        perm.insert(axis, self.rank)
        return res.itranspose(perm)

    def squeeze(self, axes=None):
        """Remove legs of length 1 (their charge goes into qtotal)."""
        if axes is None:
            axes = [i for i, l in enumerate(self.legs) if l.ind_len == 1]
        else:
            if not isinstance(axes, (list, tuple)):
                axes = [axes]
            axes = [self.get_leg_index(a) for a in axes]
        if any(self.legs[a].ind_len != 1 for a in axes):
            raise ValueError("cannot squeeze leg of length > 1")
        if len(axes) == self.rank:
            raise ValueError("cannot squeeze every leg")
        keep = [i for i in range(self.rank) if i not in axes]
        chinfo = self.chinfo
        dq = np.zeros(chinfo.qnumber, QTYPE)
        for a in axes:
            dq += self.legs[a].charges[0] * self.legs[a].qconj
        res = Array([self.legs[i] for i in keep], self.dtype,
                    chinfo.make_valid(np.array(self.qtotal, QTYPE) - dq),
                    [self._labels[i] for i in keep])
        res._set_blocks(self._qdata[:, keep],
                        [b.reshape([d for k, d in enumerate(b.shape)
                                    if k not in axes]) for b in self._data])
        return res


def _check_same_structure(a, b):
    if a.rank != b.rank:
        raise ValueError("rank mismatch")
    for la, lb in zip(a.legs, b.legs):
        la.test_equal(lb)
    if a.qtotal != b.qtotal:
        raise ValueError(f"qtotal mismatch {a.qtotal} vs {b.qtotal}")


# ------------------------------------------------------------- constructors
def zeros(legcharges, dtype=torch.float64, qtotal=None, labels=None):
    return Array(legcharges, dtype, qtotal, labels)


def eye_like(a, axis=0, labels=None):
    """Identity with legs ``[leg, leg.conj()]``, ``leg`` the leg ``axis``
    of ``a`` (or ``a`` itself if it is a leg)."""
    leg = a.legs[a.get_leg_index(axis)] if isinstance(a, Array) else a
    return diag(1., leg, labels=labels)


def diag(s, leg, dtype=None, labels=None):
    """Square diagonal Array with legs ``[leg, leg.conj()]``; ``s`` is a
    scalar or a vector of length ``leg.ind_len``."""
    scalar = np.isscalar(s) or np.ndim(s) == 0
    if dtype is None:
        dtype = torch.complex128 if np.iscomplexobj(s) else torch.float64
    dtype = as_dtype(dtype)
    if not scalar:
        s = _as_block(s, dtype)
        if tuple(s.shape) != (leg.ind_len,):
            raise ValueError("diagonal length mismatch")
    res = Array([leg, leg.conj()], dtype, None, labels)
    data = []
    for qi in range(leg.block_number):
        n = int(leg.slices[qi + 1] - leg.slices[qi])
        data.append(_scalar(s) * torch.eye(n, dtype=dtype) if scalar
                    else torch.diag(s[leg.get_slice(qi)]))
    res._set_blocks(np.array([(qi, qi) for qi in range(leg.block_number)],
                             QTYPE).reshape(leg.block_number, 2), data)
    return res


def detect_qtotal(flat_array, legcharges):
    """qtotal from the largest-magnitude entry of a dense array."""
    flat = _as_block(flat_array)
    idx = np.unravel_index(int(flat.abs().argmax()), tuple(flat.shape))
    row = [l.get_qindex(int(i))[0] for l, i in zip(legcharges, idx)]
    return _row_qtotal(legcharges, row)


# ---------------------------------------------------------------- tensordot
_TD_PLAN_CACHE = {}


def _struct_sig(a):
    return (a.legs, a.qtotal, a._qdata.tobytes(), a._qdata.shape)


def _tensordot_plan(a, b, n_axes):
    """(out_rows, out_shapes, tasks) of ``a``'s last ``n_axes`` legs with
    ``b``'s first; ``tasks`` lists ``(i, j, out_index, m, k, n)``."""
    key = (_struct_sig(a), _struct_sig(b), n_axes)
    plan = _TD_PLAN_CACHE.get(key)
    if plan is not None:
        return plan
    ka = a.rank - n_axes
    a_by_c = defaultdict(list)
    for i, row in enumerate(a._qdata):
        a_by_c[tuple(row[ka:])].append(i)
    b_by_c = defaultdict(list)
    for j, row in enumerate(b._qdata):
        b_by_c[tuple(row[:n_axes])].append(j)
    out_map, out_rows, out_shapes, tasks = {}, [], [], []
    free = a.legs[:ka] + b.legs[n_axes:]
    for c_sec, a_list in a_by_c.items():
        b_list = b_by_c.get(c_sec)
        if b_list is None:
            continue
        k = int(np.prod(_block_shape(a.legs[ka:], c_sec), dtype=np.int64))
        for i in a_list:
            arow = a._qdata[i]
            m = int(np.prod(_block_shape(a.legs[:ka], arow[:ka]),
                            dtype=np.int64))
            for j in b_list:
                brow = b._qdata[j]
                n = int(np.prod(_block_shape(b.legs[n_axes:], brow[n_axes:]),
                                dtype=np.int64))
                out_row = tuple(arow[:ka]) + tuple(brow[n_axes:])
                oi = out_map.get(out_row)
                if oi is None:
                    oi = out_map[out_row] = len(out_rows)
                    out_rows.append(out_row)
                    out_shapes.append(_block_shape(free, out_row))
                tasks.append((i, j, oi, m, k, n))
    # the JAX host path runs its tasks grouped by GEMM shape, in sorted shape
    # order: the same order gives the same sums
    tasks.sort(key=lambda t: t[3:])
    plan = (np.array(out_rows, QTYPE).reshape(len(out_rows), len(free)),
            out_shapes, tasks)
    if len(_TD_PLAN_CACHE) > 4096:
        _TD_PLAN_CACHE.clear()
    _TD_PLAN_CACHE[key] = plan
    return plan


def tensordot(a, b, axes=2):
    """Contract ``a`` and ``b`` along ``axes`` (an int, or two lists of leg
    indices or labels); a full contraction returns a 0-dim tensor."""
    if isinstance(axes, (int, np.integer)):
        n_axes = int(axes)
        axes_a = list(range(a.rank - n_axes, a.rank))
        axes_b = list(range(n_axes))
    else:
        axes_a, axes_b = axes
        if not isinstance(axes_a, (list, tuple)):
            axes_a = [axes_a]
        if not isinstance(axes_b, (list, tuple)):
            axes_b = [axes_b]
        axes_a = [a.get_leg_index(x) for x in axes_a]
        axes_b = [b.get_leg_index(x) for x in axes_b]
        n_axes = len(axes_a)
    if len(axes_a) != len(axes_b):
        raise ValueError("axes length mismatch")
    perm_a = [i for i in range(a.rank) if i not in axes_a] + list(axes_a)
    perm_b = list(axes_b) + [i for i in range(b.rank) if i not in axes_b]
    at = a.transpose(perm_a) if perm_a != list(range(a.rank)) else a
    bt = b.transpose(perm_b) if perm_b != list(range(b.rank)) else b
    ka = a.rank - n_axes
    for la, lb in zip(at.legs[ka:], bt.legs[:n_axes]):
        la.test_contractible(lb)
    dtype = torch.promote_types(a.dtype, b.dtype)
    if ka + b.rank - n_axes == 0:
        total = torch.zeros((), dtype=dtype)
        rows_b = {tuple(r): i for i, r in enumerate(bt._qdata)}
        for i, row in enumerate(at._qdata):
            j = rows_b.get(tuple(row))
            if j is not None:
                total = total + (at._data[i].to(dtype)
                                 * bt._data[j].to(dtype)).sum()
        return total
    out_legs = at.legs[:ka] + bt.legs[n_axes:]
    res = Array(out_legs, dtype,
                a.chinfo.make_valid(np.array(at.qtotal, QTYPE)
                                    + np.array(bt.qtotal, QTYPE)),
                at._labels[:ka] + bt._labels[n_axes:])
    if at.stored_blocks == 0 or bt.stored_blocks == 0:
        return res
    out_rows, out_shapes, tasks = _tensordot_plan(at, bt, n_axes)
    a_data = [x if x.dtype == dtype else x.to(dtype) for x in at._data]
    b_data = [x if x.dtype == dtype else x.to(dtype) for x in bt._data]
    a_mats, b_mats = {}, {}      # each block as its matrix, made once
    partial = [None] * len(out_shapes)
    for i, j, oi, m, k, n in tasks:
        am = a_mats.get(i)
        if am is None:
            am = a_mats[i] = a_data[i].reshape(m, k)
        bm = b_mats.get(j)
        if bm is None:
            bm = b_mats[j] = b_data[j].reshape(k, n)
        if partial[oi] is None:
            partial[oi] = torch.matmul(am, bm)
        else:
            partial[oi].addmm_(am, bm)
    res._set_blocks(out_rows, [p.reshape(s)
                               for p, s in zip(partial, out_shapes)])
    return res


def inner(a, b, axes='labels', do_conj=False):
    """Full contraction of two same-rank arrays -> 0-dim tensor.

    ``axes='range'`` pairs legs in order; ``'labels'`` pairs each leg of
    ``a`` with the leg of ``b`` of the conjugate label (the same label with
    ``do_conj``)."""
    if axes == 'range':
        axes_a, axes_b = list(range(a.rank)), list(range(b.rank))
    elif axes == 'labels':
        axes_a = list(range(a.rank))
        axes_b = [b.get_leg_index(l if do_conj else conj_label(l))
                  for l in a.get_leg_labels()]
    else:
        axes_a = [a.get_leg_index(x) for x in axes[0]]
        axes_b = [b.get_leg_index(x) for x in axes[1]]
    if len(axes_a) != a.rank or len(axes_b) != b.rank:
        raise ValueError("inner() needs a full contraction; use tensordot")
    if do_conj:
        a = a.conj()
    return tensordot(a, b, (axes_a, axes_b))


def outer(a, b):
    """Tensor product (no contraction)."""
    legs = a.legs + b.legs
    labels = a._labels + b._labels
    if any(l is not None and l in a._labels for l in b._labels):
        labels = (None,) * len(legs)
    dtype = torch.promote_types(a.dtype, b.dtype)
    res = Array(legs, dtype,
                a.chinfo.make_valid(np.array(a.qtotal, QTYPE)
                                    + np.array(b.qtotal, QTYPE)), labels)
    qdata, data = [], []
    for ra, ba in zip(a._qdata, a._data):
        for rb, bb in zip(b._qdata, b._data):
            qdata.append(np.concatenate([ra, rb]))
            data.append(torch.tensordot(ba.to(dtype), bb.to(dtype), dims=0))
    res._set_blocks(np.array(qdata, QTYPE).reshape(len(qdata), len(legs)),
                    data)
    return res


def concatenate(arrays, axis=0):
    """Stack arrays along leg ``axis``: the new leg lists the sectors of
    each array's leg in turn (its qconj that of the first); every other
    leg and the total charge must agree."""
    arrays = list(arrays)
    a0 = arrays[0]
    axis = a0.get_leg_index(axis)
    chinfo = a0.chinfo
    for a in arrays[1:]:
        if a.rank != a0.rank or a.qtotal != a0.qtotal:
            raise ValueError("incompatible arrays")
        for i, (la, lb) in enumerate(zip(a0.legs, a.legs)):
            if i != axis:
                la.test_equal(lb)
    slices, charges, offsets, qoff = [0], [], [], 0
    for a in arrays:
        leg = a.legs[axis]
        offsets.append(qoff)
        for qi in range(leg.block_number):
            slices.append(slices[-1] + int(leg.slices[qi + 1]
                                           - leg.slices[qi]))
            charges.append(leg.charges[qi])
        qoff += leg.block_number
    new_leg = LegCharge(chinfo, slices,
                        np.array(charges, QTYPE).reshape(len(charges),
                                                         chinfo.qnumber),
                        a0.legs[axis].qconj)
    legs = list(a0.legs)
    legs[axis] = new_leg
    dtype = result_type(*[a.dtype for a in arrays])
    res = Array(legs, dtype, a0.qtotal, a0._labels)
    qdata, data = [], []
    for a, off in zip(arrays, offsets):
        for row, block in zip(a._qdata, a._data):
            r = np.array(row, QTYPE)
            r[axis] += off
            qdata.append(r)
            data.append(block.to(dtype))
    res._set_blocks(np.array(qdata, QTYPE).reshape(len(qdata), len(legs)),
                    data)
    return res


def grid_outer(grid, grid_legs, qtotal=None, grid_labels=None):
    """Sum of outer products ``res[i, j, ...] += grid[i][j]`` over a grid of
    arrays (``None`` entries are zero); the MPO builder's W tensors."""
    grid = np.asarray(grid, dtype=object)
    if len(grid_legs) != grid.ndim:
        raise ValueError("grid_legs must match grid dimension")
    entries = [e for e in grid.ravel() if e is not None]
    if not entries:
        raise ValueError("empty grid")
    entry = entries[0]
    chinfo = entry.chinfo
    if qtotal is None:
        idx = next(i for i in np.ndindex(*grid.shape) if grid[i] is not None)
        q = np.array(grid[idx].qtotal, QTYPE)
        for l, i in zip(grid_legs, idx):
            qi, _ = l.get_qindex(int(i))
            q = q + l.charges[qi] * l.qconj
        qtotal = chinfo.make_valid(q)
    legs = list(grid_legs) + list(entry.legs)
    labels = None
    if grid_labels is not None:
        labels = list(grid_labels) + list(entry._labels)
    dtype = result_type(*[e.dtype for e in entries])
    res = Array(legs, dtype, qtotal, labels)
    ngrid = grid.ndim
    acc = {}
    for idx in np.ndindex(*grid.shape):
        e = grid[idx]
        if e is None:
            continue
        grid_row, within = [], []
        for l, i in zip(grid_legs, idx):
            qi, r = l.get_qindex(int(i))
            grid_row.append(qi)
            within.append(r)
        sl = tuple(slice(w, w + 1) for w in within) + \
            (slice(None),) * e.rank
        for row, block in zip(e._qdata, e._data):
            out_row = tuple(grid_row) + tuple(int(x) for x in row)
            if out_row not in acc:
                acc[out_row] = torch.zeros(_block_shape(res.legs, out_row),
                                           dtype=dtype)
            acc[out_row][sl] += block.reshape((1,) * ngrid
                                              + tuple(block.shape)).to(dtype)
    rows = sorted(acc)
    res._set_blocks(np.array(rows, QTYPE).reshape(len(rows), len(legs)),
                    [acc[r] for r in rows])
    return res


def norm(a):
    """Frobenius norm of an Array (a float)."""
    return float(np.sqrt(sum(float((b.abs() ** 2).sum()) for b in a._data)))


def trace(a, leg1=0, leg2=1):
    """The trace over the contractible legs ``leg1`` and ``leg2``: of a
    2-leg Array a 0-dim tensor; of more legs the partial trace, an Array
    of the remaining legs (their labels and order kept, the same
    ``qtotal``)."""
    i1, i2 = a.get_leg_index(leg1), a.get_leg_index(leg2)
    a.legs[i1].test_contractible(a.legs[i2])
    keep = [i for i in range(a.rank) if i not in (i1, i2)]
    if not keep:
        total = torch.zeros((), dtype=a.dtype)
        for row, block in zip(a._qdata, a._data):
            if row[i1] == row[i2]:
                total = total + torch.trace(block)
        return total
    res = Array([a.legs[i] for i in keep], a.dtype, a.qtotal,
                [a._labels[i] for i in keep])
    acc = {}
    for row, block in zip(a._qdata, a._data):
        if row[i1] != row[i2]:
            continue
        out_row = tuple(int(row[i]) for i in keep)
        tr = torch.diagonal(block, dim1=i1, dim2=i2).sum(-1)
        acc[out_row] = tr if out_row not in acc else acc[out_row] + tr
    rows = sorted(acc)
    res._set_blocks(np.array(rows, QTYPE).reshape(len(rows), len(keep)),
                    [acc[r] for r in rows])
    return res


# ----------------------------------------------------------- combine / split
def _combine_consecutive(a, built_pipes):
    """Combine consecutive leg ranges of (already transposed) ``a``:
    ``built_pipes`` lists ``(start, n_legs, LegPipe)``, ascending."""
    new_legs, new_labels, col_map = [], [], []
    pipe_at = {p0: (glen, pipe) for p0, glen, pipe in built_pipes}
    pos = 0
    while pos < a.rank:
        if pos in pipe_at:
            glen, pipe = pipe_at[pos]
            new_legs.append(pipe)
            labs = a._labels[pos:pos + glen]
            new_labels.append('(' + '.'.join(labs) + ')'
                              if all(l is not None for l in labs) else None)
            col_map.append(('p', tuple(range(pos, pos + glen))))
            pos += glen
        else:
            new_legs.append(a.legs[pos])
            new_labels.append(a._labels[pos])
            col_map.append(('k', pos))
            pos += 1
    res = Array(new_legs, a.dtype, a.qtotal, new_labels)
    out_accum = {}
    for row, block in zip(a._qdata, a._data):
        out_row, slabs = [], []
        for k, entry in enumerate(col_map):
            if entry[0] == 'k':
                s = int(row[entry[1]])
                out_row.append(s)
                sz = int(a.legs[entry[1]].slices[s + 1]
                         - a.legs[entry[1]].slices[s])
                slabs.append((0, sz))
            else:
                start, stop, fqi = new_legs[k].map_comb(
                    [int(row[o]) for o in entry[1]])
                out_row.append(fqi)
                slabs.append((start, stop - start))
        out_accum.setdefault(tuple(out_row), []).append(
            (slabs, block.reshape([s for _, s in slabs])))
    rows = sorted(out_accum)
    data = []
    for r in rows:
        out = torch.zeros(_block_shape(new_legs, r), dtype=a.dtype)
        for slabs, blk in out_accum[r]:
            out[tuple(slice(o, o + s) for o, s in slabs)] = blk
        data.append(out)
    res._set_blocks(np.array(rows, QTYPE).reshape(len(rows), len(new_legs)),
                    data)
    return res


def _split_legs_worker(a, axes):
    """Split the LegPipe legs at ``axes`` back into their constituents."""
    new_legs, new_labels, expand = [], [], {}
    for i, leg in enumerate(a.legs):
        if i in axes:
            expand[i] = leg
            new_legs.extend(leg.legs)
            lab = a._labels[i]
            parts = _split_combined_label(lab) if lab is not None and \
                lab.startswith('(') and lab.endswith(')') else None
            new_labels.extend(parts if parts is not None
                              and len(parts) == leg.nlegs
                              else [None] * leg.nlegs)
        else:
            new_legs.append(leg)
            new_labels.append(a._labels[i])
    res = Array(new_legs, a.dtype, a.qtotal, new_labels)
    rows, data = [], []
    for row, block in zip(a._qdata, a._data):
        choices = []
        for i in range(a.rank):
            if i in expand:
                pipe = expand[i]
                lo = int(pipe.q_map_slices[int(row[i])])
                hi = int(pipe.q_map_slices[int(row[i]) + 1])
                choices.append([pipe.q_map[r] for r in range(lo, hi)])
            else:
                choices.append([None])
        for choice in itertools.product(*choices):
            out_row, sub_slices, final_shape = [], [], []
            for i in range(a.rank):
                if choice[i] is None:
                    out_row.append(int(row[i]))
                    sub_slices.append(slice(None))
                    final_shape.append(block.shape[i])
                else:
                    qm = choice[i]
                    sub_slices.append(slice(int(qm[0]), int(qm[1])))
                    combo = [int(x) for x in qm[3:]]
                    out_row.extend(combo)
                    final_shape.extend(
                        _block_shape(expand[i].legs, combo))
            rows.append(out_row)
            data.append(block[tuple(sub_slices)].reshape(final_shape))
    res._set_blocks(np.array(rows, QTYPE).reshape(len(rows), len(new_legs)),
                    data)
    return res


def _split_combined_label(lab):
    """``'(a.(b.c).d)'`` -> ``['a', '(b.c)', 'd']``."""
    parts, depth, cur = [], 0, ''
    for ch in lab[1:-1]:
        if ch == '.' and depth == 0:
            parts.append(cur)
            cur = ''
            continue
        depth += (ch == '(') - (ch == ')')
        cur += ch
    parts.append(cur)
    return parts


# ------------------------------------------------------------ decompositions
def _split_qtotal(chinfo, qtotal, qtotal_LR):
    """``(qL, qR)`` adding up to ``qtotal``; by default ``qL`` is zero."""
    q_full = np.array(qtotal, QTYPE)
    qL, qR = qtotal_LR
    if qL is None and qR is None:
        qL = chinfo.make_valid()
    elif qL is None:
        qL = chinfo.make_valid(q_full - chinfo.make_valid(qR))
    return chinfo.make_valid(qL), chinfo.make_valid(q_full
                                                    - chinfo.make_valid(qL))


def svd(a, compute_uv=True, cutoff=None, qtotal_LR=(None, None),
        inner_labels=(None, None)):
    """Blockwise SVD of a 2-leg Array: ``a = U @ diag(S) @ VH``.

    ``S`` is a numpy vector along the new inner leg; with ``cutoff`` the
    singular values at or below it are dropped.  Blocks that share a row or
    column sector (legs with repeated charges) are decomposed together, as
    connected components of the (row, column) sector graph.  ``qtotal_LR``
    splits ``a``'s charge between U and VH (default all on VH)."""
    if a.rank != 2:
        raise ValueError("svd needs a 2-leg array; combine_legs first")
    if a.stored_blocks == 0:
        raise ValueError("svd of array with no blocks")
    chinfo = a.chinfo
    qL, qR = _split_qtotal(chinfo, a.qtotal, qtotal_LR)
    blocks_u, blocks_vh, blocks_s, inner_charges = [], [], [], []
    for rows, cols, idxs in _matrix_block_components(a):
        row_off = np.concatenate([[0], np.cumsum(
            [int(a.legs[0].slices[r + 1] - a.legs[0].slices[r])
             for r in rows])])
        col_off = np.concatenate([[0], np.cumsum(
            [int(a.legs[1].slices[c + 1] - a.legs[1].slices[c])
             for c in cols])])
        if len(idxs) == 1 and len(rows) == 1 and len(cols) == 1:
            sub = a._data[idxs[0]]
        else:
            sub = torch.zeros((int(row_off[-1]), int(col_off[-1])),
                              dtype=a.dtype)
            rpos = {r: k for k, r in enumerate(rows)}
            cpos = {c: k for k, c in enumerate(cols)}
            for bi in idxs:
                r, c = int(a._qdata[bi][0]), int(a._qdata[bi][1])
                sub[int(row_off[rpos[r]]):int(row_off[rpos[r] + 1]),
                    int(col_off[cpos[c]]):int(col_off[cpos[c] + 1])] = \
                    a._data[bi]
        u, s, vh = _robust_svd(sub)
        if cutoff is not None:
            keep = np.nonzero(s.numpy() > cutoff)[0]
            if len(keep) < len(s):
                if len(keep) == 0:
                    continue
                keep = torch.from_numpy(keep)
                u, s, vh = u[:, keep], s[keep], vh[keep, :]
        # the inner charge follows from the first row sector
        q_row = a.legs[0].charges[rows[0]] * a.legs[0].qconj
        inner = len(inner_charges)
        inner_charges.append(chinfo.make_valid(q_row - qL))
        blocks_s.append(s)
        for kr, r in enumerate(rows):
            blocks_u.append((r, inner,
                             u[int(row_off[kr]):int(row_off[kr + 1]), :]))
        for kc, c in enumerate(cols):
            blocks_vh.append((inner, c,
                              vh[:, int(col_off[kc]):int(col_off[kc + 1])]))
    S = torch.cat(blocks_s).numpy() if blocks_s else np.zeros(0)
    if not compute_uv:
        return S
    leg_R = LegCharge(chinfo,
                      np.concatenate([[0], np.cumsum([len(s) for s in
                                                      blocks_s])]),
                      np.array(inner_charges, QTYPE).reshape(
                          len(inner_charges), chinfo.qnumber),
                      +1)       # the inner leg of VH; U has its conj
    U = Array([a.legs[0], leg_R.conj()], a.dtype, qL,
              [a._labels[0], inner_labels[0]])
    VH = Array([leg_R, a.legs[1]], a.dtype, qR,
               [inner_labels[1], a._labels[1]])
    U._set_blocks(np.array([(r, i) for r, i, _ in blocks_u], QTYPE).reshape(
        len(blocks_u), 2), [b for _, _, b in blocks_u])
    VH._set_blocks(np.array([(i, c) for i, c, _ in blocks_vh], QTYPE).reshape(
        len(blocks_vh), 2), [b for _, _, b in blocks_vh])
    return U, S, VH


def polar(a, left=False):
    """Polar decomposition of a 2-leg Array: ``a = W P`` with ``W``
    isometric and ``P = (a^dagger a)^(1/2)`` (``left``: ``a = P W``, ``P =
    (a a^dagger)^(1/2)``), both from the blockwise :func:`svd` ``a = U S
    VH``: ``W = U VH``, ``P = VH^dagger S VH`` (``U S U^dagger``).  ``W``
    keeps ``a``'s legs, labels and total charge."""
    U, S, VH = svd(a)
    W = tensordot(U, VH, axes=[[1], [0]])
    if left:
        P = tensordot(U.scale_axis(S, 1), U.conj().itranspose([1, 0]),
                      axes=[[1], [0]])
        return W, P
    P = tensordot(VH.conj().itranspose([1, 0]).iscale_axis(S, 1), VH,
                  axes=[[1], [0]])
    return W, P


def _matrix_block_components(a):
    """``(rows, cols, block_indices)`` of each connected component of the
    stored blocks of 2-leg ``a`` (rows and cols sorted)."""
    parent = {}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for row in a._qdata:
        r, c = ('r', int(row[0])), ('c', int(row[1]))
        parent.setdefault(r, r)
        parent.setdefault(c, c)
        rr, rc = find(r), find(c)
        if rr != rc:
            parent[rr] = rc
    comps = {}
    for bi, row in enumerate(a._qdata):
        comp = comps.setdefault(find(('r', int(row[0]))), [set(), set(), []])
        comp[0].add(int(row[0]))
        comp[1].add(int(row[1]))
        comp[2].append(bi)
    return [(sorted(rows), sorted(cols), idxs)
            for rows, cols, idxs in comps.values()]


def _robust_svd(block):
    """``torch.linalg.svd`` (LAPACK gesdd); where it fails or returns NaN,
    scipy's gesvd."""
    try:
        u, s, vh = torch.linalg.svd(block, full_matrices=False)
        if not torch.isnan(s).any():
            return u, s, vh
    except torch.linalg.LinAlgError:
        pass
    import scipy.linalg
    u, s, vh = scipy.linalg.svd(block.numpy(), full_matrices=False,
                                lapack_driver='gesvd')
    return torch.from_numpy(u), torch.from_numpy(s), torch.from_numpy(vh)


def eigh(a, UPLO='L', sort=None):
    """Blockwise hermitian eigendecomposition of a square 2-leg Array of
    zero charge: ``(W, V)`` with ``W`` a numpy vector along leg 0 and ``V``
    an Array with legs ``[a.legs[0], a.legs[0].conj()]``; a sector without
    a stored block has ``W = 0`` and ``V = 1``.  Each sector's eigenvalues
    are ascending, or in the order ``sort`` ('m>', 'm<', '>', '<', as
    ``tenpy_tpu``'s numpy argsort).  ``UPLO`` is accepted for the API and,
    as in ``tenpy_tpu``, not used: the whole block is read."""
    if a.rank != 2:
        raise ValueError("need 2-leg array")
    a.legs[0].test_contractible(a.legs[1])
    if any(q != 0 for q in a.qtotal):
        raise ValueError("eigh requires qtotal=0")
    leg = a.legs[0]
    W = np.zeros(leg.ind_len)
    V = diag(1., leg, dtype=a.dtype)
    v_rows = {tuple(r): i for i, r in enumerate(V._qdata)}
    for row, block in zip(a._qdata, a._data):
        if row[0] != row[1]:
            raise ValueError("off-diagonal block in eigh")
        w, v = torch.linalg.eigh(block)
        w = w.numpy()
        if sort is not None:
            perm = _eig_sort_perm(w, sort)
            w = w[perm]
            v = v[:, torch.from_numpy(perm)]
        W[leg.get_slice(int(row[0]))] = w
        V._data[v_rows[(int(row[0]), int(row[0]))]] = v
    return W, V


def eigvalsh(a, UPLO='L', sort=None):
    """The eigenvalues of a hermitian square 2-leg Array of zero charge, a
    numpy vector along leg 0 (zeros in sectors without a stored block),
    ascending per sector or in the order ``sort`` (as :func:`eigh`)."""
    if a.rank != 2:
        raise ValueError("need 2-leg array")
    a.legs[0].test_contractible(a.legs[1])
    if any(q != 0 for q in a.qtotal):
        raise ValueError("eigvalsh requires qtotal=0")
    leg = a.legs[0]
    W = np.zeros(leg.ind_len)
    for row, block in zip(a._qdata, a._data):
        w = torch.linalg.eigvalsh(block).numpy()
        if sort is not None:
            w = w[_eig_sort_perm(w, sort)]
        W[leg.get_slice(int(row[0]))] = w
    return W


def _eig_sort_perm(w, sort):
    """``tenpy_tpu``'s order of eigenvalues (numpy's default argsort, so
    the same order of ties)."""
    if sort == 'm>':
        return np.argsort(-abs(w))
    if sort == 'm<':
        return np.argsort(abs(w))
    if sort == '>':
        return np.argsort(-w.real)
    if sort == '<':
        return np.argsort(w.real)
    raise ValueError(f"unknown sort {sort!r}")


def expm(a):
    """The blockwise matrix exponential of a square 2-leg Array (legs
    ``[leg, leg.conj()]``, zero charge); its legs and labels are kept."""
    if a.rank != 2:
        raise ValueError("expm needs a 2-leg array")
    res = diag(1., a.legs[0], dtype=a.dtype)
    res.legs = a.legs
    res._labels = a._labels
    rows = {tuple(int(x) for x in r): i for i, r in enumerate(res._qdata)}
    for row, block in zip(a._qdata, a._data):
        res._data[rows[(int(row[0]), int(row[1]))]] = \
            torch.linalg.matrix_exp(block)
    return res


def qr(a, inner_labels=(None, None), pos_diag_R=False, qtotal_Q=None,
       inner_qconj=+1):
    """Blockwise QR of a 2-leg Array (reduced): ``a = Q @ R``; ``qtotal_Q``
    (default zero) is the total charge of Q, R carries the rest."""
    if a.rank != 2:
        raise ValueError("qr needs a 2-leg array")
    chinfo = a.chinfo
    qtotal_Q = chinfo.make_valid(qtotal_Q)
    qtotal_R = chinfo.make_valid(np.array(a.qtotal, QTYPE) - qtotal_Q)
    rows, q_blocks, r_blocks, charges, sizes = [], [], [], [], []
    for row, block in zip(a._qdata, a._data):
        q, r = torch.linalg.qr(block, mode='reduced')
        if pos_diag_R:
            d = torch.diagonal(r)
            big = d.abs() > 1e-300
            phase = torch.where(big, d / torch.where(big, d.abs(),
                                                     torch.ones_like(d.abs())),
                                torch.ones_like(d))
            q = q * phase[None, :]
            r = r * phase.conj()[:, None]
        rows.append(row)
        q_blocks.append(q)
        r_blocks.append(r)
        q_row = a.legs[0].charges[row[0]] * a.legs[0].qconj
        charges.append(chinfo.make_valid((q_row - qtotal_Q) * inner_qconj))
        sizes.append(q.shape[1])
    leg_R = LegCharge(chinfo, np.concatenate([[0], np.cumsum(sizes)]),
                      np.array(charges, QTYPE).reshape(len(charges),
                                                       chinfo.qnumber),
                      inner_qconj)
    Q = Array([a.legs[0], leg_R.conj()], a.dtype, qtotal_Q,
              [a._labels[0], inner_labels[0]])
    R = Array([leg_R, a.legs[1]], a.dtype, qtotal_R,
              [inner_labels[1], a._labels[1]])
    Q._set_blocks(np.array([(int(r[0]), i) for i, r in enumerate(rows)],
                           QTYPE).reshape(len(rows), 2), q_blocks)
    R._set_blocks(np.array([(i, int(r[1])) for i, r in enumerate(rows)],
                           QTYPE).reshape(len(rows), 2), r_blocks)
    return Q, R


def lq(a, inner_labels=(None, None), pos_diag_L=False, qtotal_L=None,
       inner_qconj=-1):
    """Blockwise LQ: ``a = L @ Q`` with Q right-isometric; ``qtotal_L``
    (default zero) is the total charge of L, Q carries the rest."""
    qt, rt = qr(a.transpose([1, 0]),
                inner_labels=[inner_labels[1], inner_labels[0]],
                pos_diag_R=pos_diag_L,
                qtotal_Q=None if qtotal_L is None else a.chinfo.make_valid(
                    np.array(a.qtotal, QTYPE) - np.array(qtotal_L, QTYPE)),
                inner_qconj=-inner_qconj)
    return rt.transpose([1, 0]), qt.transpose([1, 0])


def orthogonal_columns(a, new_label=None):
    """Columns spanning the orthogonal complement of the (isometric)
    columns of a 2-leg ``a``: per sector of leg 0, the last columns of the
    complete QR of its block (of its blocks side by side), or the identity
    where ``a`` holds no block.  The new leg 1 has the charges that make
    the result's total charge ``a.qtotal``; sectors ``a`` fills completely
    are left out."""
    if a.rank != 2:
        raise ValueError("need 2-leg array")
    chinfo = a.chinfo
    leg0 = a.legs[0]
    by_row = defaultdict(list)
    for row, block in zip(a._qdata, a._data):
        by_row[int(row[0])].append(block)
    rows, blocks, charges, sizes = [], [], [], []
    for qi in range(leg0.block_number):
        m = int(leg0.slices[qi + 1] - leg0.slices[qi])
        if qi in by_row:
            blk = torch.cat(by_row[qi], dim=1)
            n = blk.shape[1]
            if n >= m:
                continue
            q_full, _ = torch.linalg.qr(blk, mode='complete')
            comp = q_full[:, n:]
        else:
            comp = torch.eye(m, dtype=a.dtype)
        rows.append(qi)
        blocks.append(comp.contiguous())
        q_row = leg0.charges[qi] * leg0.qconj
        charges.append(chinfo.make_valid(q_row - np.array(a.qtotal, QTYPE)))
        sizes.append(comp.shape[1])
    leg_new = LegCharge(chinfo, np.concatenate([[0], np.cumsum(sizes)]),
                        np.array(charges, QTYPE).reshape(len(charges),
                                                         chinfo.qnumber),
                        +1).conj()
    res = Array([leg0, leg_new], a.dtype, a.qtotal,
                [a._labels[0], new_label])
    res._set_blocks(np.array([(r, i) for i, r in enumerate(rows)],
                             QTYPE).reshape(len(rows), 2), blocks)
    return res
