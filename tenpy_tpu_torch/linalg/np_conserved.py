r"""Charge-conserving block-sparse host tensors: :class:`Array` and friends.

Port of ``tenpy_tpu/linalg/np_conserved.py``: construction (from dense
arrays, functions, grids of arrays, ``zeros``/``ones``/``diag``, the
detection of a missing leg's charges), indexing (``a[i, :, mask, ...]``,
``take_slice``, ``get_block``/``set_block``), leg permutations and sorts,
combining and splitting legs, blockwise arithmetic, the charge mappings,
and the decompositions (``svd`` guarded by
:mod:`~tenpy_tpu_torch.linalg.svd_robust`, ``qr``/``lq`` with ``mode`` and
``cutoff``, ``eigh``/``eig``, ``speigs``, ``pinv``, ``polar``, ``expm``,
``orthogonal_columns``).  An :class:`Array` holds its charge structure
(legs, ``qtotal``, labels, the block rows ``_qdata``) in numpy and one CPU
``torch`` tensor per stored charge block in ``_data``.  It is also what
:func:`~tenpy_tpu_torch.linalg.packed.pack` takes and
:func:`~tenpy_tpu_torch.linalg.packed.unpack` returns.

:func:`tensordot` matches the charge blocks by a cached plan of GEMM
tasks.  A plan of more than ``NATIVE_MIN_TASKS`` float64 or complex128
tasks runs in the C++ executor of :mod:`tenpy_tpu_torch.native` (torch's
own BLAS, one call per task, no Python per task); a smaller plan, or one
of another type, runs the per-task ``torch.matmul`` loop, which is the
executor's plain version.  The sweeps themselves run on the packed
layout, never here.
"""

from __future__ import annotations

import itertools
import warnings
from collections import defaultdict

import numpy as np
import torch

from .charges import QTYPE, ChargeInfo, LegCharge, LegPipe
from . import svd_robust

__all__ = ['Array', 'zeros', 'ones', 'eye_like', 'diag', 'outer', 'inner',
           'tensordot', 'grid_outer', 'grid_concat', 'norm', 'trace', 'svd',
           'pinv', 'qr', 'lq', 'orthogonal_columns', 'polar', 'eigh', 'eig',
           'eigvalsh', 'eigvals', 'speigs', 'expm', 'concatenate',
           'detect_qtotal', 'detect_legcharge', 'detect_grid_outer_legcharge',
           'conj_label', 'as_dtype', 'result_type']

# tensordot plans of more tasks than this run in the C++ executor
NATIVE_MIN_TASKS = 16

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
    def size(self):
        return int(np.prod(self.shape))

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

    def get_leg_indices(self, labels):
        return [self.get_leg_index(l) for l in labels]

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

    def set_leg_labels(self, labels):
        return self.copy(deep=False).iset_leg_labels(labels)

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

    def idrop_labels(self, old=None):
        """Set the labels ``old`` (default: every label) to None."""
        if old is None:
            self._labels = (None,) * self.rank
        else:
            lab = list(self._labels)
            for o in old:
                lab[self.get_leg_index(o)] = None
            self._labels = tuple(lab)
        return self

    # ----------------------------------------------------------- construction
    @classmethod
    def from_ndarray_trivial(cls, data_flat, dtype=None, labels=None):
        """Dense array -> Array with trivial (chargeless) legs: one block."""
        data_flat = _as_block(data_flat, dtype)
        chinfo = ChargeInfo.trivial()
        legs = [LegCharge.from_trivial(d, chinfo) for d in data_flat.shape]
        res = cls(legs, data_flat.dtype, None, labels)
        return res._set_blocks(np.zeros((1, len(legs)), QTYPE), [data_flat])

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

    # -------------------------------------------------------- block access
    def get_block(self, qindices, insert_zeros=False):
        """The block of the sector indices ``qindices``; where none is
        stored, zeros with ``insert_zeros``, else None."""
        row = np.asarray(qindices, QTYPE)
        idx = self._find_block(row)
        if idx is not None:
            return self._data[idx]
        if insert_zeros:
            return torch.zeros(_block_shape(self.legs, row), dtype=self.dtype)
        return None

    def _find_block(self, row):
        """The position of ``row`` in the lexsorted ``_qdata`` or None."""
        q = self._qdata
        lo, hi = 0, len(q)
        target = tuple(int(x) for x in row)
        while lo < hi:
            mid = (lo + hi) // 2
            r = tuple(int(x) for x in q[mid])
            if r < target:
                lo = mid + 1
            elif r > target:
                hi = mid
            else:
                return mid
        return None

    def set_block(self, qindices, block):
        """Insert or overwrite the block of ``qindices`` (which must obey
        the charge rule)."""
        row = np.asarray(qindices, QTYPE)
        if tuple(_row_qtotal(self.legs, row)) != self.qtotal:
            raise ValueError("block violates charge rule")
        block = _as_block(block, self.dtype)
        if tuple(block.shape) != _block_shape(self.legs, row):
            raise ValueError(f"block shape {tuple(block.shape)} != "
                             f"{_block_shape(self.legs, row)}")
        idx = self._find_block(row)
        if idx is not None:
            self._data[idx] = block
        else:
            self._set_blocks(np.concatenate([self._qdata, row[None, :]]),
                             self._data + [block])
        return self

    def __getitem__(self, inds):
        """``a[i, j, ...]``: with every index an int, the element (a 0-dim
        tensor); else ints fix legs (:meth:`take_slice`), and slices and
        boolean masks project legs (:meth:`iproject`); ``...`` stands for
        the legs not named."""
        inds = self._expand_ellipsis(inds)
        if all(isinstance(i, (int, np.integer)) for i in inds):
            row, within = [], []
            for l, i in zip(self.legs, inds):
                qi, r = l.get_qindex(int(i))
                row.append(qi)
                within.append(r)
            blk = self.get_block(row)
            if blk is None:
                return torch.zeros((), dtype=self.dtype)
            return blk[tuple(within)]
        fix_axes, fix_inds, proj_axes, proj_masks = [], [], [], []
        for a, (l, i) in enumerate(zip(self.legs, inds)):
            if isinstance(i, (int, np.integer)):
                fix_axes.append(a)
                fix_inds.append(int(i))
            elif isinstance(i, slice):
                if i != slice(None):
                    mask = np.zeros(l.ind_len, bool)
                    mask[i] = True
                    proj_axes.append(a)
                    proj_masks.append(mask)
            elif isinstance(i, np.ndarray) and i.dtype == bool:
                proj_axes.append(a)
                proj_masks.append(i)
            else:
                raise IndexError(f"unsupported index {i!r}")
        res = self
        if proj_axes:
            res = res.copy(deep=False).iproject(proj_masks, proj_axes)
        if fix_axes:
            res = res.take_slice(fix_inds, fix_axes)
        return res

    def _expand_ellipsis(self, inds):
        if not isinstance(inds, tuple):
            inds = (inds,)
        if any(i is Ellipsis for i in inds):
            k = next(k for k, i in enumerate(inds) if i is Ellipsis)
            fill = self.rank - (len(inds) - 1)
            inds = inds[:k] + (slice(None),) * fill + inds[k + 1:]
        if len(inds) < self.rank:
            inds = inds + (slice(None),) * (self.rank - len(inds))
        if len(inds) != self.rank:
            raise IndexError(f"too many indices for rank-{self.rank} Array")
        return inds

    def __setitem__(self, inds, value):
        """``a[i, j, ...] = v`` for one element (every index an int).  An
        element outside the stored blocks starts its block; one that
        violates the charge rule raises unless ``v`` is zero."""
        inds = self._expand_ellipsis(inds)
        if not all(isinstance(i, (int, np.integer)) for i in inds):
            raise NotImplementedError(
                "only full integer indexing is supported for __setitem__")
        row, within = [], []
        for l, i in zip(self.legs, inds):
            qi, r = l.get_qindex(int(i))
            row.append(qi)
            within.append(r)
        row = np.asarray(row, QTYPE)
        idx = self._find_block(row)
        if idx is None:
            if tuple(_row_qtotal(self.legs, row)) != self.qtotal:
                if value == 0:
                    return
                raise ValueError("can't set nonzero element: "
                                 "block violates the charge rule")
            blk = torch.zeros(_block_shape(self.legs, row), dtype=self.dtype)
            blk[tuple(within)] = value
            self.set_block(row, blk)
            return
        blk = self._data[idx].clone()      # blocks may be shared by copies
        blk[tuple(within)] = value
        self._data[idx] = blk

    def take_slice(self, indices, axes):
        """Fix ``indices`` on the legs ``axes``: the array of the other
        legs, like ``a[:, i, j, :]``; ``qtotal`` loses the charge of every
        fixed index."""
        if not isinstance(axes, (list, tuple)):
            axes = [axes]
        if not isinstance(indices, (list, tuple, np.ndarray)):
            indices = [indices]
        axes = [self.get_leg_index(a) if isinstance(a, str) else int(a)
                for a in axes]
        indices = [int(i) for i in indices]
        if len(axes) != len(indices):
            raise ValueError("len(axes) != len(indices)")
        if len(axes) == 0:
            return self.copy(deep=True)
        if self.rank == len(axes):
            raise ValueError("cannot fix every leg; use a[i, j, ...] instead")
        pos = {a: self.legs[a].get_qindex(i) for a, i in zip(axes, indices)}
        keep_axes = [a for a in range(self.rank) if a not in pos]
        qtotal = np.asarray(self.qtotal, QTYPE).copy()
        for a, (qi, _) in pos.items():
            qtotal -= np.asarray(self.legs[a].get_charge(qi), QTYPE)
        res = Array([self.legs[a] for a in keep_axes], self.dtype,
                    self.chinfo.make_valid(qtotal),
                    [self._labels[a] for a in keep_axes])
        sel = np.ones(len(self._qdata), bool)
        for a, (qi, _) in pos.items():
            sel &= self._qdata[:, a] == qi
        sl = tuple(pos[a][1] if a in pos else slice(None)
                   for a in range(self.rank))
        qdata = self._qdata[np.ix_(sel, np.asarray(keep_axes, np.intp))]
        return res._set_blocks(qdata, [blk[sl] for blk, k
                                       in zip(self._data, sel) if k])

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
        for l in self.legs:
            l.test_sanity()
        for row, block in zip(self._qdata, self._data):
            assert tuple(_row_qtotal(self.legs, row)) == self.qtotal
            assert tuple(block.shape) == _block_shape(self.legs, row)
        rows = [tuple(r) for r in self._qdata]
        assert rows == sorted(rows) and len(set(rows)) == len(rows)

    def sparse_stats(self):
        """The fill of the array, as text."""
        stored = sum(int(np.prod(b.shape)) for b in self._data)
        return (f"{self.stored_blocks} blocks, {stored}/{self.size} entries "
                f"({100.0 * stored / max(self.size, 1):.1f}% filled)")

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

    def permute(self, perm, axis):
        """Any permutation of the indices of leg ``axis``: ``res[i, ...] =
        self[perm[i], ...]``.  It mixes charge sectors, so every block is
        built again row by row (for small legs); the new leg is bunched.
        :meth:`sort_legcharge` takes it for a leg's sort."""
        ax = self.get_leg_index(axis)
        perm = np.asarray(perm, np.intp)
        oldleg = self.legs[ax]
        if len(perm) != oldleg.ind_len or \
                not np.array_equal(np.sort(perm), np.arange(oldleg.ind_len)):
            raise ValueError("not a permutation of the leg's indices")
        _, newleg = LegCharge.from_qflat(self.chinfo, oldleg.to_qflat()[perm],
                                         oldleg.qconj).bunch()
        old_slices = np.asarray(oldleg.slices, np.intp)
        src_qi = np.searchsorted(old_slices, perm, side='right') - 1
        src_off = perm - old_slices[src_qi]
        by_old_qi = defaultdict(list)     # old sector on ax -> block indices
        for d, row in enumerate(self._qdata):
            by_old_qi[int(row[ax])].append(d)
        new_blocks = {}                   # new row -> block, ax moved first
        new_slices = np.asarray(newleg.slices, np.intp)
        for ni in range(newleg.block_number):
            beg, end = int(new_slices[ni]), int(new_slices[ni + 1])
            qis, offs = src_qi[beg:end], src_off[beg:end]
            for qi in np.unique(qis):
                rows = np.nonzero(qis == qi)[0]
                for d in by_old_qi.get(int(qi), ()):
                    key = tuple(ni if x == ax else int(r)
                                for x, r in enumerate(self._qdata[d]))
                    src = self._data[d].movedim(ax, 0)
                    blk = new_blocks.get(key)
                    if blk is None:
                        blk = new_blocks[key] = torch.zeros(
                            (end - beg,) + tuple(src.shape[1:]),
                            dtype=self.dtype)
                    blk[torch.from_numpy(rows)] = \
                        src[torch.from_numpy(offs[rows])].to(self.dtype)
        res = self.copy(deep=False)
        res.legs = self.legs[:ax] + (newleg,) + self.legs[ax + 1:]
        rows = sorted(new_blocks)
        return res._set_blocks(
            np.array(rows, QTYPE).reshape(len(rows), self.rank),
            [new_blocks[r].movedim(0, ax) for r in rows])

    def sort_legcharge(self, sort=True, bunch=True):
        """Sort and bunch the sectors of every leg: ``(perms, res)`` with
        ``res[i0, i1, ...] = self[perms[0][i0], perms[1][i1], ...]``.
        ``sort`` is one bool, or one entry per leg (a bool or a flat
        permutation to apply); ``bunch`` one bool or one per leg.  A leg
        with ``sort=False`` and ``bunch=True`` is still bunched; a leg given
        a permutation is always bunched (:meth:`permute`)."""
        sort = [sort] * self.rank if isinstance(sort, (bool, np.bool_)) \
            else list(sort)
        bunch = [bunch] * self.rank if isinstance(bunch, (bool, np.bool_)) \
            else list(bunch)
        if len(sort) != self.rank or len(bunch) != self.rank:
            raise ValueError("wrong len for sort or bunch")
        res = self.copy(deep=False)
        perms = []
        for ax in range(self.rank):
            leg = res.legs[ax]
            s = bool(sort[ax]) if isinstance(sort[ax], np.bool_) else sort[ax]
            if not isinstance(s, bool):
                perm_flat = np.asarray(s, np.intp)
                perms.append(perm_flat)
                res = res.permute(perm_flat, ax)
                continue
            if s and leg.block_number > 1:
                perm_flat, _ = leg.sort(bunch=bool(bunch[ax]))
            else:
                perm_flat = np.arange(leg.ind_len)
            perms.append(perm_flat)
            needs_bunch = (bool(bunch[ax]) and leg.block_number > 1
                           and leg.bunch()[1].block_number
                           != leg.block_number)
            if not np.array_equal(perm_flat, np.arange(leg.ind_len)) \
                    or needs_bunch:
                res = res.permute(perm_flat, ax)
        return perms, res

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

    def complex_conj(self):
        """The blocks conjugated; legs, charges and labels kept."""
        res = self.copy(deep=False)
        if self.dtype.is_complex:
            res._data = [b.conj() for b in res._data]
        return res

    @property
    def real(self):
        res = self.copy(deep=False)
        res._data = [b.real for b in res._data]
        res.dtype = self.dtype.to_real()
        return res

    @property
    def imag(self):
        res = self.copy(deep=False)
        res._data = [b.imag if b.is_complex() else torch.zeros_like(b)
                     for b in res._data]
        res.dtype = self.dtype.to_real()
        return res

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

    def iscale_prefactor(self, c):
        c = _scalar(c)
        self._data = [b * c for b in self._data]
        self.dtype = _scalar_dtype(self.dtype, c)
        return self

    def iadd_prefactor_other(self, alpha, other):
        """``self += alpha * other``, in place."""
        res = self._binary(other * alpha, lambda a, b: a + b)
        self.legs, self.qtotal = res.legs, res.qtotal
        self._qdata, self._data, self.dtype = res._qdata, res._data, res.dtype
        return self

    def unary_blockwise(self, func):
        """A copy with ``func`` applied to every block."""
        return self.copy(deep=False).iunary_blockwise(func)

    def iunary_blockwise(self, func):
        self._data = [func(b) for b in self._data]
        if self._data:
            self.dtype = self._data[0].dtype
        return self

    def binary_blockwise(self, func, other):
        """``func(a_block, other_block)`` over the union of stored blocks
        (a missing block is zeros)."""
        return self._binary(other, func)

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

    # ---------------------------------------------------- charge mappings
    def add_charge(self, add_legs, chinfo=None, qtotal=None):
        """The array with further charges on every leg: ``add_legs`` holds
        one leg per axis with the new charges (same lengths and qconj);
        the legs are neither sorted nor bunched."""
        add_legs = list(add_legs)
        if len(add_legs) != self.rank:
            raise ValueError("wrong number of add_legs")
        legs = [LegCharge.from_add_charge([l, l2], chinfo)
                for l, l2 in zip(self.legs, add_legs)]
        dense = self.to_ndarray()
        if qtotal is None:
            qtotal_new = detect_qtotal(dense, legs)
        else:
            qtotal_new = legs[0].chinfo.make_valid(np.concatenate(
                [np.asarray(self.qtotal, QTYPE),
                 np.asarray(qtotal, QTYPE).ravel()]))
        return Array.from_ndarray(dense, legs, dtype=self.dtype,
                                  qtotal=qtotal_new,
                                  labels=list(self.get_leg_labels()),
                                  raise_wrong_sector=True)

    def drop_charge(self, charge=None, chinfo=None):
        """The array without the charge ``charge`` (index or name; None:
        without every charge); one dropped charge keeps the blocks."""
        if charge is None:
            legs = [LegCharge.from_drop_charge(l, None, chinfo)
                    for l in self.legs]
            return Array.from_ndarray(self.to_ndarray(), legs,
                                      dtype=self.dtype,
                                      labels=list(self.get_leg_labels()))
        if isinstance(charge, str):
            charge = self.chinfo.names.index(charge)
        legs = [LegCharge.from_drop_charge(l, charge, chinfo)
                for l in self.legs]
        res = Array(legs, self.dtype,
                    np.delete(np.asarray(self.qtotal, QTYPE), charge, 0),
                    list(self.get_leg_labels()))
        return res._set_blocks(self._qdata.copy(), list(self._data))

    def change_charge(self, charge, new_qmod, new_name='', chinfo=None):
        """The array with the modulus of one charge changed (the same
        blocks)."""
        legs = [LegCharge.from_change_charge(l, charge, new_qmod, new_name,
                                             chinfo) for l in self.legs]
        res = Array(legs, self.dtype, legs[0].chinfo.make_valid(
            np.asarray(self.qtotal, QTYPE)), list(self.get_leg_labels()))
        return res._set_blocks(self._qdata.copy(), list(self._data))

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

    def __array__(self, dtype=None, copy=None):
        arr = self.to_numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def make_pipe(self, axes, qconj=1):
        """The :class:`LegPipe` of the legs ``axes``."""
        return LegPipe([self.legs[self.get_leg_index(a)] for a in axes],
                       qconj=qconj)

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

    def add_trivial_leg(self, axis=0, label=None, qconj=1):
        """A new leg of length 1 and zero charge at ``axis``."""
        legs = list(self.legs)
        legs.insert(axis, LegCharge.from_trivial(1, self.chinfo, qconj))
        labels = list(self._labels)
        labels.insert(axis, label)
        res = Array(legs, self.dtype, self.qtotal, labels)
        return res._set_blocks(np.insert(self._qdata, axis, 0, axis=1),
                               [b.unsqueeze(axis) for b in self._data])

    def item(self):
        """The one entry of an array whose legs all have length 1."""
        if any(l.ind_len != 1 for l in self.legs):
            raise ValueError("not a scalar")
        if self._data:
            return self._data[0].reshape(())
        return torch.zeros((), dtype=self.dtype)

    def as_completely_blocked(self):
        """Every leg sorted and bunched, so that each charge sector appears
        once: ``(perms, res)``, ``perms[a]`` the flat permutation applied to
        leg ``a`` (``self`` itself where every leg already is)."""
        perms, legs_new, need = [], [], False
        for leg in self.legs:
            if leg.is_sorted() and leg.is_bunched():
                perms.append(np.arange(leg.ind_len, dtype=np.intp))
                legs_new.append(leg)
            else:
                p, leg2 = leg.sort(bunch=True)
                perms.append(np.asarray(p, dtype=np.intp))
                legs_new.append(leg2)
                need = True
        if not need:
            return perms, self
        arr = self.to_ndarray()
        for ax, p in enumerate(perms):
            arr = arr.index_select(ax, torch.from_numpy(p))
        res = Array.from_ndarray(arr, legs_new, dtype=self.dtype,
                                 qtotal=self.qtotal)
        res.iset_leg_labels(self.get_leg_labels())
        return perms, res

    def ipurge_zeros(self, cutoff=1e-15, norm_order=None):
        """Drop the blocks whose largest entry is at or below ``cutoff``."""
        keep = [i for i, b in enumerate(self._data)
                if b.numel() and float(b.abs().max()) > cutoff]
        return self._set_blocks(self._qdata[keep],
                                [self._data[i] for i in keep])


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


def ones(legcharges, dtype=torch.float64, qtotal=None, labels=None):
    """Every charge-allowed block filled with ones."""
    return Array.from_func(np.ones, legcharges, dtype, qtotal, labels=labels)


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


def _host_numpy(x):
    """A numpy array of a tensor (on the host, conjugation resolved) or of
    anything numpy takes."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().numpy()
    return np.asarray(x)


def detect_legcharge(flat_array, chinfo, legcharges, qtotal=None, qconj=+1,
                     cutoff=None):
    """The charges of the one leg given as None in ``legcharges``, from the
    entries of a dense array above ``cutoff`` (default 1e-12 of its
    largest): each index of that leg takes the charge that its first
    nonzero entry needs for the total charge ``qtotal``; an index without
    one takes charge 0."""
    flat = _host_numpy(flat_array)
    if cutoff is None:
        cutoff = 1e-12 * max(float(np.max(np.abs(flat))), 1e-300)
    legs = list(legcharges)
    ax = legs.index(None)
    qtotal = np.asarray(chinfo.make_valid(qtotal), QTYPE)
    qflat = np.zeros((flat.shape[ax], chinfo.qnumber), QTYPE)
    moved = np.moveaxis(flat, ax, 0)
    other = [l for k, l in enumerate(legs) if k != ax]
    for i in range(flat.shape[ax]):
        nz = np.nonzero(np.abs(moved[i]) > cutoff)
        if len(nz[0]) == 0:
            continue
        q = np.zeros(chinfo.qnumber, QTYPE)
        for l, p in zip(other, [n[0] for n in nz]):
            qi, _ = l.get_qindex(int(p))
            q += l.charges[qi] * l.qconj
        qflat[i] = chinfo.make_valid((qtotal - q) * qconj)
    return LegCharge.from_qflat(chinfo, qflat, qconj)


def _object_grid(grid, ndim):
    """A nested list (or object array) of entries as an object array of
    ``ndim`` dimensions, the entries untouched (``np.asarray`` would turn
    equal-shaped Arrays into arrays of their entries)."""
    if isinstance(grid, np.ndarray) and grid.dtype == object \
            and grid.ndim == ndim:
        return grid
    shape, g = [], grid
    for _ in range(ndim):
        shape.append(len(g))
        g = g[0]
    res = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        e = grid
        for i in idx:
            e = e[i]
        res[idx] = e
    return res


def detect_grid_outer_legcharge(grid, grid_legs, qtotal=None, qconj=1,
                                bunch=False):
    """``grid_legs`` with its one None entry replaced by the leg that
    :func:`grid_outer` needs for the total charge ``qtotal`` (default 0),
    from the entries of the grid; raises where two entries disagree."""
    grid = _object_grid(grid, len(grid_legs))
    chinfo = next((e.chinfo for e in grid.ravel() if e is not None), None)
    if chinfo is None:
        raise ValueError("empty grid")
    qtotal = np.asarray(chinfo.make_valid(qtotal), QTYPE)
    legs = list(grid_legs)
    ax = legs.index(None)
    qflat = np.zeros((grid.shape[ax], chinfo.qnumber), QTYPE)
    found = np.zeros(grid.shape[ax], bool)
    for idx in np.ndindex(*grid.shape):
        entry = grid[idx]
        if entry is None:
            continue
        q = qtotal.copy()
        for k, (l, i) in enumerate(zip(legs, idx)):
            if k != ax:
                qi, _ = l.get_qindex(int(i))
                q = q - l.charges[qi] * l.qconj
        q = q - np.asarray(entry.qtotal, QTYPE)
        i = idx[ax]
        qv = chinfo.make_valid(chinfo.make_valid(q) * qconj)
        if found[i] and not np.array_equal(qflat[i], qv):
            raise ValueError("inconsistent grid charges")
        qflat[i] = qv
        found[i] = True
    leg = LegCharge.from_qflat(chinfo, qflat, qconj)
    return [leg if k == ax else l for k, l in enumerate(legs)]


# ---------------------------------------------------------------- tensordot
class _Plan:
    """A tensordot's block structure: ``out_rows``, ``out_shapes`` and
    ``tasks`` (``(i, j, out_index, m, k, n)`` in execution order), with
    the executor's task arrays made once (:meth:`native_tables`)."""
    __slots__ = ('out_rows', 'out_shapes', 'tasks', '_native')

    def __init__(self, out_rows, out_shapes, tasks):
        self.out_rows, self.out_shapes, self.tasks = out_rows, out_shapes, tasks
        self._native = None

    def native_tables(self):
        """``(ti, tj, out_offsets, dims, first, out_sizes)``: the operand
        blocks of each task, the offset of its output block in one flat
        buffer, its ``(m, k, n)``, whether it writes (1) or adds (0), and
        the entries of each output block."""
        if self._native is None:
            t = np.asarray(self.tasks, np.int64).reshape(len(self.tasks), 6)
            sizes = np.array([int(np.prod(sh)) for sh in self.out_shapes],
                             np.int64)
            offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            first = np.zeros(len(t), np.uint8)
            first[np.unique(t[:, 2], return_index=True)[1]] = 1
            self._native = (t[:, 0].copy(), t[:, 1].copy(), offs[t[:, 2]],
                            np.ascontiguousarray(t[:, 3:], np.int32), first,
                            sizes.tolist())
        return self._native


_TD_PLAN_CACHE = {}


def _struct_sig(a):
    return (a.legs, a.qtotal, a._qdata.tobytes(), a._qdata.shape)


def _tensordot_plan(a, b, n_axes):
    """The :class:`_Plan` of ``a``'s last ``n_axes`` legs with ``b``'s
    first; its ``tasks`` list ``(i, j, out_index, m, k, n)``.

    The pairs are made in the order of a loop over ``a``'s contracted
    sectors (in the order they first occur in ``a``), ``a``'s rows and
    ``b``'s rows, vectorized; the output rows are numbered in that order
    and the tasks then stably sorted by GEMM shape (as ``tenpy_tpu``'s
    host path runs them: the same order gives the same sums)."""
    key = (_struct_sig(a), _struct_sig(b), n_axes)
    plan = _TD_PLAN_CACHE.get(key)
    if plan is not None:
        return plan
    ka = a.rank - n_axes
    A, B = a._qdata, b._qdata
    free = a.legs[:ka] + b.legs[n_axes:]
    _, ids = np.unique(np.concatenate([A[:, ka:], B[:, :n_axes]]), axis=0,
                       return_inverse=True)
    ids = ids.reshape(-1)
    id_a, id_b = ids[:len(A)], ids[len(A):]
    # a's rows in loop order: by the first occurrence of their sector
    first = np.full(ids.max(initial=-1) + 1, len(A), np.int64)
    np.minimum.at(first, id_a, np.arange(len(A)))
    order_a = np.lexsort((np.arange(len(A)), first[id_a]))
    order_b = np.argsort(id_b, kind='stable')
    lo = np.searchsorted(id_b[order_b], id_a[order_a], 'left')
    hi = np.searchsorted(id_b[order_b], id_a[order_a], 'right')
    counts = hi - lo
    ti = np.repeat(order_a, counts)
    starts = np.repeat(lo - np.concatenate([[0], np.cumsum(counts)[:-1]]),
                       counts)
    tj = order_b[np.arange(len(ti)) + starts]
    m = _block_sizes(a.legs[:ka], A[:, :ka])[ti]
    k = _block_sizes(a.legs[ka:], A[:, ka:])[ti]
    n = _block_sizes(b.legs[n_axes:], B[:, n_axes:])[tj]
    rows = np.concatenate([A[ti, :ka], B[tj, n_axes:]], axis=1)
    if len(rows):
        uniq, first_pos, inv = np.unique(rows, axis=0, return_index=True,
                                         return_inverse=True)
        rank = np.empty(len(uniq), np.int64)
        rank[np.argsort(first_pos, kind='stable')] = np.arange(len(uniq))
        oi = rank[inv.reshape(-1)]
        out_rows = np.ascontiguousarray(uniq[np.argsort(first_pos,
                                                         kind='stable')],
                                        QTYPE)
    else:
        oi = np.zeros(0, np.int64)
        out_rows = np.zeros((0, len(free)), QTYPE)
    sizes = np.stack([l.sector_sizes()[out_rows[:, x]]
                      for x, l in enumerate(free)], axis=1) \
        if len(out_rows) and free else np.zeros((len(out_rows), len(free)),
                                                np.int64)
    out_shapes = [tuple(r) for r in sizes.tolist()]
    perm = np.lexsort((n, k, m))
    tasks = np.stack([ti, tj, oi, m, k, n], axis=1)[perm].tolist()
    plan = _Plan(out_rows, out_shapes, tasks)
    if len(_TD_PLAN_CACHE) > 4096:
        _TD_PLAN_CACHE.clear()
    _TD_PLAN_CACHE[key] = plan
    return plan


def _block_sizes(legs, rows):
    """The number of entries of each row's block on ``legs``."""
    size = np.ones(len(rows), np.int64)
    for x, l in enumerate(legs):
        size *= l.sector_sizes()[rows[:, x]]
    return size


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
    plan = _tensordot_plan(at, bt, n_axes)
    a_data = [x if x.dtype == dtype else x.to(dtype) for x in at._data]
    b_data = [x if x.dtype == dtype else x.to(dtype) for x in bt._data]
    run = _run_native if len(plan.tasks) > NATIVE_MIN_TASKS \
        and dtype in (torch.float64, torch.complex128) else _run_loop
    res._set_blocks(plan.out_rows, run(plan, a_data, b_data, dtype))
    return res


def _run_loop(plan, a_data, b_data, dtype):
    """The plan's output blocks, one ``torch.matmul``/``addmm_`` per task
    (the plain version of :func:`_run_native`)."""
    a_mats, b_mats = {}, {}      # each block as its matrix, made once
    partial = [None] * len(plan.out_shapes)
    for i, j, oi, m, k, n in plan.tasks:
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
    return [p.reshape(s) for p, s in zip(partial, plan.out_shapes)]


def _dense(x):
    """``x`` contiguous in memory, with no pending conjugation or
    negation."""
    if x.is_conj() or x.is_neg():
        x = x.resolve_conj().resolve_neg()
    return x.contiguous()


def _run_native(plan, a_data, b_data, dtype):
    """The plan's output blocks from the C++ executor
    (:mod:`tenpy_tpu_torch.native`): views into one new flat buffer."""
    from .. import native
    ti, tj, offs, dims, first, sizes = plan.native_tables()
    a_data = [_dense(x) for x in a_data]
    b_data = [_dense(x) for x in b_data]
    a_ptr = np.fromiter((x.data_ptr() for x in a_data), np.int64,
                        len(a_data))
    b_ptr = np.fromiter((x.data_ptr() for x in b_data), np.int64,
                        len(b_data))
    out = torch.empty(sum(sizes), dtype=dtype)
    native.run_tasks(dtype, a_ptr[ti], b_ptr[tj],
                     out.data_ptr() + offs * out.element_size(), dims, first)
    return [p.view(s) for p, s in zip(torch.split(out, sizes),
                                      plan.out_shapes)]


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


def grid_concat(grid, axes, copy=True):
    """Concatenate a (nested) grid of arrays along the legs ``axes``, one
    per grid dimension (:func:`concatenate`, innermost first); ``copy`` is
    accepted for the reference's signature (blocks are always new)."""
    grid = _object_grid(grid, len(axes))
    if grid.ndim == 1:
        if any(g is None for g in grid):
            raise ValueError("grid_concat with None entries needs full grid")
        return concatenate(list(grid), axes[0])
    return concatenate([grid_concat(grid[i], axes[1:], copy)
                        for i in range(grid.shape[0])], axes[0])


def grid_outer(grid, grid_legs, qtotal=None, grid_labels=None):
    """Sum of outer products ``res[i, j, ...] += grid[i][j]`` over a grid of
    arrays (``None`` entries are zero); the MPO builder's W tensors.  One
    None entry of ``grid_legs`` is detected
    (:func:`detect_grid_outer_legcharge`)."""
    grid = _object_grid(grid, len(grid_legs))
    if any(l is None for l in grid_legs):
        grid_legs = detect_grid_outer_legcharge(grid, grid_legs, qtotal)
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
    splits ``a``'s charge between U and VH (default all on VH).  Each
    component's SVD is
    :func:`~tenpy_tpu_torch.linalg.svd_robust.svd` (gesdd, retried with
    gesvd where it fails)."""
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
        u, s, vh = svd_robust.svd(sub, full_matrices=False)
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

    def union(x, y):
        rx, ry = find(x), find(y)
        if rx != ry:
            parent[rx] = ry

    for row in a._qdata:
        r, c = ('r', int(row[0])), ('c', int(row[1]))
        parent.setdefault(r, r)
        parent.setdefault(c, c)
        union(r, c)
    comps = {}
    for bi, row in enumerate(a._qdata):
        comp = comps.setdefault(find(('r', int(row[0]))), [set(), set(), []])
        comp[0].add(int(row[0]))
        comp[1].add(int(row[1]))
        comp[2].append(bi)
    return [(sorted(rows), sorted(cols), idxs)
            for rows, cols, idxs in comps.values()]


def speigs(a, charge_sector, k, *args, **kwargs):
    """The ``k`` eigenpairs of largest magnitude of a square 2-leg Array in
    one charge sector of leg 0 (scipy's ARPACK ``eigs`` on a
    :class:`~tenpy_tpu_torch.linalg.sparse.FlatLinearOperator`; a sector
    of at most ``max(k + 1, 3)`` entries densely): ``(W, vecs)`` with
    ``vecs`` one-leg Arrays."""
    import scipy.sparse.linalg
    from .sparse import FlatLinearOperator
    if a.rank != 2:
        raise ValueError("speigs needs a square 2-leg Array")
    linop = FlatLinearOperator.from_NpcArray(a, charge_sector=charge_sector)
    n = linop.shape[0]
    k = min(k, n - 2) if n > 2 else 1
    if n <= max(k + 1, 3):
        mat = np.stack([linop._matvec(np.eye(n)[:, j]) for j in range(n)], 1)
        W, V = np.linalg.eig(mat)
        order = np.argsort(-np.abs(W))[:k]
        return W[order], [linop.flat_to_npc(V[:, j]) for j in order]
    W, V = scipy.sparse.linalg.eigs(linop, k=k, *args, **kwargs)
    return W, [linop.flat_to_npc(V[:, j]) for j in range(V.shape[1])]


def pinv(a, cutoff=1e-15):
    """The Moore-Penrose pseudo-inverse of a 2-leg Array, blockwise from
    :func:`svd`: singular values at or below ``cutoff`` times the largest
    count as zero."""
    U, S, VH = svd(a)
    Sinv = np.where(S > cutoff * np.max(S), 1. / np.where(S > 0, S, 1.), 0.)
    X = VH.conj().itranspose([1, 0]).iscale_axis(Sinv, 1)
    return tensordot(X, U.conj().itranspose([1, 0]), axes=[[1], [0]])


def eigh(a, UPLO='L', sort=None):
    """Blockwise hermitian eigendecomposition of a square 2-leg Array of
    zero charge: ``(W, V)`` with ``W`` a numpy vector along leg 0 and ``V``
    an Array with legs ``[a.legs[0], a.legs[0].conj()]``; a sector without
    a stored block has ``W = 0`` and ``V = 1``.  Each sector's eigenvalues
    are ascending, or in the order ``sort`` ('m>', 'm<', '>', '<', as
    ``tenpy_tpu``'s numpy argsort).  ``UPLO`` is accepted for the API and,
    as in ``tenpy_tpu``, not used: the whole block is read."""
    return _eig_worker(True, a, sort)


def eig(a, sort=None):
    """Blockwise general eigendecomposition (``torch.linalg.eig``) of a
    square 2-leg Array of zero charge: as :func:`eigh`, with complex
    eigenvalues and eigenvectors (in no order without ``sort``)."""
    return _eig_worker(False, a, sort)


def eigvalsh(a, UPLO='L', sort=None):
    """The eigenvalues of a hermitian square 2-leg Array of zero charge, a
    numpy vector along leg 0 (zeros in sectors without a stored block),
    ascending per sector or in the order ``sort`` (as :func:`eigh`)."""
    return _eigvals_worker(True, a, sort)


def eigvals(a, sort=None):
    """The (complex) eigenvalues of a square 2-leg Array of zero charge, as
    :func:`eigvalsh`."""
    return _eigvals_worker(False, a, sort)


def _check_square(a):
    if a.rank != 2:
        raise ValueError("need 2-leg array")
    a.legs[0].test_contractible(a.legs[1])
    if any(q != 0 for q in a.qtotal):
        raise ValueError("eigh/eig require qtotal=0")


def _eig_worker(hermitian, a, sort):
    _check_square(a)
    leg = a.legs[0]
    W = np.zeros(leg.ind_len, np.float64 if hermitian else np.complex128)
    vdtype = a.dtype if hermitian else torch.promote_types(a.dtype,
                                                           torch.complex64)
    V = diag(1., leg, dtype=vdtype)
    v_rows = {tuple(r): i for i, r in enumerate(V._qdata)}
    for row, block in zip(a._qdata, a._data):
        if row[0] != row[1]:
            raise ValueError("off-diagonal block in eigh")
        w, v = torch.linalg.eigh(block) if hermitian \
            else torch.linalg.eig(block)
        w = w.numpy()
        if sort is not None:
            perm = _eig_sort_perm(w, sort)
            w = w[perm]
            v = v[:, torch.from_numpy(perm)]
        W[leg.get_slice(int(row[0]))] = w
        V._data[v_rows[(int(row[0]), int(row[0]))]] = v.to(vdtype)
    return W, V


def _eigvals_worker(hermitian, a, sort):
    _check_square(a)
    leg = a.legs[0]
    W = np.zeros(leg.ind_len, np.float64 if hermitian else np.complex128)
    for row, block in zip(a._qdata, a._data):
        w = (torch.linalg.eigvalsh(block) if hermitian
             else torch.linalg.eigvals(block)).numpy()
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


def qr(a, mode='reduced', inner_labels=(None, None), cutoff=None,
       pos_diag_R=False, qtotal_Q=None, inner_qconj=+1):
    """Blockwise QR of a 2-leg Array: ``a = Q @ R``, each block's reduced
    QR, or its complete QR with ``mode='complete'``; ``qtotal_Q`` (default
    zero) is the total charge of Q, R carries the rest.  ``pos_diag_R``
    makes R's diagonal real and non-negative; with ``cutoff`` the columns
    of Q (rows of R) whose diagonal entry of R is at or below it in
    magnitude are dropped, and a block that keeps none leaves no sector."""
    if a.rank != 2:
        raise ValueError("qr needs a 2-leg array")
    chinfo = a.chinfo
    qtotal_Q = chinfo.make_valid(qtotal_Q)
    qtotal_R = chinfo.make_valid(np.array(a.qtotal, QTYPE) - qtotal_Q)
    rows, q_blocks, r_blocks, charges, sizes = [], [], [], [], []
    for row, block in zip(a._qdata, a._data):
        q, r = torch.linalg.qr(block, mode='complete' if mode == 'complete'
                               else 'reduced')
        if pos_diag_R:
            d = torch.diagonal(r)
            big = d.abs() > 1e-300
            phase = torch.where(big, d / torch.where(big, d.abs(),
                                                     torch.ones_like(d.abs())),
                                torch.ones_like(d))
            q = q * phase[None, :]
            r = r * phase.conj()[:, None]
        if cutoff is not None:
            keep = torch.diagonal(r).abs() > cutoff
            if not bool(keep.all()):
                idx = torch.nonzero(keep).reshape(-1)
                q, r = q[:, idx], r[idx, :]
            if q.shape[1] == 0:
                continue
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


def lq(a, mode='reduced', inner_labels=(None, None), cutoff=None,
       pos_diag_L=False, qtotal_L=None, inner_qconj=-1):
    """Blockwise LQ: ``a = L @ Q`` with Q right-isometric, the :func:`qr`
    of the transpose (``mode`` and ``cutoff`` as there); ``qtotal_L``
    (default zero) is the total charge of L, Q carries the rest."""
    qt, rt = qr(a.transpose([1, 0]), mode=mode,
                inner_labels=[inner_labels[1], inner_labels[0]],
                cutoff=cutoff,
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
