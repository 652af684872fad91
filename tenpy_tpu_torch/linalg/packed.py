r"""Bucket-packed block storage: the device-resident tensor format.

Port of ``tenpy_tpu/linalg/packed.py``.  A :class:`PackedArray` groups all
charge blocks of one (size-bucketed, see :mod:`.padding`) shape into ONE
stacked tensor ``(N_blocks_of_shape, *shape)``, so a :func:`tensordot` is one
call of :func:`~.grouped_gemm.packed_contract` (one launch of the
hand-written CUDA kernel on the card): every block product of every bucket
pair, summed per output row and written into the output buckets.  The
charge matching is a host-side plan, cached per structure, with its index
tables cached per device.

Exactness: padding rows/columns are zero, so products, inner products, norms
and linear combinations are exact; structures are kept *complete* (every
charge-allowed block present, zeros included), so every Lanczos vector of an
update shares one layout.

Data types: float64, float32 and complex128.  Complex data is stored
natively (no split re/im channels): a tensordot of a real and a complex
operand promotes the real one to complex128, and the kernel's complex128
mode computes it.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

from .charges import QTYPE
from .grouped_gemm import build_tables, packed_contract, shape_class
from .np_conserved import Array, conj_label
from .padding import pad_leg

__all__ = ['PackedArray', 'pack', 'unpack', 'tensordot', 'inner', 'vdot',
           'inner_re', 'norm', 'norm_sq', 'complete_structure', 'matmul_mode',
           'FlopRecorder', 'flop_record', 'checked_device']

_TORCH_DTYPE = {np.dtype(np.float64): torch.float64,
                np.dtype(np.float32): torch.float32,
                np.dtype(np.complex128): torch.complex128}
_DTYPES = tuple(_TORCH_DTYPE.values())


def checked_device(device):
    """``torch.device(device)``; raises for a CUDA device when PyTorch sees
    none (there is no fallback to the CPU: pass ``device='cpu'`` for it)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested, but no CUDA device "
                           f"is available; pass device='cpu' to run on the "
                           f"CPU")
    return device


def _torch_dtype(dtype):
    """The PackedArray dtype of a host array's torch or numpy dtype."""
    if not isinstance(dtype, torch.dtype):
        dtype = _TORCH_DTYPE.get(np.dtype(dtype))
    if dtype not in _DTYPES:
        raise TypeError(f"unsupported PackedArray dtype {dtype}")
    return dtype


class PackedArray:
    """Charge-blocked tensor with shape-bucketed stacked storage.

    Attributes
    ----------
    legs : tuple of LegCharge
        (Padded) legs.
    qtotal : tuple of int
    shapes : tuple of tuple
        The distinct block shapes, sorted.
    qdatas : tuple of np.ndarray
        ``qdatas[s]`` has shape ``(N_s, rank)``: the charge-sector rows of the
        blocks stacked in ``data[s]`` (row-lexsorted, read-only).
    data : list of torch.Tensor
        ``data[s].shape == (N_s,) + shapes[s]``.
    dtype : torch.dtype
    device : torch.device
        Where ``data`` lives; an array without blocks keeps the device it
        was built for (``device`` is then required).
    """

    __slots__ = ('legs', 'qtotal', '_labels', 'shapes', 'qdatas', 'data',
                 'dtype', 'device', '_sig')

    def __init__(self, legs, qtotal, labels, shapes, qdatas, data, dtype,
                 device=None):
        self.legs = tuple(legs)
        self.qtotal = tuple(int(q) for q in np.asarray(qtotal).ravel())
        self._labels = tuple(labels)
        self.shapes = tuple(tuple(int(x) for x in s) for s in shapes)
        self.qdatas = tuple(qdatas)
        self.data = list(data)
        self.dtype = dtype
        if self.data:
            self.device = self.data[0].device
        elif device is None:
            raise ValueError("a PackedArray without blocks needs its device")
        else:
            self.device = torch.device(device)
        self._sig = None

    @property
    def rank(self):
        return len(self.legs)

    @property
    def n_blocks(self):
        return sum(q.shape[0] for q in self.qdatas)

    def get_leg_labels(self):
        return list(self._labels)

    def get_leg_index(self, label):
        if isinstance(label, (int, np.integer)):
            return int(label)
        return self._labels.index(label)

    def struct_sig(self):
        """Hashable signature of the static structure (for plan caches)."""
        if self._sig is None:
            self._sig = (self.legs, self.qtotal, self.shapes,
                         tuple(q.tobytes() for q in self.qdatas),
                         tuple(q.shape for q in self.qdatas))
        return self._sig

    def _like(self, data, labels=None):
        res = PackedArray(self.legs, self.qtotal,
                          self._labels if labels is None else labels,
                          self.shapes, self.qdatas, data,
                          data[0].dtype if data else self.dtype, self.device)
        res._sig = self._sig
        return res

    # ------------------------------------------------------------ label ops
    def replace_labels(self, old, new):
        mapping = dict(zip(old, new))
        return self._like(self.data,
                          tuple(mapping.get(l, l) for l in self._labels))

    def transpose(self, perm):
        """New PackedArray with permuted legs; `perm` indices or labels."""
        perm = tuple(self.get_leg_index(p) for p in perm)
        if perm == tuple(range(self.rank)):
            return self
        tp = _transpose_plan(self.struct_sig(), self.shapes, self.qdatas, perm)
        dperm = [0] + [1 + i for i in perm]
        data = []
        for srcs, order in tp.parts:
            parts = [self.data[s].permute(dperm) for s in srcs]
            ds = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
            if order is not None:
                ds = ds[tp.on(self.device, order)]
            data.append(ds.contiguous())
        legs = [self.legs[i] for i in perm]
        labels = tuple(self._labels[i] for i in perm)
        return PackedArray(legs, self.qtotal, labels, tp.shapes, tp.qdatas,
                           data, self.dtype, self.device)

    def conj(self):
        """Complex conjugate: flips leg qconj, star-flips labels and, for
        complex data, conjugates the entries (a new buffer each, not a
        lazy conjugate view: the kernel reads the memory)."""
        chinfo = self.legs[0].chinfo
        qtotal = chinfo.make_valid(-np.asarray(self.qtotal, QTYPE))
        data = ([d.conj_physical() for d in self.data]
                if self.dtype.is_complex else self.data)
        return PackedArray([l.conj() for l in self.legs], qtotal,
                           [conj_label(l) for l in self._labels], self.shapes,
                           self.qdatas, data, self.dtype, self.device)

    # ----------------------------------------------------------- arithmetic
    def _same_struct(self, other):
        return (self.legs == other.legs and self.qtotal == other.qtotal
                and self.shapes == other.shapes
                and all(np.array_equal(p, q)
                        for p, q in zip(self.qdatas, other.qdatas)))

    def __add__(self, other):
        if not isinstance(other, PackedArray):
            return NotImplemented
        if not self._same_struct(other):
            raise ValueError("PackedArray structure mismatch")
        return self._like([x + y for x, y in zip(self.data, other.data)])

    def __sub__(self, other):
        if not isinstance(other, PackedArray):
            return NotImplemented
        if not self._same_struct(other):
            raise ValueError("PackedArray structure mismatch")
        return self._like([x - y for x, y in zip(self.data, other.data)])

    def __mul__(self, scalar):
        return self._like([d * scalar for d in self.data])

    __rmul__ = __mul__


class _TransposePlan:
    """Merge/sort schedule of a leg permutation (depends on qdata only)."""
    __slots__ = ('shapes', 'qdatas', 'parts', '_dev')

    def __init__(self, shapes, qdatas, parts):
        self.shapes, self.qdatas, self.parts = shapes, qdatas, parts
        self._dev = {}

    def on(self, device, order):
        key = (device, id(order))
        t = self._dev.get(key)
        if t is None:
            t = torch.from_numpy(order).to(device)
            self._dev[key] = t
        return t


_TRANSPOSE_CACHE = {}


def _transpose_plan(sig, shapes, qdatas, perm):
    key = (sig, perm)
    tp = _TRANSPOSE_CACHE.get(key)
    if tp is not None:
        return tp
    merged = {}
    for s, (shape, q) in enumerate(zip(shapes, qdatas)):
        new_shape = tuple(shape[i] for i in perm)
        merged.setdefault(new_shape, []).append(
            (np.ascontiguousarray(q[:, perm]), s))
    new_shapes, new_qdatas, parts = [], [], []
    for shape in sorted(merged):
        qs = np.concatenate([x[0] for x in merged[shape]], axis=0)
        order = np.lexsort(qs.T[::-1])
        if np.array_equal(order, np.arange(len(order))):
            order = None
        else:
            qs = qs[order]
        qs.setflags(write=False)
        new_shapes.append(shape)
        new_qdatas.append(qs)
        parts.append(([s for _, s in merged[shape]], order))
    tp = _TransposePlan(tuple(new_shapes), tuple(new_qdatas), parts)
    _cache_put(_TRANSPOSE_CACHE, key, tp, 2048)
    return tp


def _cache_put(cache, key, value, limit):
    if len(cache) > limit:
        # drop the older half (insertion order): a wholesale clear would
        # thrash structures still in use
        for k_old in list(cache)[:limit // 2]:
            del cache[k_old]
    cache[key] = value


# ------------------------------------------------------------------ structure
@lru_cache(maxsize=512)
def complete_structure(legs, qtotal):
    """All charge-allowed qdata rows for `legs`/`qtotal`, grouped by shape.

    Returns ``(shapes, qdatas)`` with shapes sorted and rows lexsorted."""
    chinfo = legs[0].chinfo
    rank = len(legs)
    # meet-in-the-middle: the sector combinations of each half with their
    # charges, matched by charge (vectorized over the combinations)
    kL = max(1, rank // 2)
    rows_L, q_L = _half_combinations(legs[:kL], chinfo)
    rows_R, q_R = _half_combinations(legs[kL:], chinfo)
    need = chinfo.make_valid(np.asarray(qtotal, QTYPE) - q_R)
    _, ids = np.unique(np.concatenate([q_L, need]), axis=0,
                       return_inverse=True)
    ids = ids.reshape(-1)
    id_L, id_R = ids[:len(q_L)], ids[len(q_L):]
    order_L = np.argsort(id_L, kind='stable')
    lo = np.searchsorted(id_L[order_L], id_R, 'left')
    hi = np.searchsorted(id_L[order_L], id_R, 'right')
    counts = hi - lo
    r_idx = np.repeat(np.arange(len(id_R)), counts)
    starts = np.repeat(lo - np.concatenate([[0], np.cumsum(counts)[:-1]]),
                       counts)
    l_idx = order_L[np.arange(len(r_idx)) + starts]
    full = np.concatenate([rows_L[l_idx], rows_R[r_idx]], axis=1)
    sizes = np.stack([l.sector_sizes()[full[:, k]]
                      for k, l in enumerate(legs)], axis=1) if len(full) \
        else np.zeros((0, rank), QTYPE)
    # shapes sorted, and the rows of each shape lexsorted
    order = np.lexsort(tuple(full[:, k] for k in reversed(range(rank)))
                       + tuple(sizes[:, k] for k in reversed(range(rank))))
    full, sizes = full[order], sizes[order]
    bounds = np.flatnonzero(np.any(sizes[1:] != sizes[:-1], axis=1)) + 1
    bounds = np.concatenate([[0], bounds, [len(full)]]) if len(full) \
        else np.zeros(1, np.int64)
    shapes, qdatas = [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        shapes.append(tuple(int(x) for x in sizes[a]))
        q = np.ascontiguousarray(full[a:b], QTYPE)
        q.setflags(write=False)
        qdatas.append(q)
    return tuple(shapes), tuple(qdatas)


def _half_combinations(legs, chinfo):
    """Every combination of the legs' sectors (C order) and its charge."""
    n = [l.block_number for l in legs]
    rows = np.stack([g.ravel() for g in np.meshgrid(
        *[np.arange(k) for k in n], indexing='ij')], axis=1).astype(QTYPE) \
        if legs else np.zeros((1, 0), QTYPE)
    q = np.zeros((len(rows), chinfo.qnumber), QTYPE)
    for k, l in enumerate(legs):
        q += np.asarray(l.charges, QTYPE)[rows[:, k]] * l.qconj
    return rows, chinfo.make_valid(q)


def pack(a, multiple=64, pad=True, pad_labels=None, device='cuda'):
    """Host :class:`~.np_conserved.Array` -> :class:`PackedArray` on
    ``device``.

    With ``pad``, every leg's sector sizes are rounded up to bucket sizes
    (zero padding); ``pad_labels`` restricts padding to the given leg labels.
    Every charge-allowed block is present (zeros where ``a`` stores none).
    The buckets are filled on the host and moved with one copy each.
    ``device`` defaults to the card and raises where there is none.
    """
    device = checked_device(device)
    dtype = _torch_dtype(a.dtype)
    if pad:
        legs = tuple(leg if pad_labels is not None and lbl not in pad_labels
                     else pad_leg(leg, multiple)[0]
                     for leg, lbl in zip(a.legs, a.get_leg_labels()))
    else:
        legs = tuple(a.legs)
    qtotal = tuple(int(q) for q in np.asarray(a.qtotal).ravel())
    shapes, qdatas = complete_structure(legs, qtotal)
    pos = {}
    for s, q in enumerate(qdatas):
        for i, row in enumerate(q):
            pos[tuple(int(x) for x in row)] = (s, i)
    bufs = [torch.zeros((q.shape[0],) + shape, dtype=dtype)
            for shape, q in zip(shapes, qdatas)]
    for row, block in zip(a._qdata, a._data):
        key = tuple(int(x) for x in row)
        if key not in pos:
            raise ValueError("stored block not charge-allowed?")
        s, i = pos[key]
        block = torch.as_tensor(block)
        bufs[s][(i,) + tuple(slice(0, d) for d in block.shape)] = block
    data = [b.to(device) for b in bufs]
    return PackedArray(legs, qtotal, tuple(a.get_leg_labels()), shapes,
                       qdatas, data, dtype, device)


def unpack(p, orig_legs=None):
    """PackedArray -> host :class:`~.np_conserved.Array`, slicing padding
    away and dropping all-zero blocks.

    ``orig_legs``: the unpadded legs (in p's current leg order); default:
    keep the padded legs."""
    legs = tuple(orig_legs) if orig_legs is not None else p.legs
    res = Array(legs, p.dtype, p.qtotal, p.get_leg_labels())
    host_data = [d.detach().cpu() for d in p.data]
    rows, blocks = [], []
    for q, d in zip(p.qdatas, host_data):
        for i, row in enumerate(q):
            orig_shape = tuple(int(l.slices[s + 1] - l.slices[s])
                               for l, s in zip(legs, row))
            blk = d[(i,) + tuple(slice(0, n) for n in orig_shape)]
            if not bool(blk.any()):
                continue
            rows.append(row)
            blocks.append(blk.contiguous())
    res._set_blocks(np.array(rows, QTYPE).reshape(len(rows), p.rank), blocks)
    return res


# ----------------------------------------------------------- FLOPs and mode
_FLOPS = threading.local()


class FlopRecorder:
    """Accumulates the GEMM FLOPs executed inside :func:`flop_record`."""
    __slots__ = ('flops',)

    def __init__(self):
        self.flops = 0


@contextmanager
def flop_record(rec):
    """Count the bucket-GEMM FLOPs of every :func:`tensordot` run inside the
    region into ``rec.flops`` (``2 m k n`` per GEMM entry, as
    ``tenpy_tpu``'s counter).  Regions nest: an outer recorder also counts
    the inner region's FLOPs."""
    stack = getattr(_FLOPS, 'stack', None)
    if stack is None:
        stack = _FLOPS.stack = []
    stack.append(rec)
    try:
        yield rec
    finally:
        stack.pop()


def _count_flops(n):
    for rec in getattr(_FLOPS, 'stack', ()):
        rec.flops += n


_MATMUL_MODE = None


@contextmanager
def matmul_mode(mode):
    """Run f64 bucket GEMMs in reduced precision inside the context.

    ``'f32'``: the kernel reads the f64 operands, multiplies and sums in
    float32 (FFMA, no TF32) and writes f64.  ``None``: native f64.
    ``'bf16'`` is not ported.
    """
    global _MATMUL_MODE
    if mode not in (None, 'f32'):
        raise NotImplementedError(f"matmul_mode {mode!r} is not ported")
    old = _MATMUL_MODE
    _MATMUL_MODE = mode
    try:
        yield
    finally:
        _MATMUL_MODE = old


# ----------------------------------------------------------------- tensordot
class _PackedPlan:
    """Host plan of one packed tensordot structure.

    ``host_tables`` are the kernel's :class:`~.grouped_gemm.Tables`
    (:func:`~.grouped_gemm.build_tables`, on the host): output bucket ``so``
    holds ``out_dims[so][0]`` blocks, each read as ``m x n`` (``m`` over the
    kept legs of ``a``, ``n`` over those of ``b``); ``flops`` is
    ``2 m k n`` summed over the block products."""
    __slots__ = ('out_legs', 'out_qtotal', 'out_shapes', 'out_qdatas',
                 'host_tables', 'flops', '_dev')

    def __init__(self, out_legs, out_qtotal, out_shapes, out_qdatas,
                 host_tables, flops):
        self.out_legs = out_legs
        self.out_qtotal = out_qtotal
        self.out_shapes = out_shapes
        self.out_qdatas = out_qdatas
        self.host_tables = host_tables
        self.flops = flops
        self._dev = {}

    @property
    def out_dims(self):
        return self.host_tables.out_dims

    def tables(self, device):
        """The tables on ``device`` (uploaded once, cached)."""
        t = self._dev.get(device)
        if t is None:
            t = self._dev[device] = self.host_tables.to(device)
        return t


_PACKED_PLAN_CACHE = {}


def _packed_plan(a, b, n_axes):
    key = (a.struct_sig(), b.struct_sig(), n_axes)
    plan = _PACKED_PLAN_CACHE.get(key)
    if plan is not None:
        return plan
    ka = a.rank - n_axes
    chinfo = a.legs[0].chinfo
    out_legs = a.legs[:ka] + b.legs[n_axes:]
    out_qtotal = tuple(int(x) for x in chinfo.make_valid(
        np.asarray(a.qtotal, QTYPE) + np.asarray(b.qtotal, QTYPE)))
    out_shapes, out_qdatas = complete_structure(out_legs, out_qtotal)
    # every (a row, b row) pair of matching contracted sectors, in the order
    # of a's buckets and rows, then b's buckets and rows (vectorized)
    rows_a, sa, ia = _bucket_rows(a.qdatas, a.rank)
    rows_b, sb, jb = _bucket_rows(b.qdatas, b.rank)
    _, ids = np.unique(np.concatenate([rows_a[:, ka:], rows_b[:, :n_axes]]),
                       axis=0, return_inverse=True)
    ids = ids.reshape(-1)
    id_a, id_b = ids[:len(rows_a)], ids[len(rows_a):]
    order_b = np.argsort(id_b, kind='stable')
    lo = np.searchsorted(id_b[order_b], id_a, 'left')
    counts = np.searchsorted(id_b[order_b], id_a, 'right') - lo
    ta = np.repeat(np.arange(len(rows_a)), counts)
    starts = np.repeat(lo - np.concatenate([[0], np.cumsum(counts)[:-1]]),
                       counts)
    tb = order_b[np.arange(len(ta)) + starts]
    # each pair's output row: its bucket and index there
    rows_o, so_all, oi_all = _bucket_rows(out_qdatas, len(out_legs))
    pair_rows = np.concatenate([rows_a[ta, :ka], rows_b[tb, n_axes:]],
                               axis=1)
    _, ids = np.unique(np.concatenate([rows_o, pair_rows]), axis=0,
                       return_inverse=True)
    ids = ids.reshape(-1)
    where = np.full(ids.max(initial=-1) + 1, -1, np.int64)
    where[ids[:len(rows_o)]] = np.arange(len(rows_o))
    pos = where[ids[len(rows_o):]]
    if np.any(pos < 0):
        raise AssertionError("packed plan: output row not in the structure")
    so, oi = so_all[pos], oi_all[pos]
    # grouped by bucket pair and output bucket, pairs in order within each
    perm = np.lexsort((np.arange(len(ta)), so, sb[tb], sa[ta]))
    ta, tb, so, oi = ta[perm], tb[perm], so[perm], oi[perm]
    out_dims = [(q.shape[0], int(np.prod(shape[:ka], dtype=np.int64)),
                 int(np.prod(shape[ka:], dtype=np.int64)))
                for shape, q in zip(out_shapes, out_qdatas)]
    k_of = np.array([int(np.prod(shape[ka:], dtype=np.int64))
                     for shape in a.shapes], np.int64)
    kk = k_of[sa[ta]]
    k_min = [np.inf] * len(out_dims)
    for s_o, k in zip(so.tolist(), kk.tolist()):
        if k < k_min[s_o]:
            k_min[s_o] = k
    m_of = np.array([m for _, m, _ in out_dims], np.int64)
    n_of = np.array([n for _, _, n in out_dims], np.int64)
    flops = int(np.sum(2 * m_of[so] * kk * n_of[so]))
    cols = torch.from_numpy(np.stack([so, oi, sa[ta], ia[ta], sb[tb], jb[tb],
                                      kk]).astype(np.int64))
    classes = [shape_class(m, n, km) for (_, m, n), km in zip(out_dims,
                                                              k_min)]
    plan = _PackedPlan(out_legs, out_qtotal, out_shapes, out_qdatas,
                       build_tables(out_dims, classes, *cols), flops)
    _cache_put(_PACKED_PLAN_CACHE, key, plan, 2048)
    return plan


def _bucket_rows(qdatas, rank):
    """The rows of all buckets stacked, with each row's bucket and its
    index in the bucket."""
    if not qdatas:
        z = np.zeros(0, np.int64)
        return np.zeros((0, rank), QTYPE), z, z
    rows = np.concatenate([np.asarray(q, QTYPE).reshape(-1, rank)
                           for q in qdatas])
    bucket = np.concatenate([np.full(len(q), s, np.int64)
                             for s, q in enumerate(qdatas)])
    index = np.concatenate([np.arange(len(q), dtype=np.int64)
                            for q in qdatas])
    return rows, bucket, index


def tensordot(a, b, axes):
    """Packed tensordot; ``axes=(labels_a, labels_b)`` or int.

    One call of :func:`~.grouped_gemm.packed_contract` (one kernel launch on
    the card) computes every output bucket.
    """
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
    perm_a = [i for i in range(a.rank) if i not in axes_a] + list(axes_a)
    perm_b = list(axes_b) + [i for i in range(b.rank) if i not in axes_b]
    at = a.transpose(perm_a)
    bt = b.transpose(perm_b)
    ka = a.rank - n_axes
    for la, lb in zip(at.legs[ka:], bt.legs[:n_axes]):
        la.test_contractible(lb)
    plan = _packed_plan(at, bt, n_axes)
    dtype = torch.promote_types(at.dtype, bt.dtype)
    device = at.device
    if _MATMUL_MODE == 'f32' and dtype.is_complex:
        raise NotImplementedError("matmul_mode('f32') on complex data (a "
                                  "complex64 product mode) is not ported")
    compute = (torch.float32 if _MATMUL_MODE == 'f32'
               and dtype == torch.float64 else dtype)
    if at.data and bt.data:
        outs = packed_contract(
            [d.to(dtype).contiguous() for d in at.data],
            [d.to(dtype).contiguous() for d in bt.data],
            plan.tables(device), compute)
    else:
        outs = [torch.zeros(d, dtype=dtype, device=device)
                for d in plan.out_dims]
    _count_flops(plan.flops)
    out = [o.reshape((o.shape[0],) + shape)
           for o, shape in zip(outs, plan.out_shapes)]
    labels = tuple(at._labels[:ka]) + tuple(bt._labels[n_axes:])
    return PackedArray(plan.out_legs, plan.out_qtotal, labels,
                       plan.out_shapes, plan.out_qdatas, out, dtype, device)


# ------------------------------------------------------------ inner products
def _check_layout(a, b):
    if a.shapes != b.shapes or not all(
            np.array_equal(p, q) for p, q in zip(a.qdatas, b.qdatas)):
        raise ValueError("inner: block layout mismatch")


def _dot(a, b, conj_a=False):
    """``sum(a * b)``, or ``sum(conj(a) * b)`` with ``conj_a``, over the
    buckets; a real operand meeting a complex one is promoted."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    dot = torch.vdot if conj_a and dtype.is_complex else torch.dot
    total = torch.zeros((), dtype=dtype, device=a.device)
    for x, y in zip(a.data, b.data):
        total = total + dot(x.reshape(-1).to(dtype), y.reshape(-1).to(dtype))
    return total


def inner(a, b):
    """Full contraction ``<a, b> = sum(a * b)`` (0-dim tensor, complex for
    complex data), legs paired in order, with no implicit conjugation.

    Requires matching block layouts, e.g. ``inner(v.conj(), w)`` with
    ``v, w`` from the same contraction plan."""
    for la, lb in zip(a.legs, b.legs):
        la.test_contractible(lb)
    _check_layout(a, b)
    return _dot(a, b)


def vdot(a, b):
    """``<a|b> = sum(conj(a) * b)`` (0-dim tensor, complex for complex
    data); ``a`` is conjugated here, so it is passed unconjugated."""
    for la, lb in zip(a.legs, b.legs):
        la.conj().test_contractible(lb)
    _check_layout(a, b)
    return _dot(a, b, conj_a=True)


def inner_re(a, b):
    """``Re <a|b> = Re sum(conj(a) * b)`` (real 0-dim tensor); ``a`` is
    conjugated here, so it is passed unconjugated."""
    return vdot(a, b).real


def norm_sq(a):
    """Squared Frobenius norm (real 0-dim tensor)."""
    return _dot(a, a, conj_a=True).real


def norm(a):
    """Frobenius norm (real 0-dim tensor)."""
    return torch.sqrt(norm_sq(a))
