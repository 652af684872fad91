r"""Bucket-packed block storage: the device-resident tensor format.

Port of ``tenpy_tpu/linalg/packed.py``.  A :class:`PackedArray` groups all
charge blocks of one (size-bucketed, see :mod:`.padding`) shape into ONE
stacked tensor ``(N_blocks_of_shape, *shape)``, so a :func:`tensordot` is one
fused gather -> grouped GEMM -> segment-sum call per (shape_a, shape_b)
bucket pair (:func:`~.grouped_gemm.grouped_gemm_segsum`: the hand-written
CUDA kernel on the card) plus one gather-sum per output bucket.  The charge
matching is a host-side plan, cached per structure, with its index tables
cached per device.

Exactness: padding rows/columns are zero, so products, inner products, norms
and linear combinations are exact; structures are kept *complete* (every
charge-allowed block present, zeros included), so every Lanczos vector of an
update shares one layout.

Real tensors only (float64, or float32); a complex array raises
``NotImplementedError``.
"""

from __future__ import annotations

import itertools
import threading
from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

from .charges import QTYPE
from .grouped_gemm import grouped_gemm_segsum
from .host_array import HostArray, conj_label
from .padding import pad_leg

__all__ = ['PackedArray', 'pack', 'unpack', 'tensordot', 'inner', 'inner_re',
           'norm', 'complete_structure', 'matmul_mode', 'FlopRecorder',
           'flop_record']

_TORCH_DTYPE = {np.dtype(np.float64): torch.float64,
                np.dtype(np.float32): torch.float32}


def _torch_dtype(np_dtype):
    np_dtype = np.dtype(np_dtype)
    if np_dtype.kind == 'c':
        raise NotImplementedError("complex PackedArray: native complex128 "
                                  "is not ported yet")
    try:
        return _TORCH_DTYPE[np_dtype]
    except KeyError:
        raise TypeError(f"unsupported PackedArray dtype {np_dtype}") from None


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
    """

    __slots__ = ('legs', 'qtotal', '_labels', 'shapes', 'qdatas', 'data',
                 'dtype', '_sig')

    def __init__(self, legs, qtotal, labels, shapes, qdatas, data, dtype):
        self.legs = tuple(legs)
        self.qtotal = tuple(int(q) for q in np.asarray(qtotal).ravel())
        self._labels = tuple(labels)
        self.shapes = tuple(tuple(int(x) for x in s) for s in shapes)
        self.qdatas = tuple(qdatas)
        self.data = list(data)
        self.dtype = dtype
        self._sig = None

    @property
    def rank(self):
        return len(self.legs)

    @property
    def n_blocks(self):
        return sum(q.shape[0] for q in self.qdatas)

    @property
    def device(self):
        return self.data[0].device if self.data else torch.device('cpu')

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
                          data[0].dtype if data else self.dtype)
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
                           data, self.dtype)

    def conj(self):
        """Complex conjugate (real data: flips leg qconj, star-flips labels)."""
        chinfo = self.legs[0].chinfo
        qtotal = chinfo.make_valid(-np.asarray(self.qtotal, QTYPE))
        return PackedArray([l.conj() for l in self.legs], qtotal,
                           [conj_label(l) for l in self._labels], self.shapes,
                           self.qdatas, self.data, self.dtype)

    # ----------------------------------------------------------- arithmetic
    def _same_struct(self, other):
        return (self.legs == other.legs and self.qtotal == other.qtotal
                and self.shapes == other.shapes
                and all(np.array_equal(p, q)
                        for p, q in zip(self.qdatas, other.qdatas)))

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
    qtotal = np.asarray(qtotal, QTYPE)
    rank = len(legs)
    # meet-in-the-middle: enumerate left/right halves and match partial sums
    kL = max(1, rank // 2)
    left = {}
    for row in itertools.product(*[range(l.block_number) for l in legs[:kL]]):
        q = np.zeros(chinfo.qnumber, QTYPE)
        for l, s in zip(legs[:kL], row):
            q += np.asarray(l.charges[s], QTYPE) * l.qconj
        left.setdefault(tuple(chinfo.make_valid(q)), []).append(row)
    groups = {}
    for row in itertools.product(*[range(l.block_number) for l in legs[kL:]]):
        q = np.zeros(chinfo.qnumber, QTYPE)
        for l, s in zip(legs[kL:], row):
            q += np.asarray(l.charges[s], QTYPE) * l.qconj
        need = tuple(chinfo.make_valid(qtotal - q))
        for lrow in left.get(need, ()):
            full = lrow + row
            shape = tuple(int(l.slices[s + 1] - l.slices[s])
                          for l, s in zip(legs, full))
            groups.setdefault(shape, []).append(full)
    shapes = tuple(sorted(groups))
    qdatas = []
    for shape in shapes:
        q = np.array(sorted(groups[shape]), QTYPE).reshape(len(groups[shape]),
                                                           rank)
        q.setflags(write=False)
        qdatas.append(q)
    return shapes, tuple(qdatas)


def pack(a, multiple=64, pad=True, pad_labels=None, device='cpu'):
    """:class:`HostArray` -> :class:`PackedArray` on ``device``.

    With ``pad``, every leg's sector sizes are rounded up to bucket sizes
    (zero padding); ``pad_labels`` restricts padding to the given leg labels.
    Every charge-allowed block is present (zeros where ``a`` stores none).
    The buffers are built in numpy and moved with one copy per bucket.
    """
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
    np_dtype = np.dtype(a.dtype)
    bufs = [np.zeros((q.shape[0],) + shape, np_dtype)
            for shape, q in zip(shapes, qdatas)]
    for row, block in zip(a._qdata, a._data):
        key = tuple(int(x) for x in row)
        if key not in pos:
            raise ValueError("stored block not charge-allowed?")
        s, i = pos[key]
        block = np.asarray(block)
        bufs[s][(i,) + tuple(slice(0, d) for d in block.shape)] = block
    data = [torch.from_numpy(b).to(device) for b in bufs]
    return PackedArray(legs, qtotal, tuple(a.get_leg_labels()), shapes,
                       qdatas, data, dtype)


def unpack(p, orig_legs=None):
    """PackedArray -> :class:`HostArray`, slicing padding away and dropping
    all-zero blocks.

    ``orig_legs``: the unpadded legs (in p's current leg order); default:
    keep the padded legs."""
    legs = tuple(orig_legs) if orig_legs is not None else p.legs
    res = HostArray(legs, torch.empty(0, dtype=p.dtype).numpy().dtype,
                    p.qtotal, p.get_leg_labels())
    host_data = [d.detach().cpu().numpy() for d in p.data]
    rows, blocks = [], []
    for q, d in zip(p.qdatas, host_data):
        for i, row in enumerate(q):
            orig_shape = tuple(int(l.slices[s + 1] - l.slices[s])
                               for l, s in zip(legs, row))
            blk = d[(i,) + tuple(slice(0, n) for n in orig_shape)]
            if not np.any(blk):
                continue
            rows.append(row)
            blocks.append(np.ascontiguousarray(blk))
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

    ``'f32'``: the f64 operands are cast to float32, the f32 kernel runs,
    and the segment sums are cast back (the gather-sum across buckets stays
    f64).  ``None``: native f64.  ``'bf16'`` is not ported.
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

    ``groups[g] = (sa, sb, so, (m, k, n), a_pos, b_pos, o_uniq, o_inv)``:
    GEMM entry ``t`` of bucket pair ``g`` multiplies block ``a_pos[t]`` of
    bucket ``sa`` with block ``b_pos[t]`` of bucket ``sb`` into row
    ``o_uniq[o_inv[t]]`` of output bucket ``so``.  ``assembly[so]`` is the
    gather-sum recipe ``(idx, identity)`` that builds output bucket ``so``
    from the concatenated segment sums of its groups (or None)."""
    __slots__ = ('out_legs', 'out_qtotal', 'out_shapes', 'out_qdatas',
                 'out_sizes', 'groups', 'assembly', '_dev')

    def __init__(self, out_legs, out_qtotal, out_shapes, out_qdatas,
                 out_sizes, groups):
        self.out_legs = out_legs
        self.out_qtotal = out_qtotal
        self.out_shapes = out_shapes
        self.out_qdatas = out_qdatas
        self.out_sizes = out_sizes
        self.groups = groups
        # each group contributes one row per distinct destination (the
        # kernel already summed its entries per segment)
        self.assembly = _plan_assembly(
            out_sizes, [(g[2], g[6]) for g in groups])
        self._dev = {}

    def sorted_entries(self, g_i):
        """CSR ``(seg_ptr, ia, ib)`` int32 arrays of group ``g_i``: its GEMM
        entries sorted by destination segment."""
        _, _, _, _, a_pos, b_pos, o_uniq, o_inv = self.groups[g_i]
        order = np.argsort(o_inv, kind='stable')
        seg_ptr = np.concatenate(
            [[0], np.cumsum(np.bincount(o_inv, minlength=len(o_uniq)))])
        return (seg_ptr.astype(np.int32),
                np.ascontiguousarray(a_pos[order], np.int32),
                np.ascontiguousarray(b_pos[order], np.int32))

    def tables(self, device):
        """Per-device index tensors: ``(entries, assembly)`` (cached)."""
        t = self._dev.get(device)
        if t is None:
            entries = [tuple(torch.from_numpy(x).to(device)
                             for x in self.sorted_entries(g))
                       for g in range(len(self.groups))]
            assembly = [None if r is None else
                        (torch.from_numpy(r[0].astype(np.int64)).to(device),
                         r[1]) for r in self.assembly]
            t = self._dev[device] = (entries, assembly)
        return t


def _plan_assembly(out_sizes, group_rows):
    """Gather-sum recipes: out bucket <- rows of concatenated group results.

    For each out bucket ``so`` the contributing groups' (flattened) results
    are concatenated in group order; ``group_rows[g] = (so, rows)`` says which
    out row each contributed row lands in.  The recipe is ``(idx,
    identity)``: ``idx[r]`` lists the concat positions summed into row ``r``,
    padded with the one-past-end zero-row sentinel.  ``None`` for buckets
    nothing contributes to."""
    per_so = {}
    for so, rows_g in group_rows:
        per_so.setdefault(so, []).append(rows_g)
    assembly = []
    for so, nsz in enumerate(out_sizes):
        ent = per_so.get(so)
        if not ent:
            assembly.append(None)
            continue
        rows = np.concatenate(ent).astype(np.int64)
        n_all = len(rows)
        max_c = int(np.bincount(rows, minlength=nsz).max())
        idx = np.full((nsz, max_c), n_all, np.int32)
        fill = np.zeros(nsz, np.int32)
        for pos, r in enumerate(rows):
            idx[r, fill[r]] = pos
            fill[r] += 1
        identity = (max_c == 1 and n_all == nsz
                    and np.array_equal(idx[:, 0], np.arange(nsz)))
        idx.setflags(write=False)
        assembly.append((idx, identity))
    return assembly


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
    out_pos = {}
    for s, q in enumerate(out_qdatas):
        for i, row in enumerate(q):
            out_pos[tuple(int(x) for x in row)] = (s, i)
    b_by_c = {}
    for sb, q in enumerate(b.qdatas):
        for j, row in enumerate(q):
            b_by_c.setdefault(tuple(row[:n_axes]), []).append((sb, j, row))
    tasks = {}   # (sa, sb, so) -> [(i, j, oi)]
    for sa, qa in enumerate(a.qdatas):
        for i, arow in enumerate(qa):
            for (sb, j, brow) in b_by_c.get(tuple(arow[ka:]), ()):
                so, oi = out_pos[tuple(arow[:ka]) + tuple(brow[n_axes:])]
                tasks.setdefault((sa, sb, so), []).append((i, j, oi))
    groups = []
    for (sa, sb, so), lst in sorted(tasks.items()):
        shape_a, shape_b = a.shapes[sa], b.shapes[sb]
        m = int(np.prod(shape_a[:ka], dtype=np.int64)) if ka else 1
        kk = int(np.prod(shape_a[ka:], dtype=np.int64)) if n_axes else 1
        n = int(np.prod(shape_b[n_axes:], dtype=np.int64)) \
            if b.rank - n_axes else 1
        a_pos = np.array([x[0] for x in lst], np.int32)
        b_pos = np.array([x[1] for x in lst], np.int32)
        o_uniq, o_inv = np.unique(np.array([x[2] for x in lst], np.int32),
                                  return_inverse=True)
        # the kernel reads these without bounds checks
        if a_pos.max() >= a.qdatas[sa].shape[0] or \
                b_pos.max() >= b.qdatas[sb].shape[0]:
            raise AssertionError("packed plan: gather index out of range")
        groups.append((sa, sb, so, (m, kk, n), a_pos, b_pos,
                       o_uniq.astype(np.int32), o_inv.astype(np.int32)))
    plan = _PackedPlan(out_legs, out_qtotal, out_shapes, out_qdatas,
                       tuple(q.shape[0] for q in out_qdatas), groups)
    _cache_put(_PACKED_PLAN_CACHE, key, plan, 2048)
    return plan


def tensordot(a, b, axes):
    """Packed tensordot; ``axes=(labels_a, labels_b)`` or int.

    One fused gather -> grouped GEMM -> segment-sum call per (shape_a,
    shape_b) bucket pair, then one gather-sum per output bucket.
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
    reduced = _MATMUL_MODE == 'f32' and dtype == torch.float64
    gemm_dtype = torch.float32 if reduced else dtype
    entries, assembly = plan.tables(device)
    contrib = {}   # so -> list of (U_g, m*n) segment sums
    for g_i, (sa, sb, so, (m, kk, n), a_pos, _, o_uniq, _) \
            in enumerate(plan.groups):
        seg_ptr, ia, ib = entries[g_i]
        A = at.data[sa].reshape(-1, m, kk).to(gemm_dtype).contiguous()
        B = bt.data[sb].reshape(-1, kk, n).to(gemm_dtype).contiguous()
        c = grouped_gemm_segsum(A, B, seg_ptr, ia, ib, len(o_uniq))
        _count_flops(2 * len(a_pos) * m * kk * n)
        contrib.setdefault(so, []).append(c.to(dtype).reshape(len(o_uniq),
                                                              -1))
    out = []
    for so, (nsz, shape) in enumerate(zip(plan.out_sizes, plan.out_shapes)):
        if assembly[so] is None:
            out.append(torch.zeros((nsz,) + shape, dtype=dtype,
                                   device=device))
            continue
        idx, identity = assembly[so]
        parts = contrib[so]
        all_c = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        if identity:
            res = all_c
        elif idx.shape[1] == 1 and len(all_c) == nsz:
            res = all_c[idx[:, 0]]
        else:
            padded = torch.cat([all_c, all_c.new_zeros((1, all_c.shape[1]))])
            res = padded[idx].sum(dim=1)
        out.append(res.reshape((nsz,) + shape))
    labels = tuple(at._labels[:ka]) + tuple(bt._labels[n_axes:])
    return PackedArray(plan.out_legs, plan.out_qtotal, labels,
                       plan.out_shapes, plan.out_qdatas, out, dtype)


# ------------------------------------------------------------ inner products
def _check_layout(a, b):
    if a.shapes != b.shapes or not all(
            np.array_equal(p, q) for p, q in zip(a.qdatas, b.qdatas)):
        raise ValueError("inner: block layout mismatch")


def _dot(a, b):
    total = torch.zeros((), dtype=torch.promote_types(a.dtype, b.dtype),
                        device=a.device)
    for x, y in zip(a.data, b.data):
        total = total + torch.dot(x.reshape(-1), y.reshape(-1))
    return total


def inner(a, b):
    """Full contraction ``<a, b>`` (0-dim tensor), legs paired in order.

    Requires matching block layouts, e.g. ``inner(v.conj(), w)`` with
    ``v, w`` from the same contraction plan."""
    for la, lb in zip(a.legs, b.legs):
        la.test_contractible(lb)
    _check_layout(a, b)
    return _dot(a, b)


def inner_re(a, b):
    """``Re <a|b>`` with conjugation of ``a`` (real data: ``sum(a * b)``)."""
    for la, lb in zip(a.legs, b.legs):
        la.conj().test_contractible(lb)
    _check_layout(a, b)
    return _dot(a, b)


def norm(a):
    """Frobenius norm (0-dim tensor)."""
    total = torch.zeros((), dtype=a.dtype, device=a.device)
    for x in a.data:
        total = total + torch.dot(x.reshape(-1), x.reshape(-1))
    return torch.sqrt(total)
