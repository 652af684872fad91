r"""The packed contraction kernel: every bucket GEMM of a tensordot in one call.

A packed tensordot multiplies charge blocks stacked in shape buckets.  Its
work is a :class:`Tables` (:func:`build_tables`): per output bucket its
``(rows, m, n)`` and shape class, on the host, and two int32 tables:

- ``entries`` ``(E, 5)``: one row per block product, ``(a bucket, a block,
  b bucket, b block, k)``; the entries of one output row are contiguous;
- ``tasks`` ``(T, 8)``: one row per output tile, ``(class, out bucket, out
  row, origin 0, origin 1, entry begin, entry end, 0)``, sorted by work,
  largest first.

:func:`packed_contract` computes, for every output bucket ``so`` and row
``r``, ``out[so][r] = sum_e a[ab_e][ablk_e] @ b[bb_e][bblk_e]`` over the
entries of that row, across bucket pairs, and writes every row, zeros
included.  On a CUDA tensor it launches one hand-written kernel of
``csrc/packed_contract.cu`` (and counts it in :data:`LAUNCHES`) or raises:
the thin kernel when every task is thin, else the kernel for any tables.
On a CPU tensor it takes the plain version :func:`packed_contract_plain`,
which walks the same two tables with torch ops, so the CPU tests exercise
exactly the tables the kernel reads.

Shape classes, chosen per output bucket (:func:`shape_class`) from its
``(m, n)`` and the smallest ``k`` among its entries: *thin* when
``min(m, n, k) < 8`` (the contractions with an MPO tensor, ``k = n = 1``)
or when no entry reaches the bucket: a task is :data:`THIN_TILE` elements
of an output row; *block* otherwise: a task is a ``WM x WN`` tile of an
output block, each side 8, 16 or 32.

:func:`grouped_gemm_segsum` is the port of ``tenpy_tpu/linalg/
pallas_gemm.py`` (``grouped_gemm_segsum``, ``reference_segsum``): the
one-bucket-pair case of the same tables and kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

__all__ = ['LAUNCHES', 'THIN_TILE', 'MAX_BUCKETS', 'Tables', 'shape_class',
           'class_tile', 'build_tables', 'table_groups', 'packed_contract',
           'packed_contract_plain', 'segsum_tables', 'grouped_gemm_segsum']

# kernel launches so far (one per call that reached the CUDA kernel); a run
# resets it to 0 and reads it to show its main path went through the kernel
LAUNCHES = 0

# the kernel's constants (csrc/packed_contract.cu; checked at first launch)
THIN_TILE = 256
MAX_BUCKETS = 64
TASK_COLS, ENTRY_COLS = 8, 5

_FLOATS = (torch.float32, torch.float64)
_INT_MAX = 2 ** 31 - 1
# kernel mode per (data dtype, compute dtype)
_MODES = {(torch.float64, torch.float64): 0,
          (torch.float32, torch.float32): 1,
          (torch.float64, torch.float32): 2}


def _side(x):
    return 8 if x < 16 else (16 if x < 32 else 32)


class Tables(NamedTuple):
    """The work of one packed contraction: ``out_dims[s] = (rows, m, n)``
    and ``classes[s]`` per output bucket (host values) and the kernel's
    ``tasks`` and ``entries`` tables."""
    out_dims: tuple
    classes: tuple
    tasks: torch.Tensor
    entries: torch.Tensor

    def to(self, device):
        return self._replace(tasks=self.tasks.to(device),
                             entries=self.entries.to(device))

    @property
    def thin(self):
        """Whether every task is thin (the thin kernel runs them)."""
        return all(c == 0 for (r, _, _), c in zip(self.out_dims, self.classes)
                   if r)


def shape_class(m, n, k_min):
    """Kernel class of an output bucket of ``m x n`` blocks whose entries
    have depth ``k >= k_min`` (``inf`` when no entry reaches it): 0 (thin)
    if ``min(m, n, k_min) < 8`` or the bucket has no entry (its tasks only
    write zeros), else ``1 + 3 log2(WM / 8) + log2(WN / 8)`` for a
    ``WM x WN`` warp tile."""
    if min(m, n, k_min) < 8 or k_min == float('inf'):
        return 0
    return 1 + 3 * (_side(m).bit_length() - 4) + (_side(n).bit_length() - 4)


def class_tile(cls):
    """``(WM, WN)`` of a block class, None for the thin class."""
    if cls == 0:
        return None
    return 8 << ((cls - 1) // 3), 8 << ((cls - 1) % 3)


def _tile_origins(cls, m, n):
    """Origins of the tasks that cover one output row, and the output
    elements of each task (its work per unit of k)."""
    tile = class_tile(cls)
    if tile is None:
        return [(x, 0) for x in range(0, m * n, THIN_TILE)], THIN_TILE
    wm, wn = tile
    return ([(r, c) for r in range(0, m, wm) for c in range(0, n, wn)],
            wm * wn)


def build_tables(out_dims, classes, so, row, ab, ablk, bb, bblk, k):
    """The :class:`Tables` of a packed contraction.

    ``out_dims[s] = (rows, m, n)`` and ``classes[s]`` per output bucket
    (host values); the other arguments are int tensors with one value per
    block product, in any order: its output bucket and row, its a bucket and
    block, its b bucket and block, and its depth ``k``.  Built with tensor
    ops on the device of ``so``, without a host synchronisation."""
    out_dims = tuple(tuple(int(x) for x in d) for d in out_dims)
    classes = tuple(int(c) for c in classes)
    dev = so.device
    row_off = np.cumsum([0] + [d[0] for d in out_dims], dtype=np.int64)
    n_rows = int(row_off[-1])
    g = (torch.as_tensor(row_off[:-1], device=dev)[so.long()]
         + row.long())
    order = torch.argsort(g, stable=True)
    entries = torch.stack([ab, ablk, bb, bblk, k], 1)[order]
    entries = entries.to(torch.int32).contiguous()
    ones = torch.ones_like(g)
    counts = torch.zeros(n_rows, dtype=torch.long, device=dev)
    counts.index_add_(0, g, ones)
    row_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    k_sum = torch.zeros(n_rows, dtype=torch.long, device=dev)
    k_sum.index_add_(0, g, k.long())
    tasks, cost = [], []
    for s, ((nr, m, n), cls) in enumerate(zip(out_dims, classes)):
        origins, work = _tile_origins(cls, m, n)
        if nr == 0 or not origins:
            continue
        n_t = len(origins)
        r = torch.arange(nr, device=dev).repeat_interleave(n_t)
        orig = torch.as_tensor(origins, device=dev).repeat(nr, 1)
        gid = int(row_off[s]) + r
        tasks.append(torch.stack([
            torch.full_like(r, cls), torch.full_like(r, s), r,
            orig[:, 0], orig[:, 1], row_ptr[gid], row_ptr[gid + 1],
            torch.zeros_like(r)], 1))
        cost.append((k_sum[gid] + 1) * work)
    if not tasks:
        return Tables(out_dims, classes, torch.zeros(
            (0, TASK_COLS), dtype=torch.int32, device=dev), entries)
    tasks, cost = torch.cat(tasks), torch.cat(cost)
    tasks = tasks[torch.argsort(cost, descending=True, stable=True)]
    return Tables(out_dims, classes, tasks.to(torch.int32).contiguous(),
                  entries)


def table_groups(tables):
    """The block products the tables ask for, grouped by (out bucket,
    a bucket, b bucket), which fixes ``m, k, n``.

    Returns a list of ``(so, ab, bb, k, rows, a_blocks, b_blocks)``, the
    last three int64 tensors on the tables' device (one value per product).
    The first task of every output row (origin 0, 0) carries the row's
    entry range."""
    tasks, entries = tables.tasks, tables.entries
    dev = tasks.device
    first = tasks[(tasks[:, 3] == 0) & (tasks[:, 4] == 0)].long()
    cnt = first[:, 6] - first[:, 5]
    total = int(cnt.sum())
    if total == 0:
        return []
    base = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    e_idx = (torch.repeat_interleave(first[:, 5], cnt) - base
             + torch.arange(total, device=dev))
    so = torch.repeat_interleave(first[:, 1], cnt)
    rows = torch.repeat_interleave(first[:, 2], cnt)
    ent = entries[e_idx].long()
    key = (so * MAX_BUCKETS + ent[:, 0]) * MAX_BUCKETS + ent[:, 2]
    uniq, inv = torch.unique(key, return_inverse=True)
    order = torch.argsort(inv, stable=True)
    sizes = torch.bincount(inv, minlength=len(uniq)).tolist()
    groups = []
    for kv, sel in zip(uniq.tolist(), torch.split(order, sizes)):
        s, rest = divmod(kv, MAX_BUCKETS * MAX_BUCKETS)
        a_b, b_b = divmod(rest, MAX_BUCKETS)
        groups.append((s, a_b, b_b, int(ent[sel[0], 4]), rows[sel],
                       ent[sel, 1], ent[sel, 3]))
    return groups


def _check_contract(a_bufs, b_bufs, tables, compute, out):
    if not a_bufs or not b_bufs:
        raise ValueError("packed_contract needs at least one a and one b "
                         "bucket")
    out_dims, tasks, entries = tables.out_dims, tables.tasks, tables.entries
    if max(len(a_bufs), len(b_bufs), len(out_dims)) > MAX_BUCKETS:
        raise ValueError(f"more than {MAX_BUCKETS} buckets in one operand or "
                         f"the output: beyond the kernel's parameter block")
    dtype, device = a_bufs[0].dtype, a_bufs[0].device
    if dtype not in _FLOATS:
        raise TypeError(f"bucket dtype must be float32 or float64, got "
                        f"{dtype}")
    if (dtype, compute) not in _MODES:
        raise TypeError(f"no kernel mode for {dtype} data summed in "
                        f"{compute}")
    for x in (*a_bufs, *b_bufs):
        if x.dtype != dtype or x.device != device:
            raise ValueError(f"buckets must share dtype and device: "
                             f"{x.dtype} on {x.device} against {dtype} on "
                             f"{device}")
        if not x.is_contiguous():
            raise ValueError("buckets must be contiguous")
    for name, t, cols in (('tasks', tasks, TASK_COLS),
                          ('entries', entries, ENTRY_COLS)):
        if (t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != cols
                or not t.is_contiguous() or t.device != device):
            raise ValueError(f"{name} must be a contiguous (N, {cols}) int32 "
                             f"tensor on {device}")
    if len(tables.classes) != len(out_dims):
        raise ValueError("one shape class per output bucket")
    if any(r * m * n > _INT_MAX for r, m, n in out_dims) or \
            tasks.shape[0] > _INT_MAX:
        raise ValueError("shapes beyond the kernel's int32 arguments")
    if out is not None and (len(out) != len(out_dims) or any(
            o.shape != d or o.dtype != dtype or o.device != device
            or not o.is_contiguous() for o, d in zip(out, out_dims))):
        raise ValueError("out must hold one contiguous (rows, m, n) tensor "
                         "per output bucket, of the buckets' dtype and "
                         "device")


def packed_contract_plain(a_bufs, b_bufs, tables, compute_dtype=None):
    """Plain PyTorch version of :func:`packed_contract`: per group of
    :func:`table_groups`, gather, ``torch.bmm`` in ``compute_dtype`` and
    ``index_add_`` into the output rows in the data's type."""
    dtype = a_bufs[0].dtype
    compute = dtype if compute_dtype is None else compute_dtype
    dev = a_bufs[0].device
    out_dims = tables.out_dims
    outs = [torch.zeros((r, m * n), dtype=dtype, device=dev)
            for r, m, n in out_dims]
    for so, ab, bb, k, rows, ia, ib in table_groups(tables):
        _, m, n = out_dims[so]
        A = a_bufs[ab].reshape(-1, m, k)[ia].to(compute)
        B = b_bufs[bb].reshape(-1, k, n)[ib].to(compute)
        prod = torch.bmm(A, B).reshape(-1, m * n).to(dtype)
        outs[so].index_add_(0, rows, prod)
    return [o.reshape(r, m, n) for o, (r, m, n) in zip(outs, out_dims)]


@functools.lru_cache(maxsize=None)
def _kernel_library():
    """The built kernel library, its constants checked against this
    module's (the tables are built here for them)."""
    from .. import _build
    lib = _build.library()
    if (lib.packed_contract_max_buckets() != MAX_BUCKETS
            or lib.packed_contract_thin_tile() != THIN_TILE):
        raise RuntimeError("kernel library constants differ from "
                           "grouped_gemm.py's")
    return lib


def packed_contract(a_bufs, b_bufs, tables, compute_dtype=None, out=None):
    """Every block product of a packed tensordot, summed per output row.

    Parameters
    ----------
    a_bufs, b_bufs : lists of contiguous float64 or float32 tensors (one
        dtype, one device): the operand buckets; bucket ``i``'s blocks are
        read as ``(-1, m, k)`` / ``(-1, k, n)``.
    tables : the :class:`Tables` of :func:`build_tables`, its tensors on
        the buckets' device.  Index ranges are the caller's contract
        (checked when the tables are built; reading them here would
        synchronise).
    compute_dtype : the type each block product is computed in (default:
        the data's); float32 for float64 data is the f32 matmul mode.  The
        sum over a row's entries stays in the data's type, as in
        ``tenpy_tpu``.
    out : optional list of ``(rows, m, n)`` tensors to write into, whatever
        they hold (default: new uninitialised tensors).

    Returns the list of ``(rows, m, n)`` output tensors of the data's
    dtype, every row written.  A CPU tensor takes the plain version; a CUDA
    tensor launches one kernel (counted in :data:`LAUNCHES`) or raises.
    """
    global LAUNCHES
    dtype = a_bufs[0].dtype if a_bufs else None
    compute = dtype if compute_dtype is None else compute_dtype
    _check_contract(a_bufs, b_bufs, tables, compute, out)
    device = a_bufs[0].device
    if device.type == 'cpu':
        outs = packed_contract_plain(a_bufs, b_bufs, tables, compute)
        if out is None:
            return outs
        for o, x in zip(out, outs):
            o.copy_(x)
        return out
    if device.type != 'cuda':
        raise ValueError(f"no packed contraction kernel for device {device}")
    lib = _kernel_library()
    out_dims, tasks = tables.out_dims, tables.tasks
    outs = out if out is not None else [
        torch.empty(d, dtype=dtype, device=device) for d in out_dims]
    ptrs = np.zeros(3 * MAX_BUCKETS, np.int64)
    for i, bufs in enumerate((a_bufs, b_bufs, outs)):
        ptrs[i * MAX_BUCKETS:i * MAX_BUCKETS + len(bufs)] = \
            [x.data_ptr() for x in bufs]
    dims = np.zeros(2 * MAX_BUCKETS, np.int32)
    dims[:2 * len(out_dims)] = [x for _, m, n in out_dims for x in (m, n)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.packed_contract(
            _MODES[(dtype, compute)], int(tables.thin), ptrs.ctypes.data,
            dims.ctypes.data, len(a_bufs), len(b_bufs), len(outs),
            tasks.data_ptr(), tables.entries.data_ptr(), tasks.shape[0],
            stream)
    if rc != 0:
        raise RuntimeError("packed_contract kernel launch failed: "
                           + lib.packed_contract_error_string(rc).decode())
    if tasks.shape[0]:
        LAUNCHES += 1
    return outs


# ------------------------------------------------------- one bucket pair
def _check_segsum(a_src, b_src, seg_ptr, ia, ib, n_seg):
    if a_src.dim() != 3 or b_src.dim() != 3:
        raise ValueError("a_src (Na, m, k) and b_src (Nb, k, n) must be 3-D")
    if a_src.shape[2] != b_src.shape[1]:
        raise ValueError(f"inner dims differ: {tuple(a_src.shape)} @ "
                         f"{tuple(b_src.shape)}")
    if a_src.dtype not in _FLOATS or b_src.dtype != a_src.dtype:
        raise TypeError(f"a_src/b_src must share dtype float32 or float64, "
                        f"got {a_src.dtype}/{b_src.dtype}")
    for name, idx in (('seg_ptr', seg_ptr), ('ia', ia), ('ib', ib)):
        if idx.dtype != torch.int32 or idx.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor, got "
                            f"{idx.dtype} {tuple(idx.shape)}")
    if seg_ptr.shape[0] != n_seg + 1 or ia.shape != ib.shape:
        raise ValueError("seg_ptr must have n_seg + 1 entries and ia, ib one "
                         "per GEMM entry")
    for name, x in (('a_src', a_src), ('b_src', b_src), ('seg_ptr', seg_ptr),
                    ('ia', ia), ('ib', ib)):
        if x.device != a_src.device:
            raise ValueError(f"{name} is on {x.device}, a_src on "
                             f"{a_src.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(n_seg, a_src.shape[1], a_src.shape[2], b_src.shape[2]) > _INT_MAX:
        raise ValueError("shapes beyond the kernel's int32 arguments")


def segsum_tables(a_src, b_src, seg_ptr, ia, ib, n_seg):
    """One bucket pair's :class:`Tables`: output row ``s`` sums the entries
    ``seg_ptr[s]:seg_ptr[s+1]`` (device ops, no host synchronisation)."""
    m, k, n = a_src.shape[1], a_src.shape[2], b_src.shape[2]
    counts = (seg_ptr[1:] - seg_ptr[:-1]).long()
    row = torch.repeat_interleave(torch.arange(n_seg, device=ia.device),
                                  counts, output_size=ia.numel())
    zero = torch.zeros_like(ia)
    return build_tables([(n_seg, m, n)], [shape_class(m, n, k)], zero, row,
                        zero, ia, zero, ib, torch.full_like(ia, k))


def grouped_gemm_segsum(a_src, b_src, seg_ptr, ia, ib, n_seg):
    """``out[s] = sum_t a_src[ia[t]] @ b_src[ib[t]]`` over segment ``s``.

    Parameters
    ----------
    a_src : (Na, m, k) float64 or float32 tensor, contiguous: the source
        blocks (not gathered).
    b_src : (Nb, k, n) tensor of the same dtype and device.
    seg_ptr : (n_seg + 1,) int32: segment ``s`` owns entries
        ``seg_ptr[s]:seg_ptr[s+1]`` (non-decreasing, ``seg_ptr[0] == 0``).
    ia, ib : (B,) int32: gather indices into ``a_src`` / ``b_src`` per entry.
        Index ranges are the caller's contract.
    n_seg : int

    Returns (n_seg, m, n) of the input dtype, through the tables of one
    bucket pair and :func:`packed_contract`: the plain version for a CPU
    tensor, one kernel launch for a CUDA tensor.
    """
    n_seg = int(n_seg)
    _check_segsum(a_src, b_src, seg_ptr, ia, ib, n_seg)
    tables = segsum_tables(a_src, b_src, seg_ptr, ia, ib, n_seg)
    return packed_contract([a_src], [b_src], tables)[0]
