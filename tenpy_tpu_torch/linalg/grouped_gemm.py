r"""Fused gather -> grouped GEMM -> segment sum: the bucket GEMM of the packed
tensordot.

``out[s] = sum_{t: seg(t) == s} a_src[ia[t]] @ b_src[ib[t]]``, with the
entries of segment ``s`` at ``seg_ptr[s]:seg_ptr[s+1]`` (CSR row pointers of
the segment-sorted entries).

Port of ``tenpy_tpu/linalg/pallas_gemm.py`` (``grouped_gemm_segsum``,
``reference_segsum``).  On a CUDA tensor the wrapper launches the
hand-written kernel of ``csrc/grouped_gemm_segsum.cu`` (f64 or f32, summed in
the input type) or raises; on a CPU tensor it takes the plain PyTorch version
:func:`grouped_gemm_segsum_plain`.  The TPU's VMEM rules (``min(m,k,n) >= 8``,
``group_fits_vmem``) do not carry over: the kernel masks every ragged edge.
"""

from __future__ import annotations

import torch

__all__ = ['grouped_gemm_segsum', 'grouped_gemm_segsum_plain', 'LAUNCHES']

# kernel launches so far (one per call that reached the CUDA kernel); a run
# resets it to 0 and reads it to show its main path went through the kernel
LAUNCHES = 0

_FLOATS = (torch.float32, torch.float64)
_INT_MAX = 2 ** 31 - 1


def _check(a_src, b_src, seg_ptr, ia, ib, n_seg):
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


def grouped_gemm_segsum_plain(a_src, b_src, seg_ptr, ia, ib, n_seg):
    """Plain PyTorch version: gather, ``torch.bmm``, then ``index_add_``."""
    m, n = a_src.shape[1], b_src.shape[2]
    out = torch.zeros((n_seg, m, n), dtype=a_src.dtype, device=a_src.device)
    if ia.numel() == 0:
        return out
    counts = (seg_ptr[1:] - seg_ptr[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(n_seg, device=a_src.device), counts)
    prod = torch.bmm(a_src[ia.long()], b_src[ib.long()])
    return out.index_add_(0, seg, prod)


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
        Index ranges are the caller's contract (checked at plan time on the
        host; reading them here would synchronise the device).
    n_seg : int

    Returns (n_seg, m, n) of the input dtype.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (and counts the launch in
    :data:`LAUNCHES`) or raises.
    """
    global LAUNCHES
    n_seg = int(n_seg)
    _check(a_src, b_src, seg_ptr, ia, ib, n_seg)
    if a_src.device.type == 'cpu':
        return grouped_gemm_segsum_plain(a_src, b_src, seg_ptr, ia, ib, n_seg)
    if a_src.device.type != 'cuda':
        raise ValueError(f"no grouped GEMM kernel for device {a_src.device}")
    from .. import _build
    lib = _build.library()
    m, k, n = a_src.shape[1], a_src.shape[2], b_src.shape[2]
    out = torch.empty((n_seg, m, n), dtype=a_src.dtype, device=a_src.device)
    if out.numel() == 0:
        return out
    fn = (lib.grouped_gemm_segsum_f64 if a_src.dtype == torch.float64
          else lib.grouped_gemm_segsum_f32)
    with torch.cuda.device(a_src.device):
        stream = torch.cuda.current_stream(a_src.device).cuda_stream
        rc = fn(a_src.data_ptr(), b_src.data_ptr(), seg_ptr.data_ptr(),
                ia.data_ptr(), ib.data_ptr(), out.data_ptr(), n_seg, m, k, n,
                stream)
    if rc != 0:
        raise RuntimeError("grouped_gemm_segsum kernel launch failed: "
                           + lib.grouped_gemm_segsum_error_string(rc).decode())
    LAUNCHES += 1
    return out
