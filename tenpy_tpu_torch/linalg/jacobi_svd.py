r"""The split's one-sided Jacobi SVD, every bucket group of a split at once.

Port of ``tenpy_tpu/linalg/packed_split.py``'s ``_jacobi_schedule``,
``_ch_newton_schulz_orth`` and ``_decomp_jacobi``: a batched SVD that
orthogonalizes the columns of each matrix by sweeps of round-robin Givens
rotations (``n - 1`` rounds of ``n / 2`` disjoint column pairs per
sweep), exact on zero and padded columns (they never rotate).  Complex128
stays one tensor here (the JAX package splits re and im into two f64
channels because the TPU has no complex128); a complex pair takes the
phase of ``conj(A_p) . A_q`` onto the q column, so the 2 x 2 problem is
real.  The rotations are the JAX package's; where it runs 14 fixed sweeps,
a matrix here sweeps until a sweep finds it converged, at most
:data:`MAX_SWEEPS` (:func:`jacobi_sweeps_plain`): 14 left a chi=256
Hubbard split's smallest singular values wrong by up to 3.4e-6 of their
matrix's largest (``chip_smoke.py``, phase 20a).

:func:`decomp_jacobi` takes the list of every bucket group's batch of one
split and lays them out in one workspace, a *ragged batch*: per matrix its
columns stored contiguously (column-major), ``A`` (``R x C``) and ``V``
(``C x C``), and a table of ``(A offset, V offset, R, C)`` rows
(:func:`ragged_table`, int64, on the device).  :func:`jacobi_sweeps` runs
the sweeps on the whole workspace: on a CUDA tensor one launch of the
hand-written kernel of ``csrc/jacobi_svd.cu`` (counted in
:data:`LAUNCHES`), which makes no host synchronisation; on a CPU tensor
the plain version :func:`jacobi_sweeps_plain` group by group; on any other
device it raises.  The epilogue (column norms, order, ``U = A / S``, the
cut) is torch ops per group, without host synchronisation.

``bulk_f32`` (the ``'jacobi32'`` backend) sweeps each matrix, divided by
its norm, in float32 (complex64) from the identity (at most
``MAX_SWEEPS - 2``; the JAX package casts it as it is), cleans the
accumulated rotation ``V`` by Newton-Schulz in the working type, sets
``A = M V`` and polishes in the working type from that ``(A, V)`` until
converged (the JAX package: 2 sweeps): two launches per split.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ['LAUNCHES', 'MAX_THREADS', 'MAX_SWEEPS', 'jacobi_schedule',
           'ragged_table',
           'jacobi_sweeps_plain', 'jacobi_sweeps', 'newton_schulz_orth',
           'decomp_jacobi']

# kernel launches so far (one per call that reached the CUDA kernel); a run
# resets it to 0 and reads it to show its main path went through the kernel
LAUNCHES = 0

# threads of one block (one matrix): one warp per column pair, at most
# this many (csrc/jacobi_svd.cu's launch bound)
MAX_THREADS = 1024
# the sweeps a matrix may take at most; a converged one stops earlier.  The
# JAX package runs 14 fixed sweeps, which left a chi=256 Hubbard split's
# singular values off by up to 3.4e-6 of their matrix's largest; converged,
# it took at most 19 and the TEBD update's 23 (chip_smoke.py, phase 20a)
MAX_SWEEPS = 30

# kernel mode per workspace dtype
_MODES = {torch.float64: 0, torch.complex128: 1, torch.float32: 2,
          torch.complex64: 3}
_LOW = {torch.float64: torch.float32, torch.complex128: torch.complex64}


# ------------------------------------------------------------ the schedule
@functools.lru_cache(maxsize=64)
def jacobi_schedule(n):
    """Round-robin (tournament) pairing of ``n`` columns (``n`` even):
    ``(p, q)``, two int32 arrays ``(n - 1, n // 2)`` with ``p < q``; every
    unordered pair appears once per sweep.

    Computed in closed form, as the kernel computes it: column 0 stays put,
    positions ``1 .. n-1`` shift by one per round, so position ``k >= 1``
    holds ``((k - 1 - r) mod (n - 1)) + 1`` in round ``r``, and pair ``i``
    is positions ``(i, n - 1 - i)`` (the JAX package's ``_jacobi_schedule``
    rotates a Python list)."""
    if n % 2 or n < 2:
        raise ValueError(f"the schedule needs an even n >= 2, not {n}")
    r = np.arange(n - 1)[:, None]
    i = np.arange(n // 2)[None, :]

    def player(k):
        return np.where(k == 0, 0, (k - 1 - r) % (n - 1) + 1)

    a, b = player(i), player(n - 1 - i)
    return (np.minimum(a, b).astype(np.int32),
            np.maximum(a, b).astype(np.int32))


# ----------------------------------------------------------- the workspace
def _tall_dims(dims):
    """Per group ``(N, R, C)`` of the matrix the sweeps see: tall (a wide
    ``M`` as ``M^H``) and ``C`` padded to even."""
    out = []
    for N, R, C in dims:
        if R < C:
            R, C = C, R
        out.append((int(N), int(R), int(C + C % 2)))
    return out


@functools.lru_cache(maxsize=256)
def _layout(dims):
    """Per group its ``A`` and ``V`` offsets in the workspace, and the two
    workspace lengths."""
    a_base, v_base = [], []
    a = v = 0
    for N, R, C in _tall_dims(dims):
        a_base.append(a)
        v_base.append(v)
        a += N * R * C
        v += N * C * C
    return tuple(a_base), tuple(v_base), a, v


def ragged_table(dims):
    """The kernel's table for groups of shapes ``dims`` (``(N, R, C)`` per
    group, as ``M`` is given): int64 ``(n_matrices, 4)``, per matrix
    ``(A offset, V offset, R, C)`` in elements of the workspace, ``R >= C``
    and ``C`` even.  Rows are sorted by work (``R C^2``), largest first, so
    that the longest blocks start first; their order changes nothing
    else."""
    dims = tuple(tuple(int(x) for x in d) for d in dims)
    a_base, v_base, _, _ = _layout(dims)
    rows = []
    for (N, R, C), a0, v0 in zip(_tall_dims(dims), a_base, v_base):
        for n in range(N):
            rows.append((a0 + n * R * C, v0 + n * C * C, R, C))
    rows.sort(key=lambda t: -t[2] * t[3] * t[3])
    return np.array(rows, np.int64).reshape(len(rows), 4)


@functools.lru_cache(maxsize=256)
def _device_table(dims, device):
    """:func:`ragged_table` on ``device``, copied there once per shape
    list (the copy synchronises with the host)."""
    return torch.from_numpy(ragged_table(dims)).to(device)


def _group_views(ws_A, ws_V, dims):
    """Per group ``(A, V)`` as views of the workspace in the natural layout
    ``(N, R, C)`` and ``(N, C, C)`` (column-major storage; V None without
    ``ws_V``)."""
    a_base, v_base, _, _ = _layout(dims)
    out = []
    for (N, R, C), a0, v0 in zip(_tall_dims(dims), a_base, v_base):
        A = ws_A[a0:a0 + N * R * C].view(N, C, R).transpose(1, 2)
        V = None if ws_V is None else \
            ws_V[v0:v0 + N * C * C].view(N, C, C).transpose(1, 2)
        out.append((A, V))
    return out


# ---------------------------------------------------------- the sweeps
def _rotation(app, aqq, apq):
    """``(c, s, |apq|)`` of the rotation of one column pair from
    ``|A_p|^2``, ``|A_q|^2`` and ``conj(A_p) . A_q`` (each ``(B, n/2)``),
    as the JAX package's ``round_body`` computes them."""
    # |apq| and its phase by real arithmetic, as the kernel computes them
    # (complex division and abs of float32 subnormals give NaN and 0)
    abs_apq = _abs(apq)
    nz = abs_apq > 0
    d = torch.where(nz, abs_apq, 1.)
    if apq.is_complex():
        ph = torch.view_as_complex(torch.view_as_real(apq) / d[..., None])
    else:
        ph = apq / d
    ph = torch.where(nz, ph, 1.)
    tiny = abs_apq <= 1e-300 + 1e-18 * torch.sqrt(app * aqq)
    tau = (aqq - app) / torch.where(tiny, 1., 2. * abs_apq)
    # clamp: at |tau| = 1e18 the rotation is ~3e-19, with finite
    # intermediates; sign(0) is +1 (exactly degenerate columns rotate 45
    # degrees)
    tau = torch.clamp(tau, -1e18, 1e18)
    sgn = torch.where(tau >= 0., 1., -1.).to(tau.dtype)
    t = sgn / (tau.abs() + torch.sqrt(1. + tau * tau))
    t = torch.where(tiny, 0., t)
    c = 1. / torch.sqrt(1. + t * t)
    return c, (t * c) * ph, abs_apq


def jacobi_sweeps_plain(A, V, max_sweeps):
    """One-sided Jacobi on a batch, in place, each matrix until a sweep
    finds it converged or after ``max_sweeps`` sweeps: ``A`` ``(B, R, C)``
    and ``V`` ``(B, C, C)`` (C even, any strides) are rotated together,
    column pair by column pair in the round-robin order of
    :func:`jacobi_schedule`.  Each rotation takes ``c`` real and ``s``
    with the phase of ``conj(A_p) . A_q`` and sets ``new_p = c X_p -
    conj(s) X_q``, ``new_q = s X_p + c X_q`` for both ``X = A`` and ``X =
    V``.  A sweep in which no pair has ``|A_p^H A_q| > R eps |A|_F
    max(|A_p|, |A_q|)`` (``eps`` of the dtype) leaves the matrix
    converged: two columns of comparable norm are then orthogonal to
    ``R eps``, and a small column is orthogonal to a large one to the
    roundoff that the large column leaves in it.  Returns ``(A, V,
    sweeps)``, ``sweeps`` the sweeps run per matrix (int64 ``(B,)``).
    The plain PyTorch version of the kernel."""
    B, R, C = A.shape
    if C % 2 or V.shape != (B, C, C):
        raise ValueError(f"jacobi sweeps need C even and V (B, C, C): A "
                         f"{tuple(A.shape)}, V {tuple(V.shape)}")
    n_sweeps = torch.zeros(B, dtype=torch.int64, device=A.device)
    if B == 0 or C == 0 or max_sweeps <= 0:
        return A, V, n_sweeps
    h = C // 2
    # per round the columns p_0 .. p_h-1, q_0 .. q_h-1
    rounds = list(torch.from_numpy(np.concatenate(jacobi_schedule(C), 1)
                                   .astype(np.int64)).to(A.device))
    eps = torch.finfo(A.real.dtype if A.is_complex() else A.dtype).eps
    thr = (R * eps) * torch.sqrt(_sq(A).sum((1, 2)))[:, None]
    # columns as rows: A's and V's columns side by side, (B, C, R + C)
    X = torch.cat([A.transpose(1, 2), V.transpose(1, 2)], dim=2)
    done = torch.zeros(B, 1, dtype=torch.bool, device=A.device)
    for _ in range(max_sweeps):
        active = torch.zeros_like(done)
        for pq in rounds:
            Y = X.index_select(1, pq)
            nrm = _sq(Y[..., :R]).sum(-1)
            app, aqq = nrm[:, :h], nrm[:, h:]
            Xp, Xq = Y[:, :h], Y[:, h:]
            apq = torch.linalg.vecdot(Xp[..., :R], Xq[..., :R])
            c, s, abs_apq = _rotation(app, aqq, apq)
            active |= (abs_apq > thr * torch.sqrt(torch.maximum(app, aqq))
                       ).any(-1, keepdim=True)
            # a converged matrix rotates no more (c = 1, s = 0: exact)
            c = torch.where(done, 1., c)[..., None]
            s = torch.where(done, 0., s)[..., None]
            X.index_copy_(1, pq, torch.cat([c * Xp - s.conj() * Xq,
                                            s * Xp + c * Xq], 1))
        n_sweeps += ~done[:, 0]
        done |= ~active
        if bool(done.all()):
            break
    A.copy_(X[..., :R].transpose(1, 2))
    V.copy_(X[..., R:].transpose(1, 2))
    return A, V, n_sweeps


def _sq(X):
    """``|X|^2`` elementwise, by real arithmetic."""
    if X.is_complex():
        return X.real.square() + X.imag.square()
    return X.square()


def _abs(x):
    """``|x|`` as the kernel computes it (``sqrt(re^2 + im^2)``)."""
    return torch.sqrt(_sq(x)) if x.is_complex() else x.abs()


@functools.lru_cache(maxsize=None)
def _kernel_library():
    from .. import _build
    lib = _build.library()
    if lib.jacobi_svd_max_threads() != MAX_THREADS:
        raise RuntimeError("kernel library constants differ from "
                           "jacobi_svd.py's")
    return lib


def jacobi_sweeps(ws_A, ws_V, dims, max_sweeps, init_v, plain=False,
                  sweeps_out=None):
    """The sweeps on a whole workspace (groups of shapes ``dims``, as
    :func:`decomp_jacobi` lays them out), in place, each matrix until
    converged or after ``max_sweeps`` sweeps (:func:`jacobi_sweeps_plain`).
    The kernel reads the groups' :func:`ragged_table`, copied to the device
    once per shape list and device.

    ``init_v`` sets every ``V`` to the identity first; ``sweeps_out``, an
    int32 tensor of one entry per table row, receives the sweeps each
    matrix ran.  On a CUDA tensor: one launch of the kernel (counted in
    :data:`LAUNCHES`), no host synchronisation, or a raise; on a CPU tensor
    (or with ``plain``, the yardstick on any device)
    :func:`jacobi_sweeps_plain` per group."""
    global LAUNCHES
    device = ws_A.device
    if device.type == 'cpu' or plain:
        done = []
        for A, V in _group_views(ws_A, ws_V, dims):
            if init_v:
                V.copy_(torch.eye(V.shape[-1], dtype=V.dtype,
                                  device=device).expand(V.shape))
            done.append(jacobi_sweeps_plain(A, V, max_sweeps)[2])
        if sweeps_out is not None:
            # the table's rows are sorted by work: map them by A offset
            a_base, _, _, _ = _layout(dims)
            offs = np.concatenate([a0 + np.arange(N) * R * C for (N, R, C), a0
                                   in zip(_tall_dims(dims), a_base)])
            row = {int(a): i for i, a in enumerate(ragged_table(dims)[:, 0])}
            order = torch.tensor([row[int(a)] for a in offs], device=device)
            sweeps_out[order] = torch.cat(done).to(sweeps_out.dtype)
        return ws_A, ws_V
    if device.type != 'cuda':
        raise ValueError(f"no Jacobi SVD kernel for device {device}")
    dtype = ws_A.dtype
    dims = tuple(tuple(int(x) for x in d) for d in dims)
    n = sum(N for N, _, _ in dims)
    if (dtype not in _MODES or ws_V.dtype != dtype or ws_V.device != device
            or not (ws_A.is_contiguous() and ws_V.is_contiguous())
            or (sweeps_out is not None and (
                sweeps_out.dtype != torch.int32 or sweeps_out.device != device
                or sweeps_out.shape != (n,)))):
        raise ValueError("jacobi_sweeps: contiguous workspaces of one "
                         "float32/64 or complex64/128 dtype and an int32 "
                         "(n,) sweeps_out on their device")
    if n == 0:
        return ws_A, ws_V
    half = max(C for _, _, C in _tall_dims(dims)) // 2
    threads = 32 * min(max(half, 1), MAX_THREADS // 32)
    table = _device_table(dims, device)
    lib = _kernel_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.jacobi_svd_sweeps(
            _MODES[dtype], ws_A.data_ptr(), ws_V.data_ptr(),
            table.data_ptr(), n, int(max_sweeps), int(bool(init_v)), threads,
            None if sweeps_out is None else sweeps_out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("jacobi_svd kernel launch failed: "
                           + lib.jacobi_svd_error_string(rc).decode())
    LAUNCHES += 1
    return ws_A, ws_V


# ---------------------------------------------------------- the SVD
def newton_schulz_orth(V, iters=2):
    """Re-orthonormalize a nearly unitary batch ``V``: ``V <- 1.5 V - 0.5 V
    (V^H V)``, each iteration squaring the columns' orthogonality error."""
    for _ in range(iters):
        V = 1.5 * V - 0.5 * torch.matmul(
            V, torch.matmul(V.conj().transpose(-1, -2), V))
    return V


def _unit(M):
    """Each matrix of the batch ``M`` divided by its Frobenius norm (where
    that is not 0)."""
    nrm = _sq(M).sum((1, 2)).sqrt()[:, None, None]
    return M / torch.where(nrm > 0, nrm, 1.)


def _fill(ws, Ms, dims):
    """Write each group's tall matrix (``M`` or ``M^H``, a zero column for
    an odd C) into the workspace ``ws``."""
    for M, (A, _) in zip(Ms, _group_views(ws, None, dims)):
        W = M if M.shape[1] >= M.shape[2] else M.conj().transpose(1, 2)
        A[..., :W.shape[2]].copy_(W)
        A[..., W.shape[2]:].zero_()


def decomp_jacobi(Ms, max_sweeps=MAX_SWEEPS, bulk_f32=False, plain=False,
                  sweeps_out=None):
    """``(U, S, V)`` per group with ``M = U diag(S) V^H``, by one-sided
    Jacobi on every group of ``Ms`` (a list of ``(N, R, C)`` batches of one
    dtype and device) in one workspace, each matrix until converged or
    after ``max_sweeps`` sweeps (:func:`jacobi_sweeps_plain`).

    ``S`` ``(N, K)`` descending (``K = min(R, C)``), ``U`` ``(N, R, K)``,
    ``V`` ``(N, C, K)``; ``U``'s columns of zero singular values are zero
    (``V``'s for a wide ``M``).
    A wide ``M`` is decomposed as ``M^H``; an odd ``C`` gets one zero
    column.  ``bulk_f32`` on float64 or complex128 data: the float32
    (complex64) bulk (at most ``max_sweeps - 2`` sweeps), Newton-Schulz,
    ``A = M V`` and the polish in the working type (two launches).
    ``plain`` runs the plain sweeps on any device (the yardstick).  ``sweeps_out``, a list,
    receives per launch the int32 sweeps of each table row."""
    if not Ms:
        return []
    dims = tuple(tuple(int(x) for x in M.shape) for M in Ms)
    dtype, device = Ms[0].dtype, Ms[0].device
    _, _, len_a, len_v = _layout(dims)
    n_rows = sum(N for N, _, _ in dims)

    def sweeps(ws_A, ws_V, cap, init_v):
        out = None
        if sweeps_out is not None:
            out = torch.zeros(n_rows, dtype=torch.int32, device=device)
            sweeps_out.append(out)
        jacobi_sweeps(ws_A, ws_V, dims, cap, init_v, plain, out)

    ws_A = torch.empty(len_a, dtype=dtype, device=device)
    ws_V = torch.empty(len_v, dtype=dtype, device=device)
    low = _LOW.get(dtype) if bulk_f32 else None
    if low is None:
        _fill(ws_A, Ms, dims)
        sweeps(ws_A, ws_V, max_sweeps, True)
    else:
        lo_A = torch.empty(len_a, dtype=low, device=device)
        lo_V = torch.empty(len_v, dtype=low, device=device)
        # each matrix at unit norm: V does not change, and the small
        # entries of a small matrix stay out of float32's subnormals
        _fill(lo_A, [_unit(M).to(low) for M in Ms], dims)
        sweeps(lo_A, lo_V, max(max_sweeps - 2, 1), True)
        views = _group_views(ws_A, ws_V, dims)
        _fill(ws_A, Ms, dims)
        for (A, V), (_, V32) in zip(views, _group_views(lo_A, lo_V, dims)):
            Vc = newton_schulz_orth(V32.to(dtype), iters=2)
            A.copy_(torch.matmul(A, Vc))
            V.copy_(Vc)
        sweeps(ws_A, ws_V, max_sweeps, False)
    out = []
    for M, (A, V) in zip(Ms, _group_views(ws_A, ws_V, dims)):
        R, C = M.shape[1], M.shape[2]
        swap = R < C
        Rt, Ct = (C, R) if swap else (R, C)
        if A.is_complex():
            S = (A.real.square() + A.imag.square()).sum(1).sqrt()
        else:
            S = A.square().sum(1).sqrt()
        order = torch.argsort(S, dim=-1, descending=True, stable=True)
        S = S.gather(-1, order)
        A = A.gather(-1, order[:, None, :].expand(A.shape))
        V = V.gather(-1, order[:, None, :].expand(V.shape))
        good = S > 0
        inv = torch.where(good, 1. / torch.where(good, S, 1.), 0.)
        K = min(Rt, Ct)
        U = (A * inv[:, None, :].to(dtype))[:, :, :K]
        V, S = V[:, :Ct, :K], S[:, :K]
        out.append((V, S, U) if swap else (U, S, V))
    return out
