r"""Two-site effective-Hamiltonian matvec and Lanczos on the packed layout.

Port of the device path of ``tenpy_tpu/algorithms/mps_common.py``
(``BUCKET_MULTIPLE``, ``_matvec_2site_packed``,
``_lanczos_K_2site_packed_impl``).  The ``lax.scan`` / ``lax.while_loop``
of the JAX version become Python loops over device tensors; the K x K
tridiagonal eigenproblem runs on a host f64 copy.  The early-exit loop reads
one scalar pair per iteration from the device.  A complex Hamiltonian or
guess runs the same loop on complex128 vectors: alpha = Re<v|Hv> and
beta = |w| are real, so the tridiagonal problem stays real.
"""

from __future__ import annotations

import numpy as np
import torch

from ..linalg import packed as pk

__all__ = ['BUCKET_MULTIPLE', '_matvec_2site_packed',
           '_lanczos_K_2site_packed_impl']

# Sector sizes of virtual legs are rounded up to this multiple on the packed
# path; the same constant as tenpy_tpu's default, so both packages build the
# same layouts.
BUCKET_MULTIPLE = 64


def _matvec_2site_packed(LPp, RPp, W0p, W1p, v):
    """Two-site effective-H matvec on packed arrays; theta legs
    ``(vL, p0, p1, vR)``."""
    x = pk.tensordot(LPp, v, axes=(['vR'], ['vL']))
    x = pk.tensordot(x, W0p, axes=(['wR', 'p0'], ['wL', 'p0*']))
    x = pk.tensordot(x, W1p, axes=(['wR', 'p1'], ['wL', 'p1*']))
    x = pk.tensordot(x, RPp, axes=(['wR', 'vR'], ['wL', 'vL']))
    x = x.replace_labels(['vR*', 'vL*'], ['vL', 'vR'])
    return x.transpose(['vL', 'p0', 'p1', 'vR'])


def _tridiag_ground(alphas, betas, diag_live, off_live):
    """Lowest eigenpair of the K x K tridiagonal matrix on the host.

    Dead diagonal slots are shifted just above the spectrum by a Gershgorin
    bound, so the lowest eigenvalue comes from the live block."""
    big = np.max(np.abs(alphas)) + 2. * np.max(np.abs(betas)) + 1.
    diag = np.where(diag_live, alphas, big)
    off = np.where(off_live, betas[:-1], 0.)
    T = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
    evals, evecs = np.linalg.eigh(T)
    return float(evals[0]), evecs[:, 0]


def _combine(vs, c):
    """``sum_j c[j] vs[j]`` for a list of packed vectors and real
    coefficients ``c``."""
    out = [torch.zeros_like(d) for d in vs[0].data]
    for cj, v in zip(c, vs):
        for o, d in zip(out, v.data):
            o.add_(d, alpha=float(cj))
    return vs[0]._like(out)


def _lanczos_K_2site_packed_impl(LPp, RPp, W0p, W1p, theta0, K,
                                 P_tol=0., N_min=2, reortho=False,
                                 matvec_mode=None, exact_E=False):
    """Lanczos + Ritz ground state of the two-site effective H, packed.

    With ``P_tol > 0`` (or ``reortho``) the loop takes up to ``K`` steps and
    exits once the ground Ritz value is converged
    (``|E_i - E_{i-1}| <= P_tol |E_i|`` after at least ``N_min`` steps) or
    the Krylov space is exhausted; otherwise it takes exactly ``K`` steps
    and solves the tridiagonal problem once.  ``reortho`` orthogonalizes
    every new vector against the stored basis.  ``matvec_mode='f32'`` runs
    the matvecs' GEMMs in float32 while the scalar algebra stays f64; with
    ``exact_E`` the returned E0 is then the f64 Rayleigh quotient of the
    Ritz vector (one extra f64 matvec).

    Returns ``(E0, theta_gs, N_used, resid)``: floats ``E0`` and ``resid``
    (the residual bound ``|beta_N <e_N, gs>|``), the normalized packed Ritz
    vector and the iteration count as an int.

    The Krylov vectors take the result type of the operands (float64, or
    complex128 when any of them is complex; a float32 guess is promoted),
    as in ``tenpy_tpu``.  ``reortho`` with complex vectors raises, as
    there.
    """
    dtype = torch.float64
    for x in (LPp, RPp, W0p, W1p, theta0):
        dtype = torch.promote_types(dtype, x.dtype)
    if theta0.dtype != dtype:
        theta0 = theta0._like([d.to(dtype) for d in theta0.data])
    if reortho and dtype.is_complex:
        raise NotImplementedError("reortho with complex Krylov vectors "
                                  "(complex Gram-Schmidt coefficients) is "
                                  "not ported; run without reortho")
    v0 = theta0 * (1. / pk.norm(theta0))

    def matvec(v):
        with pk.matmul_mode(matvec_mode):
            return _matvec_2site_packed(LPp, RPp, W0p, W1p, v)

    def final_E(E_T, theta_gs):
        if not (exact_E and matvec_mode is not None):
            return E_T
        hw = _matvec_2site_packed(LPp, RPp, W0p, W1p, theta_gs)
        return float(pk.inner_re(theta_gs, hw))

    def normalized(v):
        return v * (1. / pk.norm(v))

    # Krylov noise floor: once beta drops to the matvec's GEMM noise the next
    # basis vector is pure noise; stop there (scaled by |alpha| + beta_prev)
    mv_eps = 2e-7 if matvec_mode == 'f32' else 0.

    if not (P_tol and P_tol > 0) and not reortho:
        # fixed-K path: no host sync inside the loop
        v_prev, v = v0 * 0., v0
        beta_prev = torch.zeros((), dtype=torch.float64, device=v0.device)
        vs, alphas, betas = [], [], []
        for _ in range(K):
            hw = matvec(v)
            alpha = pk.inner_re(v, hw)
            hw = hw - v * alpha
            hw = hw - v_prev * beta_prev
            beta = pk.norm(hw)
            floor = torch.clamp(30. * mv_eps * (alpha.abs() + beta_prev),
                                min=1e-14)
            ok = beta > floor
            inv = torch.where(ok, 1. / torch.where(ok, beta, 1.), 0.)
            vs.append(v)
            alphas.append(alpha)
            betas.append(beta)
            v_prev, v = v, hw * inv
            beta_prev = torch.where(ok, beta, 0.)
        alphas = torch.stack(alphas).cpu().numpy()
        betas = torch.stack(betas).cpu().numpy()
        # slots after an early Krylov breakdown are dead (zero vectors)
        live = np.concatenate([[True], np.cumprod(betas[:-1] > 0) > 0])
        E0, c = _tridiag_ground(alphas, betas, live, np.ones(K - 1, bool))
        theta_gs = normalized(_combine(vs, c))
        return final_E(E0, theta_gs), theta_gs, K, abs(betas[-1] * c[-1])

    vs = []
    alphas = np.zeros(K)
    betas = np.zeros(K)
    v_prev, v, beta_prev = v0 * 0., v0, 0.
    E_prev = np.inf
    i = 0
    while i < K:
        vs.append(v)
        hw = matvec(v)
        alpha_t = pk.inner_re(v, hw)
        hw = hw - v * alpha_t
        hw = hw - v_prev * beta_prev
        if reortho:
            cs = torch.stack([pk.inner_re(u, hw) for u in vs]).cpu().numpy()
            hw = hw - _combine(vs, cs)
        beta_t = pk.norm(hw)
        alpha, beta = (float(x) for x in torch.stack([alpha_t, beta_t]).cpu())
        ok = beta > max(1e-14, 30. * mv_eps * (abs(alpha) + beta_prev))
        alphas[i] = alpha
        betas[i] = beta if ok else 0.
        v_prev, v = v, (hw * (1. / beta) if ok else hw * 0.)
        beta_prev = betas[i]
        n = i + 1
        E, _ = _tridiag_ground(alphas, betas, np.arange(K) < n,
                               np.arange(K - 1) < n - 1)
        conv = P_tol > 0 and n >= N_min and abs(E - E_prev) <= P_tol * abs(E)
        E_prev = E
        i = n
        if conv or not ok:
            break
    E0, c = _tridiag_ground(alphas, betas, np.arange(K) < i,
                            np.arange(K - 1) < i - 1)
    resid = abs(betas[max(i - 1, 0)] * c[max(i - 1, 0)])
    theta_gs = normalized(_combine(vs, c[:len(vs)]))
    return final_E(E0, theta_gs), theta_gs, i, resid
