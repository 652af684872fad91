"""Krylov solvers on Arrays: Lanczos, GMRES and Arnoldi, and the Krylov
exponentials.

Port of ``KrylovBased``, ``LanczosGroundState``, ``LanczosEvolution``,
``GMRES``, ``Arnoldi``, ``ArnoldiEvolution``, ``lanczos_arpack``,
``gram_schmidt`` and the vector helpers of
``tenpy_tpu/linalg/krylov_based.py``.  The Krylov vectors are host
:class:`~.np_conserved.Array` s; the small tridiagonal
and Hessenberg problems run in numpy.  Lanczos is the host eigensolver of
the DMRG engines (:mod:`~tenpy_tpu_torch.algorithms.dmrg`),
``LanczosEvolution`` the host local evolution of TDVP
(:mod:`~tenpy_tpu_torch.algorithms.tdvp`; its loop, :func:`lanczos_evolve`,
also runs the packed evolution on the card, ``lanczos_evolve_packed`` in
:mod:`~tenpy_tpu_torch.algorithms.mps_common`), GMRES builds the
environments of an infinite MPS, Arnoldi finds transfer-matrix fixed
points.
"""

from __future__ import annotations

import numpy as np

from . import np_conserved as npc
from ..tools.misc import argsort
from ..tools.params import asConfig

__all__ = ['KrylovBased', 'LanczosGroundState', 'LanczosEvolution',
           'HostVectorOps', 'lanczos_evolve', 'GMRES', 'Arnoldi',
           'ArnoldiEvolution', 'lanczos_arpack', 'gram_schmidt']


def _v_norm(v):
    return float(npc.norm(v))


def _v_inner(v, w):
    """``<v|w>`` with conjugation of ``v``."""
    return complex(npc.inner(v.conj(), w, axes='range'))


def _v_scale(v, a):
    return v * a


def _v_axpy(a, x, y):
    """``y + a * x`` (a new Array)."""
    return y + a * x


def _tridiag(alphas, betas):
    N = len(alphas)
    T = np.zeros((N, N))
    T[np.arange(N), np.arange(N)] = alphas
    if N > 1:
        b = np.asarray(betas[:N - 1])
        T[np.arange(N - 1), np.arange(1, N)] = b
        T[np.arange(1, N), np.arange(N - 1)] = b
    return T


def _expm_tridiag(T, delta):
    """``exp(delta T)`` of a real symmetric (tridiagonal) matrix ``T``."""
    evals, evecs = np.linalg.eigh(T)
    return evecs @ np.diag(np.exp(delta * evals)) @ evecs.conj().T


class KrylovBased:
    """Base class of the Krylov solvers: options ``N_min`` (2), ``N_max``
    (20), ``P_tol`` (1e-14), ``reortho`` (False), ``E_shift`` (None),
    ``cutoff`` (1e-12)."""

    def __init__(self, H, psi0, options):
        self.H = H
        self.psi0 = psi0.copy(deep=False)
        self.options = options = asConfig(options, self.__class__.__name__)
        self.N_min = options.get('N_min', 2, int)
        self.N_max = options.get('N_max', 20, int)
        self.P_tol = options.get('P_tol', 1e-14, 'real')
        self.reortho = options.get('reortho', False, bool)
        self.E_shift = options.get('E_shift', None, 'real')
        self._cutoff = options.get('cutoff', 1e-12, 'real')
        self.Es = []

    def _to_cache(self, psi, cache, keep=None):
        cache.append(psi)
        if keep is not None and len(cache) > keep:
            del cache[0]


class LanczosGroundState(KrylovBased):
    """Lanczos search for the ground state of a hermitian operator.

    Options add ``E_tol`` (convergence on the change of the lowest Ritz
    value; off by default) and ``N_cache`` (Krylov vectors kept, default
    ``N_max``: fewer re-run the iteration to build the Ritz vector).  It
    stops once the weight ``(beta <e_N|gs>)^2`` of the next vector is
    below ``P_tol`` (after ``N_min`` steps), on a Krylov breakdown
    (``beta < cutoff``) or after ``N_max`` steps.  :meth:`run` returns
    ``(E0, psi0, N)``: the lowest Ritz value, its normalized Ritz vector
    and the iterations used.  ``orthogonal_to`` projects states out of
    the operator.
    """

    def __init__(self, H, psi0, options, orthogonal_to=()):
        super().__init__(H, psi0, options)
        self.E_tol = self.options.get('E_tol', np.inf, 'real')
        self.N_cache = self.options.get('N_cache', self.N_max, int)
        if self.N_cache < 2:
            raise ValueError("N_cache < 2 cannot reconstruct the result")
        if len(orthogonal_to) > 0:
            from .sparse import OrthogonalNpcLinearOperator
            self.H = OrthogonalNpcLinearOperator(self.H, list(orthogonal_to))

    def run(self):
        norm0 = _v_norm(self.psi0)
        if norm0 < 1e-14:
            raise ValueError("Lanczos with zero initial vector")
        w = _v_scale(self.psi0, 1. / norm0)
        cache = [w]
        alphas, betas = [], []
        E_prev = None
        vecs_all = [w] if self.reortho else None
        for k in range(self.N_max):
            hw = self.H.matvec(cache[-1])
            if self.E_shift is not None:
                hw = _v_axpy(self.E_shift, cache[-1], hw)
            alpha = float(np.real(_v_inner(cache[-1], hw)))
            alphas.append(alpha)
            hw = _v_axpy(-alpha, cache[-1], hw)
            if len(cache) > 1:
                hw = _v_axpy(-betas[-1], cache[-2], hw)
            if self.reortho:
                for v in vecs_all[:-1]:
                    hw = _v_axpy(-_v_inner(v, hw), v, hw)
            beta = _v_norm(hw)
            evals, evecs = np.linalg.eigh(_tridiag(alphas, betas))
            E = evals[0]
            self.Es.append(evals)
            converged = False
            if beta < self._cutoff:
                converged = True
            elif k + 1 >= self.N_min:
                if (beta * abs(evecs[-1, 0])) ** 2 < self.P_tol:
                    converged = True
                if E_prev is not None and self.E_tol < np.inf and \
                        abs(E - E_prev) < self.E_tol:
                    converged = True
            E_prev = E
            if converged or k + 1 == self.N_max:
                N = k + 1
                if len(cache) >= N:     # every basis vector cached
                    coeff = evecs[:, 0]
                    psi_out = _v_scale(cache[0], coeff[0])
                    for j in range(1, N):
                        psi_out = _v_axpy(coeff[j], cache[j], psi_out)
                    n_out = _v_norm(psi_out)
                    if n_out > 0:
                        psi_out = _v_scale(psi_out, 1. / n_out)
                else:                   # re-run the iteration
                    psi_out = self._build_vector(evecs[:, 0], N)
                return float(E - (self.E_shift or 0.)), psi_out, N
            betas.append(float(beta))
            w_next = _v_scale(hw, 1. / beta)
            self._to_cache(w_next, cache, self.N_cache)
            if self.reortho:
                vecs_all.append(w_next)
        raise RuntimeError("unreachable")

    def _build_vector(self, coeff, N):
        """The Ritz vector ``sum_k coeff[k] v_k``, re-running the iteration
        (for a cache too small to hold the basis)."""
        psi = _v_scale(self.psi0, 1. / _v_norm(self.psi0))
        cache = [psi]
        result = _v_scale(psi, coeff[0])
        betas = []
        for k in range(N - 1):
            hw = self.H.matvec(cache[-1])
            if self.E_shift is not None:
                hw = _v_axpy(self.E_shift, cache[-1], hw)
            alpha = float(np.real(_v_inner(cache[-1], hw)))
            hw = _v_axpy(-alpha, cache[-1], hw)
            if len(cache) > 1:
                hw = _v_axpy(-betas[-1], cache[-2], hw)
            beta = _v_norm(hw)
            if beta < self._cutoff:
                break
            betas.append(beta)
            w = _v_scale(hw, 1. / beta)
            result = _v_axpy(coeff[k + 1], w, result)
            self._to_cache(w, cache, 2)
        n = _v_norm(result)
        if n > 0:
            result = _v_scale(result, 1. / n)
        return result


class LanczosEvolution(LanczosGroundState):
    """``exp(delta H) |psi0>`` in the Krylov space of a hermitian ``H``
    (the local updates of TDVP); ``delta`` may be complex (``-1j dt``).

    :meth:`run` stops once the weight ``|c_N|^2`` of the last Krylov
    vector in the result is below ``P_tol`` (after ``N_min`` steps), on a
    Krylov breakdown (``beta < cutoff``) or after ``N_max`` steps, and
    returns ``(psi_f, N)``.  ``normalize`` (default: for a purely
    imaginary ``delta``) returns the normalized result, else its norm is
    the evolved one.
    """

    def __init__(self, H, psi0, options):
        super().__init__(H, psi0, options)
        self.delta = None

    def run(self, delta, normalize=None):
        self.delta = delta
        return lanczos_evolve(self.H.matvec, self.psi0, delta, HostVectorOps,
                              self.N_min, self.N_max, self.P_tol,
                              self._cutoff, self.E_shift, normalize)


class HostVectorOps:
    """The vector operations of :func:`lanczos_evolve` on host Arrays; the
    packed counterpart is ``mps_common.PackedVectorOps``.  ``norm`` and
    ``inner_re`` may return device scalars, which ``read`` brings to the
    host as floats (here they are floats already)."""
    norm = staticmethod(_v_norm)
    axpy = staticmethod(_v_axpy)
    scale = staticmethod(_v_scale)

    @staticmethod
    def inner_re(v, w):
        return float(np.real(_v_inner(v, w)))

    @staticmethod
    def read(*xs):
        return xs

    @staticmethod
    def combine(vecs, c):
        """``sum_k c[k] vecs[k]``."""
        result = _v_scale(vecs[0], c[0])
        for k in range(1, len(c)):
            result = _v_axpy(c[k], vecs[k], result)
        return result


def lanczos_evolve(matvec, psi0, delta, ops, N_min=2, N_max=20, P_tol=1e-14,
                   cutoff=1e-12, E_shift=None, normalize=None):
    """``exp(delta (H + E_shift)) psi0`` in the Krylov space of a hermitian
    ``H`` given by ``matvec``: the loop of :class:`LanczosEvolution`, on
    whatever vectors ``ops`` (:class:`HostVectorOps` or its packed
    counterpart) works on.

    Per step ``(alpha, beta)`` is read once (``ops.read``) and
    ``exp(delta T)`` of the small tridiagonal ``T`` runs in numpy.  It
    stops on a Krylov breakdown (``beta < cutoff``), once the weight
    ``|c_N|^2`` of the last Krylov vector in the result is below ``P_tol``
    (after ``N_min`` steps), or after ``N_max`` steps.  The result is
    ``sum_k c_k v_k``, normalized with ``normalize`` (default: for a purely
    imaginary ``delta``), else scaled by the norm of ``psi0``.  Returns
    ``(psi_f, N)``, ``N`` the Krylov steps (matvecs) taken.
    """
    norm0 = ops.norm(psi0)
    vecs = [ops.scale(psi0, 1. / norm0)]
    alphas, betas = [], []
    for k in range(N_max):
        hw = matvec(vecs[-1])
        if E_shift is not None:
            hw = ops.axpy(E_shift, vecs[-1], hw)
        alpha_t = ops.inner_re(vecs[-1], hw)
        hw = ops.axpy(-alpha_t, vecs[-1], hw)
        if len(vecs) > 1:
            hw = ops.axpy(-betas[-1], vecs[-2], hw)
        alpha, beta = ops.read(alpha_t, ops.norm(hw))
        alphas.append(alpha)
        coeff = _expm_tridiag(_tridiag(alphas, betas), delta)[:, 0]
        if beta < cutoff or k + 1 == N_max or \
                (k + 1 >= N_min and abs(coeff[-1]) ** 2 < P_tol):
            break
        betas.append(float(beta))
        vecs.append(ops.scale(hw, 1. / beta))
    result = ops.combine(vecs, coeff)
    if normalize is None:
        normalize = np.real(delta) == 0.
    if normalize:
        return ops.scale(result, 1. / ops.norm(result)), len(coeff)
    return ops.scale(result, norm0), len(coeff)


class GMRES(KrylovBased):
    """Restarted GMRES solving ``H x = b`` for Arrays.

    Options: ``N_min_gmres`` (5), ``N_max_gmres`` (Krylov steps per cycle,
    default ``N_max``), ``restart`` (cycles, 10), ``res`` (relative residual
    tolerance, 1e-8).  :meth:`run` returns ``(x, relative residual)``.
    """

    def __init__(self, H, psi0, b, options):
        super().__init__(H, psi0, options)
        self.N_min = self.options.get('N_min_gmres', 5, int)
        self.N_max = self.options.get('N_max_gmres',
                                      self.options.silent_get('N_max', 20))
        self.restart = self.options.get('restart', 10, int)
        self.res_tol = self.options.get('res', 1e-8, 'real')
        self.b = b

    def run(self):
        x = self.psi0
        norm_b = _v_norm(self.b)
        if norm_b < 1e-300:
            return _v_scale(self.b, 0.), 0.
        for _ in range(self.restart):
            x, res = self._cycle(x, norm_b)
            if res < self.res_tol:
                break
        return x, res

    def _cycle(self, x0, norm_b):
        r = _v_axpy(-1., self.H.matvec(x0), self.b)
        beta = _v_norm(r)
        if beta / norm_b < self.res_tol:
            return x0, beta / norm_b
        m = self.N_max
        vecs = [_v_scale(r, 1. / beta)]
        h = np.zeros((m + 1, m), dtype=complex)
        k_used = 0
        for k in range(m):
            w = self.H.matvec(vecs[-1])
            for j, v in enumerate(vecs):
                h[j, k] = _v_inner(v, w)
                w = _v_axpy(-h[j, k], v, w)
            hk = _v_norm(w)
            h[k + 1, k] = hk
            k_used = k + 1
            # least squares || beta e1 - H_bar y ||
            e1 = np.zeros(k_used + 1)
            e1[0] = beta
            y, _, _, _ = np.linalg.lstsq(h[:k_used + 1, :k_used], e1,
                                         rcond=None)
            res = np.linalg.norm(e1 - h[:k_used + 1, :k_used] @ y) / norm_b
            if hk < self._cutoff or res < self.res_tol:
                break
            vecs.append(_v_scale(w, 1. / hk))
        x = x0
        for j in range(k_used):
            x = _v_axpy(y[j], vecs[j], x)
        return x, res


class Arnoldi(KrylovBased):
    """Arnoldi iteration for the dominant eigenpairs of a non-hermitian
    operator.

    Options add ``E_tol`` (relative change of the leading Ritz value that
    counts as converged; default off), ``which`` ('LM', an order of
    :func:`~tenpy_tpu_torch.tools.misc.argsort`) and ``num_ev`` (1).
    :meth:`run` returns ``(eta, vec, N)`` for ``num_ev == 1``, else
    ``(etas, vecs, N)``: Ritz values, normalized Ritz vectors and the
    iterations used.  The vectors become complex where the Ritz values
    are.
    """

    def __init__(self, H, psi0, options):
        super().__init__(H, psi0, options)
        self.E_tol = self.options.get('E_tol', np.inf, 'real')
        self.which = self.options.get('which', 'LM', str)
        self.num_ev = self.options.get('num_ev', 1, int)

    def run(self):
        vecs = [_v_scale(self.psi0, 1. / _v_norm(self.psi0))]
        h = np.zeros((self.N_max + 1, self.N_max), dtype=complex)
        E_prev = None
        for k in range(self.N_max):
            w = self.H.matvec(vecs[-1])
            for j, v in enumerate(vecs):
                h[j, k] = _v_inner(v, w)
                w = _v_axpy(-h[j, k], v, w)
            beta = _v_norm(w)
            h[k + 1, k] = beta
            evals, evecs = np.linalg.eig(h[:k + 1, :k + 1])
            perm = argsort(evals, self.which)
            evals, evecs = evals[perm], evecs[:, perm]
            self.Es.append(evals)
            converged = beta < self._cutoff
            if k + 1 >= self.N_min and E_prev is not None:
                if self.E_tol < np.inf and abs(evals[0] - E_prev) < \
                        self.E_tol * max(abs(evals[0]), 1e-10):
                    converged = True
                if abs(beta * evecs[-1, 0]) ** 2 < self.P_tol:
                    converged = True
            E_prev = evals[0]
            if converged or k + 1 == self.N_max:
                psis = []
                for n in range(min(self.num_ev, k + 1)):
                    res = _v_scale(vecs[0], evecs[0, n])
                    for j in range(1, k + 1):
                        res = _v_axpy(evecs[j, n], vecs[j], res)
                    nrm = _v_norm(res)
                    psis.append(_v_scale(res, 1. / nrm) if nrm > 0 else res)
                if self.num_ev == 1:
                    return evals[0], psis[0], k + 1
                return evals[:len(psis)], psis, k + 1
            vecs.append(_v_scale(w, 1. / beta))
        raise RuntimeError("unreachable")


class ArnoldiEvolution(Arnoldi):
    """``exp(delta H) |psi0>`` in the Krylov space of a non-hermitian
    ``H``: :meth:`run` as :meth:`LanczosEvolution.run`, with the
    Hessenberg matrix's exponential (``scipy.linalg.expm``)."""

    def run(self, delta, normalize=None):
        import scipy.linalg
        norm0 = _v_norm(self.psi0)
        vecs = [_v_scale(self.psi0, 1. / norm0)]
        h = np.zeros((self.N_max + 1, self.N_max), dtype=complex)
        for k in range(self.N_max):
            w = self.H.matvec(vecs[-1])
            for j, v in enumerate(vecs):
                h[j, k] = _v_inner(v, w)
                w = _v_axpy(-h[j, k], v, w)
            beta = _v_norm(w)
            h[k + 1, k] = beta
            coeff = scipy.linalg.expm(delta * h[:k + 1, :k + 1])[:, 0]
            if beta < self._cutoff or k + 1 == self.N_max or \
                    (k + 1 >= self.N_min and abs(coeff[-1]) ** 2 < self.P_tol):
                break
            vecs.append(_v_scale(w, 1. / beta))
        result = _v_scale(vecs[0], coeff[0])
        for j in range(1, len(coeff)):
            result = _v_axpy(coeff[j], vecs[j], result)
        if normalize is None:
            normalize = np.real(delta) == 0.
        if normalize:
            result = _v_scale(result, 1. / _v_norm(result))
        else:
            result = _v_scale(result, norm0)
        return result, len(coeff)


def lanczos_arpack(H, psi0, options={}):
    """The ground state of ``H`` by ARPACK (``scipy.sparse.linalg.eigsh``)
    on the flat vectors of ``psi0``'s charge sector: ``(E0, psi)``."""
    from .sparse import FlatHermitianOperator, _np_dtype
    options = asConfig(options, 'Lanczos')
    flat_op, psi_flat = FlatHermitianOperator.from_guess_with_pipe(
        H.matvec, psi0, dtype=_np_dtype(psi0.dtype))
    tol = options.get('P_tol', 1e-14, 'real')
    options.get('N_min', None, int)
    E, V = flat_op.eigenvectors(num_ev=1, which='SA', v0_npc=psi_flat,
                                tol=tol)
    psi = V[0].split_legs([0])
    psi.iset_leg_labels(psi0.get_leg_labels())
    return float(np.real(E[0])), psi


def gram_schmidt(vecs, rcond=1e-14):
    """Orthonormalize a list of Arrays (new Arrays), dropping those within
    ``rcond`` of the span of the earlier ones."""
    res = []
    for v in vecs:
        for u in res:
            v = v - complex(npc.inner(u.conj(), v, axes='range')) * u
        n = npc.norm(v)
        if n > rcond:
            res.append(v / n)
    return res
