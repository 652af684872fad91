"""Krylov solvers on Arrays: GMRES and Arnoldi.

Port of ``KrylovBased``, ``GMRES``, ``Arnoldi``, ``gram_schmidt`` and the
vector helpers of ``tenpy_tpu/linalg/krylov_based.py``.  The Krylov vectors
are host :class:`~.np_conserved.Array` s; the small Hessenberg problems
(GMRES's least squares, Arnoldi's eigenproblem) run in numpy.  GMRES builds
the environments of an infinite MPS; Arnoldi finds transfer-matrix fixed
points (canonical form, correlation length, the environments' Arnoldi
route).  The Lanczos solvers of the host engines are not ported.
"""

from __future__ import annotations

import numpy as np

from . import np_conserved as npc
from ..tools.misc import argsort
from ..tools.params import asConfig

__all__ = ['KrylovBased', 'GMRES', 'Arnoldi', 'gram_schmidt']


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


class KrylovBased:
    """Base class of the Krylov solvers: options ``N_min`` (2), ``N_max``
    (20), ``P_tol`` (1e-14), ``cutoff`` (1e-12)."""

    def __init__(self, H, psi0, options):
        self.H = H
        self.psi0 = psi0.copy(deep=False)
        self.options = options = asConfig(options, self.__class__.__name__)
        self.N_min = options.get('N_min', 2, int)
        self.N_max = options.get('N_max', 20, int)
        self.P_tol = options.get('P_tol', 1e-14, 'real')
        self._cutoff = options.get('cutoff', 1e-12, 'real')
        self.Es = []


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
