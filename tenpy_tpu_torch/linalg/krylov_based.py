"""Krylov solvers on Arrays: the restarted GMRES of the environment builder.

Port of ``KrylovBased``, ``GMRES`` and the vector helpers of
``tenpy_tpu/linalg/krylov_based.py``.  The Krylov vectors are host
:class:`~.np_conserved.Array` s; the small Hessenberg least-squares problem
runs in numpy.  The Lanczos and Arnoldi solvers are not ported.
"""

from __future__ import annotations

import numpy as np

from . import np_conserved as npc
from ..tools.params import asConfig

__all__ = ['KrylovBased', 'GMRES']


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
