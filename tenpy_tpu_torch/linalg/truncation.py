r"""Truncation of Schmidt spectra and the truncated SVD of a wave function.

Port of ``TruncationError``, ``truncate``, ``svd_theta`` and ``eigh_rho``
of ``tenpy_tpu/linalg/truncation.py``: what :meth:`~tenpy_tpu_torch.
networks.mps.MPS.compress_svd` runs in the noise-floor rescue of
``canonical_form_infinite``, and the splits of the host DMRG engines
(``svd_theta``; ``eigh_rho`` for the density-matrix mixer).  The decision
which Schmidt values to keep runs in numpy on the host, the SVD on the
Array's CPU blocks.
"""

from __future__ import annotations

import warnings

import numpy as np

from . import np_conserved as npc
from ..tools.params import asConfig

__all__ = ['TruncationError', 'truncate', 'svd_theta', 'eigh_rho']


class TruncationError:
    r"""Truncation error: ``eps``, the sum of the discarded Schmidt values
    squared, and ``ov``, a lower bound of the overlap with the exact state."""

    def __init__(self, eps=0., ov=1.):
        self.eps = float(eps)
        self.ov = float(ov)

    def copy(self):
        return TruncationError(self.eps, self.ov)

    @classmethod
    def from_S(cls, S_discarded, norm_old=None):
        eps = float(np.sum(np.asarray(S_discarded) ** 2))
        if norm_old:
            eps /= norm_old * norm_old
        return cls(eps, 1. - 2. * eps)

    def __add__(self, other):
        return TruncationError(self.eps + other.eps, self.ov * other.ov)

    @property
    def ov_err(self):
        return 1. - self.ov

    def __repr__(self):
        if self.eps != 0 or self.ov != 1.:
            return f"TruncationError(eps={self.eps:.4e}, ov={self.ov:.10f})"
        return "TruncationError()"


def _and_allowed(allowed, extra, constraint_name):
    """AND a constraint's admissible keep-counts into ``allowed``; a
    constraint that would leave none is dropped with a warning."""
    both = allowed & extra
    if both.any():
        return both
    warnings.warn("truncation: can't satisfy constraint " + constraint_name,
                  stacklevel=3)
    return allowed


def truncate(S, options):
    """Which Schmidt values of ``S`` to keep: ``(mask, norm_new, err)``.

    Options: ``chi_max`` (100), ``chi_min``, ``degeneracy_tol``, ``svd_min``
    (1e-14), ``trunc_cut`` (1e-14).  Each option narrows the admissible
    keep-counts ``k`` of the descending spectrum (one that would empty them
    is dropped with a warning); the largest admissible ``k`` is kept, at
    least one value.  The kept set is ``tenpy_tpu``'s decision for
    decision."""
    options = asConfig(options, 'truncation')
    chi_max = options.get('chi_max', 100, int)
    chi_min = options.get('chi_min', None, int)
    deg_tol = options.get('degeneracy_tol', None, 'real')
    svd_min = options.get('svd_min', 1e-14, 'real')
    trunc_cut = options.get('trunc_cut', 1e-14, 'real')
    S = np.asarray(S)
    n = len(S)
    if trunc_cut is not None and trunc_cut >= 1.:
        raise ValueError("trunc_cut >= 1.")
    if not np.any(S > 1e-10):
        warnings.warn("no Schmidt value above 1e-10", stacklevel=2)
    if np.any(S < -1e-10):
        warnings.warn("negative Schmidt values!", stacklevel=2)
    # non-positive values become one tiny tie value before the sort, so
    # negative rounding noise and exact zeros are interchangeable at the cut
    S_floor = np.where(S <= 0., 1e-100, S)
    # descending with later-input ties first: the reference's kept set
    desc = np.argsort(S_floor, kind='stable')[::-1]
    logS_desc = np.log(S_floor[desc])
    ks = np.arange(1, n + 1)
    allowed = np.ones(n, dtype=bool)
    if chi_max is not None and chi_max > 0:
        allowed = _and_allowed(allowed, ks <= chi_max, 'chi_max')
    if chi_min is not None and chi_min > 1:
        allowed = _and_allowed(allowed, ks >= chi_min, 'chi_min')
    if deg_tol:
        # no cut inside a near-degenerate multiplet
        gap_ok = np.empty(n, dtype=bool)
        gap_ok[:-1] = logS_desc[:-1] - logS_desc[1:] >= deg_tol
        gap_ok[-1] = True
        allowed = _and_allowed(allowed, gap_ok, 'degeneracy_tol')
    if svd_min is not None:
        allowed = _and_allowed(allowed, logS_desc >= np.log(svd_min),
                               'svd_min')
    if trunc_cut is not None:
        # k admissible iff discarding one more would overflow the budget
        tail_w = np.cumsum(S[desc][::-1] ** 2)[::-1]
        allowed = _and_allowed(allowed, tail_w > trunc_cut * trunc_cut,
                               'trunc_cut')
    k_keep = int(ks[allowed][-1])
    mask = np.zeros(n, dtype=bool)
    mask[desc[:k_keep]] = True
    norm_new = float(np.linalg.norm(S[mask]))
    return mask, norm_new, TruncationError.from_S(S[~mask])


def svd_theta(theta, trunc_par, qtotal_LR=(None, None),
              inner_labels=('vR', 'vL')):
    """SVD of a 2-leg wave function, truncated by :func:`truncate`.

    Returns ``(U, S, VH, err, renormalization)`` with ``S`` normalized to 1
    after the cut."""
    U, S, VH = npc.svd(theta, qtotal_LR=list(qtotal_LR),
                       inner_labels=list(inner_labels))
    renormalization = float(np.linalg.norm(S))
    S = S / renormalization
    piv, new_norm, err = truncate(S, trunc_par)
    if int(np.sum(piv)) * 100 < len(S) and \
            asConfig(trunc_par, 'truncation').silent_get('chi_max',
                                                         None) is None:
        warnings.warn(f"catastrophic reduction in chi: {len(S)} -> "
                      f"{int(np.sum(piv))}", stacklevel=2)
    S = S[piv] / new_norm
    renormalization *= new_norm
    U = U.copy(deep=False).iproject(piv, 1)
    VH = VH.copy(deep=False).iproject(piv, 0)
    return U, S, VH, err, renormalization


def eigh_rho(rho, trunc_par, UPLO='L', sort=None):
    """Hermitian eigendecomposition of a density matrix, truncated.

    Returns ``(W, V, err, renormalization)``: the kept eigenvalues scaled
    so that ``rho ~= V diag(W) V^H`` after the cut, with
    ``renormalization`` the trace of ``rho`` after zeroing eigenvalues
    below 1e-14 (negative noise); the cut is decided on ``sqrt(W)``, the
    Schmidt-value scale."""
    W, V = npc.eigh(rho, UPLO=UPLO, sort=sort)
    W = np.asarray(W).copy()
    W[W < 1e-14] = 0.
    renormalization = float(np.sum(W))
    if renormalization > 0.:
        W = W / renormalization
    piv, new_norm, err = truncate(np.sqrt(W), trunc_par)
    V = V.copy(deep=False).iproject(piv, 1)
    W_kept = W[piv] / new_norm ** 2 * renormalization
    return W_kept, V, err, renormalization
