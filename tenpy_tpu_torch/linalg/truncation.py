r"""Truncation of Schmidt spectra and truncated decompositions of a wave
function.

Port of ``tenpy_tpu/linalg/truncation.py``: ``TruncationError``,
``truncate``, ``svd_theta`` (what :meth:`~tenpy_tpu_torch.networks.mps.
MPS.compress_svd` runs in the noise-floor rescue of
``canonical_form_infinite``, and the split of the host DMRG engines),
``eigh_rho`` (the density-matrix mixer), the eigh-based SVD
``_eig_based_svd`` and the QR-based split ``decompose_theta_qr_based``
(arXiv:2212.09782; no engine calls it, as in the JAX package).  The
decision which Schmidt values to keep runs in numpy on the host, the
decompositions on the Array's CPU blocks.
"""

from __future__ import annotations

import warnings

import numpy as np

from . import np_conserved as npc
from ..tools.params import asConfig

__all__ = ['TruncationError', 'truncate', 'svd_theta', 'eigh_rho',
           'decompose_theta_qr_based']


class TruncationError:
    r"""Truncation error: ``eps``, the sum of the discarded Schmidt values
    squared, and ``ov``, a lower bound of the overlap with the exact state."""

    def __init__(self, eps=0., ov=1.):
        self.eps = float(eps)
        self.ov = float(ov)

    def copy(self):
        return TruncationError(self.eps, self.ov)

    @classmethod
    def from_norm(cls, norm_new, norm_old=1.):
        """The error of a cut that takes the norm from ``norm_old`` to
        ``norm_new``."""
        eps = 1. - norm_new ** 2 / norm_old ** 2
        return cls(eps, 1. - 2. * eps)

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


def _eig_based_svd(A, need_U=True, need_Vd=True, inner_labels=(None, None),
                   trunc_params=None):
    """Singular values and one side's singular vectors of a 2-leg ``A``
    from the eigendecomposition of a Gram matrix: ``U`` from ``A A^H``
    (``need_U``) or ``V^H`` from ``A^H A`` (``need_Vd``), never both (their
    relative phases would be free); neither gives ``S`` alone.  Returns
    ``(U, S, Vd, err, renormalize)``, truncated by ``trunc_params`` if
    given (else ``S`` normalized).  Singular values below about 1e-8 of
    the largest lose relative accuracy to the squaring."""
    if need_U and need_Vd:
        raise NotImplementedError("one-sided only: need_U xor need_Vd")
    U = Vd = None
    if need_U:
        gram = npc.tensordot(A, A.conj(), axes=[[1], [1]])
        L, U = npc.eigh(gram, sort='>')
        U.iset_leg_labels([A.get_leg_labels()[0], inner_labels[0]])
    elif need_Vd:
        gram = npc.tensordot(A.conj(), A, axes=[[0], [0]])
        L, V = npc.eigh(gram, sort='>')
        Vd = V.iconj().itranspose([1, 0])
        Vd.iset_leg_labels([inner_labels[1], A.get_leg_labels()[1]])
    else:
        gram = npc.tensordot(A, A.conj(), axes=[[1], [1]]) \
            if A.shape[1] >= A.shape[0] \
            else npc.tensordot(A.conj(), A, axes=[[0], [0]])
        L = npc.eigvalsh(gram)
    S = np.sqrt(np.abs(np.asarray(L)))
    if trunc_params is not None:
        piv, renormalize, err = truncate(S, trunc_params)
        S = S[piv] / renormalize
        if need_U:
            U = U.copy(deep=False).iproject(piv, 1)
        if need_Vd:
            Vd = Vd.copy(deep=False).iproject(piv, 0)
    else:
        renormalize = float(np.linalg.norm(S))
        S = S / renormalize
        err = TruncationError()
    return U, S, Vd, err, renormalize


def _qr_theta_Y0(old_qtotal_L, old_qtotal_R, old_bond_leg, theta, move_right,
                 expand, min_block_increase):
    """The start isometry of :func:`decompose_theta_qr_based`: theta with
    its legs ``[(vL.p0), (p1.vR)]`` flattened, and on the side the sweep
    moves away from, per charge sector of the bond, the ``old size +
    increase`` columns of largest norm (the old bond's content plus about
    ``expand * chi`` new directions, at least ``min_block_increase`` per
    sector)."""
    assert min_block_increase >= 0 and expand
    Y0 = theta.copy(deep=False)
    if move_right:
        ax = 1
        Y0.legs = (Y0.legs[0], Y0.legs[1].to_LegCharge())
        Y0.ireplace_label('(p1.vR)', 'vR')
        if np.any(np.asarray(old_qtotal_R) != 0):
            Y0 = Y0.gauge_total_charge('vR', old_qtotal_L)
    else:
        ax = 0
        Y0.legs = (Y0.legs[0].to_LegCharge(), Y0.legs[1])
        Y0.ireplace_label('(vL.p0)', 'vL')
        if np.any(np.asarray(old_qtotal_L) != 0):
            Y0 = Y0.gauge_total_charge('vL', old_qtotal_R)
    _, v_old = old_bond_leg.sort()
    v_new = Y0.legs[ax]
    sizes_old = {tuple(q): int(v_old.slices[j + 1] - v_old.slices[j])
                 for j, q in enumerate(v_old.charges)}
    piv = np.zeros(v_new.ind_len, dtype=bool)
    incr = max(min_block_increase,
               int(v_old.ind_len * expand) // max(v_new.block_number, 1))
    stored = {}      # bond sector -> the blocks that hold it
    for bi, row in enumerate(Y0._qdata):
        stored.setdefault(int(row[ax]), []).append(bi)
    for j_new, q_new in enumerate(v_new.charges):
        width = int(v_new.slices[j_new + 1] - v_new.slices[j_new])
        s_new = min(sizes_old.get(tuple(q_new), 0) + incr, width)
        bis = stored.get(j_new)
        if not bis:
            continue     # a zero sector: its columns would add nothing
        norms = np.zeros(width)
        for bi in bis:
            blk = Y0._data[bi].resolve_conj().numpy()
            norms += np.linalg.norm(blk.reshape(-1, width) if ax == 1
                                    else blk.reshape(width, -1).T,
                                    axis=0) ** 2
        piv[int(v_new.slices[j_new]) + np.argsort(-norms)[:s_new]] = True
    return Y0.iproject(piv, ax)


def decompose_theta_qr_based(old_qtotal_L, old_qtotal_R, old_bond_leg, theta,
                             move_right, expand, min_block_increase,
                             use_eig_based_svd, trunc_params,
                             compute_err, return_both_T):
    r"""QR-based truncated split of theta (arXiv:2212.09782).

    ``theta`` has the combined legs ``[(vL.p0), (p1.vR)]``.  Two QR half
    steps against a start isometry (theta itself, or with ``expand`` the
    columns of :func:`_qr_theta_Y0`) give the isometries ``A_L``, ``B_R``
    and a small bond matrix ``Xi``, whose SVD (or, with
    ``use_eig_based_svd``, :func:`_eig_based_svd`) is truncated.

    Returns ``(T_Lc, S, T_Rc, form, trunc_err, renormalization)``: moving
    right (left) only ``T_Lc`` (``T_Rc``) is sure, the other is None
    unless ``return_both_T`` (or ``compute_err``); ``form`` names each
    one's canonical form (``'Th'`` for the eig-based one that carries
    ``S``).  Without ``compute_err`` the error is NaN."""
    if compute_err:
        return_both_T = True
    Y0 = _qr_theta_Y0(old_qtotal_L, old_qtotal_R, old_bond_leg, theta,
                      move_right, expand, min_block_increase) if expand \
        else theta
    if move_right:
        th1 = npc.tensordot(Y0.conj(), theta,
                            axes=[['(vL*.p0*)'], ['(vL.p0)']])
        th1.iset_leg_labels(['vL', '(p1.vR)'])
        th1.itranspose(['(p1.vR)', 'vL'])
        B_R, _ = npc.qr(th1, inner_labels=['vL', 'vR'], inner_qconj=-1)
        B_R.itranspose(['vL', '(p1.vR)'])
        th0 = npc.tensordot(theta, B_R.conj(),
                            axes=[['(p1.vR)'], ['(p1*.vR*)']])
        th0.iset_leg_labels(['(vL.p0)', 'vR'])
        A_L, Xi = npc.qr(th0, inner_labels=['vR', 'vL'])
    else:
        th0 = npc.tensordot(theta, Y0.conj(),
                            axes=[['(p1.vR)'], ['(p1*.vR*)']])
        th0.iset_leg_labels(['(vL.p0)', 'vR'])
        A_L, _ = npc.qr(th0, inner_labels=['vR', 'vL'])
        th1 = npc.tensordot(A_L.conj(), theta,
                            axes=[['(vL*.p0*)'], ['(vL.p0)']])
        th1.iset_leg_labels(['vL', '(p1.vR)'])
        th1.itranspose(['(p1.vR)', 'vL'])
        B_R, Xi = npc.qr(th1, inner_labels=['vL', 'vR'], inner_qconj=-1)
        B_R.itranspose(['vL', '(p1.vR)'])
        Xi.itranspose(['vL', 'vR'])

    if use_eig_based_svd:
        U, S, Vd, _, renormalization = _eig_based_svd(
            Xi, need_U=move_right, need_Vd=not move_right,
            inner_labels=('vR', 'vL'), trunc_params=trunc_params)
    else:
        U, S, Vd, _, renormalization = svd_theta(Xi, trunc_params)

    T_Lc = T_Rc = None
    form = ['A', 'B']
    if move_right:
        T_Lc = npc.tensordot(A_L, U, axes=[['vR'], ['vL']])
        if return_both_T:
            if use_eig_based_svd:
                T_Rc = npc.tensordot(Xi, B_R, axes=[['vR'], ['vL']])
                T_Rc = npc.tensordot(U.conj(), T_Rc, axes=[['vL*'], ['vL']])
                T_Rc.ireplace_label('vR*', 'vL')
                T_Rc = T_Rc / npc.norm(T_Rc)
                form[1] = 'Th'
            else:
                T_Rc = npc.tensordot(Vd, B_R, axes=[['vR'], ['vL']])
    else:
        T_Rc = npc.tensordot(Vd, B_R, axes=[['vR'], ['vL']])
        if return_both_T:
            if use_eig_based_svd:
                T_Lc = npc.tensordot(A_L, Xi, axes=[['vR'], ['vL']])
                T_Lc = npc.tensordot(T_Lc, Vd.conj(), axes=[['vR'], ['vR*']])
                T_Lc.ireplace_label('vL*', 'vR')
                T_Lc = T_Lc / npc.norm(T_Lc)
                form[0] = 'Th'
            else:
                T_Lc = npc.tensordot(A_L, U, axes=[['vR'], ['vL']])

    if compute_err:
        if use_eig_based_svd:
            theta_approx = npc.tensordot(T_Lc, T_Rc, axes=[['vR'], ['vL']])
        else:
            theta_approx = npc.tensordot(T_Lc.scale_axis(np.asarray(S), 'vR'),
                                         T_Rc, axes=[['vR'], ['vL']])
        N_theta = npc.norm(theta)
        eps = float(npc.norm(theta * (1. / N_theta)
                             - theta_approx * (renormalization / N_theta))) ** 2
        trunc_err = TruncationError(eps, 1. - 2. * eps)
    else:
        trunc_err = TruncationError(np.nan, np.nan)

    if T_Lc is not None:
        T_Lc.ireplace_label('(vL.p0)', '(vL.p)')
    if T_Rc is not None:
        T_Rc.ireplace_label('(p1.vR)', '(p.vR)')
    return T_Lc, S, T_Rc, form, trunc_err, renormalization
