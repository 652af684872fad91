r"""Split + truncation of a packed two-site wavefunction, on the device.

Port of ``tenpy_tpu/linalg/packed_split.py``: given a packed theta with legs
``(vL, p0, p1, vR)``, decompose

    theta  =  A . diag(S) . B        A: (vL, p0, vR),  B: (vL, p1, vR)

with A/B isometric and S cut to ``chi_max`` / ``svd_min``, with static
shapes: the new bond leg is a fixed, size-bucketed *capacity layout*; dropped
Schmidt states are exact zeros (zero columns of A, rows of B, zero S).

The layout change packed theta -> per-bond-sector matrices is one gather per
(rows, cols) bucket group from a host-precomputed index map
(:class:`SplitPlan`); every index is checked on the host when the plan is
built, and the flat buffers carry a trailing zero slot for the padding
entries.  A complex128 theta gives complex A and B and real Schmidt
values; the cut and ``svd_min`` act on S alone.

Decomposition backends, per bucket group (``backend``):

``'svd'`` (also ``None``; ``'auto'`` for a CPU tensor)
    ``torch.linalg.svd`` (cuSOLVER on the card, LAPACK on the host).
``'qr_eigh'``
    The eigh of the Gram matrix ``M^H M`` (its right singular vectors and
    squared singular values), then ``U`` from a QR of ``M V``
    (:func:`_decomp_qr_eigh`): the reference's ``use_eig_based_svd``
    strategy, built from ``torch.linalg.eigh``, ``torch.linalg.qr`` and
    matmuls.  Singular values below about 1e-8 of the largest lose relative
    accuracy to the squaring.
``'qr_eigh32'``
    The same with the eigenvectors seeded by a float32 (complex64) eigh,
    re-orthonormalized and ordered by their f64 Rayleigh quotients.

``'jacobi'`` (also ``'auto'`` for a CUDA tensor)
    The one-sided Jacobi SVD of :mod:`~tenpy_tpu_torch.linalg.jacobi_svd`
    (each matrix swept until converged, at most 30 sweeps; the JAX
    package runs 14), every group of the split in one workspace: on the
    card one launch of the hand-written kernel per split and no host
    synchronisation, on the host its plain version.
``'jacobi32'``
    The same with the bulk of the sweeps in float32 (complex64), then
    Newton-Schulz and the polish in the working type: two launches per
    split.

The JAX package resolves ``None`` as ``'auto'``, hence ``'jacobi'`` off
the CPU; here ``None`` stays ``'svd'`` everywhere.
"""

from __future__ import annotations

import numpy as np
import torch

from . import jacobi_svd as js
from . import packed as pk
from .charges import LegCharge, QTYPE
from .padding import bucket_size

__all__ = ['bond_layout', 'SplitPlan', 'split_plan', 'split_truncate',
           'scale_bond_plan', 'scale_bond']


# --------------------------------------------------------------- bond layout
def _group_pairs(legs, qconjs, qtotal_part, chinfo):
    """All (sector_i, sector_j) pairs of two legs grouped by total charge."""
    groups = {}
    l0, l1 = legs
    for s0 in range(l0.block_number):
        q0 = np.asarray(l0.charges[s0], QTYPE) * qconjs[0]
        for s1 in range(l1.block_number):
            q = q0 + np.asarray(l1.charges[s1], QTYPE) * qconjs[1]
            key = tuple(chinfo.make_valid(q + qtotal_part))
            groups.setdefault(key, []).append((s0, s1))
    return groups


def bond_layout(theta_legs, qtotal_theta, qtotal_A, cap_hint=None,
                chi_cap=None, multiple=64, total_cap=None, cap_floor=None,
                full_rank=False):
    """Fixed-capacity bond leg for the split of a two-site theta.

    ``theta_legs``: the padded (vL, p0, p1, vR) legs; ``cap_hint``/
    ``cap_floor``: per-charge desired / minimal capacity; ``chi_cap`` bounds
    one sector; ``total_cap`` budgets the capacity above the floors.  With
    ``full_rank`` every sector gets the (bucketed) capacity of its full
    rank instead, so that only the cut of :func:`split_truncate` limits
    the kept values, as in the host's SVD.
    Returns the bond LegCharge with qconj=+1 (A's bond leg is its conj).
    """
    chinfo = theta_legs[0].chinfo
    qtotal_theta = np.asarray(qtotal_theta, QTYPE)
    qtotal_A = np.asarray(qtotal_A, QTYPE)
    rows = _group_pairs(theta_legs[:2],
                        [theta_legs[0].qconj, theta_legs[1].qconj],
                        -qtotal_A, chinfo)
    qtotal_B = chinfo.make_valid(qtotal_theta - qtotal_A)
    cols = _group_pairs(theta_legs[2:],
                        [theta_legs[2].qconj, theta_legs[3].qconj],
                        np.zeros_like(qtotal_B), chinfo)
    cols = {tuple(chinfo.make_valid(qtotal_B - np.asarray(k, QTYPE))): v
            for k, v in cols.items()}
    charges, hints, limits = [], [], []
    for q in sorted(set(rows) & set(cols)):
        R = sum(int(theta_legs[0].slices[a + 1] - theta_legs[0].slices[a])
                * int(theta_legs[1].slices[b + 1] - theta_legs[1].slices[b])
                for a, b in rows[q])
        C = sum(int(theta_legs[2].slices[c + 1] - theta_legs[2].slices[c])
                * int(theta_legs[3].slices[d + 1] - theta_legs[3].slices[d])
                for c, d in cols[q])
        lim = min(R, C)
        if chi_cap is not None:
            lim = min(lim, int(chi_cap))
        charges.append(q)
        hints.append(max(int((cap_hint or {}).get(q, 1)), 1))
        limits.append(lim)
    floors = [min(int((cap_floor or {}).get(q, 1)), lim)
              for q, lim in zip(charges, limits)]

    def alloc(scale):
        return [min(bucket_size(max(int(np.ceil(h * scale)), f, 1), multiple),
                    bucket_size(lim, multiple))
                for h, f, lim in zip(hints, floors, limits)]

    sizes = [bucket_size(lim, multiple) for lim in limits] if full_rank \
        else alloc(1.)
    if total_cap is not None and sum(sizes) > total_cap:
        # the floor mass is mandatory; the budget bounds the headroom above
        # it, shared out in proportion to the hints by bisection
        floor_sizes = alloc(0.)
        budget = max(int(total_cap),
                     sum(floor_sizes) + max(int(total_cap) - int(chi_cap or 0),
                                            0))
        if sum(floor_sizes) >= budget:
            sizes = floor_sizes
        elif sum(sizes) > budget:
            lo, hi = 0., 1.
            for _ in range(30):
                mid = 0.5 * (lo + hi)
                if sum(alloc(mid)) > budget:
                    hi = mid
                else:
                    lo = mid
            sizes = alloc(lo)
    slices = np.concatenate([[0], np.cumsum(sizes)]).astype(np.intp)
    charges = np.array(charges, QTYPE).reshape(len(charges), chinfo.qnumber)
    return LegCharge(chinfo, slices, charges, 1)


# ----------------------------------------------------------------- the plan
class _SplitGroup:
    """One (R, C)-bucket of bond sectors."""
    __slots__ = ('R', 'C', 'K', 'N', 'idx', 'cap_mask', 'sectors')

    def __init__(self, R, C, N, idx, cap_mask, sectors):
        self.R, self.C, self.K, self.N = R, C, min(R, C), N
        self.idx = idx            # int (N, R, C) into flat theta (zero slot)
        self.cap_mask = cap_mask  # bool (N, K): k < capacity of sector
        self.sectors = sectors    # bond-leg sector indices, len N


class SplitPlan:
    """Host-precomputed index maps for :func:`split_truncate`, with their
    device copies cached per device (:meth:`tables`)."""
    __slots__ = ('groups', 'A_struct', 'B_struct', 'A_idx', 'B_idx', 'S_idx',
                 'bond', 'flat_lens', '_dev')

    def tables(self, device):
        t = self._dev.get(device)
        if t is None:
            def dev(x):
                return torch.from_numpy(np.ascontiguousarray(x)).to(device)
            t = self._dev[device] = {
                'groups': [(dev(g.idx.reshape(-1).astype(np.int64)),
                            dev(g.cap_mask)) for g in self.groups],
                'A': [dev(ii.reshape(-1).astype(np.int64))
                      for ii in self.A_idx],
                'B': [dev(ii.reshape(-1).astype(np.int64))
                      for ii in self.B_idx],
                'S': dev(self.S_idx.astype(np.int64)),
            }
        return t


def _flat_offsets(shapes, qdatas):
    offs = []
    off = 0
    for shape, q in zip(shapes, qdatas):
        offs.append(off)
        off += q.shape[0] * int(np.prod(shape, dtype=np.int64))
    return offs, off


_SPLIT_PLAN_CACHE = {}


def split_plan(theta_p, bond, qtotal_A, group_multiple=64):
    """Build (or fetch) the :class:`SplitPlan` for a packed theta.

    ``theta_p`` has legs labelled ``vL, p0, p1, vR`` (any order) and a
    complete packed structure; ``bond`` comes from :func:`bond_layout`.
    """
    order = [theta_p.get_leg_index(l) for l in ('vL', 'p0', 'p1', 'vR')]
    if order != [0, 1, 2, 3]:
        theta_p = theta_p.transpose(order)
    key = (theta_p.struct_sig(), bond,
           tuple(int(x) for x in np.ravel(qtotal_A)), group_multiple)
    plan = _SPLIT_PLAN_CACHE.get(key)
    if plan is None:
        plan = _build_split_plan(theta_p, bond, qtotal_A, group_multiple)
        pk._cache_put(_SPLIT_PLAN_CACHE, key, plan, 256)
    return plan


def _build_split_plan(theta_p, bond, qtotal_A, group_multiple):
    legs = theta_p.legs
    chinfo = legs[0].chinfo
    qtotal_A = np.asarray(chinfo.make_valid(np.asarray(qtotal_A, QTYPE)),
                          QTYPE)
    qtotal_B = np.asarray(chinfo.make_valid(
        np.asarray(theta_p.qtotal, QTYPE) - qtotal_A), QTYPE)
    bond_pos = {tuple(np.asarray(bond.charges[b], QTYPE)): b
                for b in range(bond.block_number)}
    caps = np.diff(bond.slices).astype(int)
    size = [np.diff(l.slices).astype(int) for l in legs]

    # ---- per bond sector: ordered row/col pair lists with offsets
    rows_of = {b: [] for b in range(bond.block_number)}   # (s_vL, s_p0)
    cols_of = {b: [] for b in range(bond.block_number)}   # (s_p1, s_vR)
    for a in range(legs[0].block_number):
        qa = np.asarray(legs[0].charges[a], QTYPE) * legs[0].qconj
        for c in range(legs[1].block_number):
            q = chinfo.make_valid(
                qa + np.asarray(legs[1].charges[c], QTYPE) * legs[1].qconj
                - qtotal_A)
            b = bond_pos.get(tuple(np.asarray(q, QTYPE)))
            if b is not None:
                rows_of[b].append((a, c))
    for c in range(legs[2].block_number):
        qc = np.asarray(legs[2].charges[c], QTYPE) * legs[2].qconj
        for d in range(legs[3].block_number):
            q = chinfo.make_valid(
                qtotal_B - qc
                - np.asarray(legs[3].charges[d], QTYPE) * legs[3].qconj)
            b = bond_pos.get(tuple(np.asarray(q, QTYPE)))
            if b is not None:
                cols_of[b].append((c, d))
    row_off, col_off = {}, {}
    R_of = np.zeros(bond.block_number, int)
    C_of = np.zeros(bond.block_number, int)
    for b in range(bond.block_number):
        off = 0
        for (a, c) in rows_of[b]:
            row_off[(b, a, c)] = off
            off += size[0][a] * size[1][c]
        R_of[b] = off
        off = 0
        for (c, d) in cols_of[b]:
            col_off[(b, c, d)] = off
            off += size[2][c] * size[3][d]
        C_of[b] = off

    # ---- group sectors by bucketed (R, C)
    by_rc = {}
    for b in range(bond.block_number):
        if R_of[b] == 0 or C_of[b] == 0 or caps[b] == 0:
            continue
        by_rc.setdefault((bucket_size(int(R_of[b]), group_multiple),
                          bucket_size(int(C_of[b]), group_multiple)),
                         []).append(b)

    toffs, theta_len = _flat_offsets(theta_p.shapes, theta_p.qdatas)
    tpos = {}
    for s, q in enumerate(theta_p.qdatas):
        blk = int(np.prod(theta_p.shapes[s], dtype=np.int64))
        for n, row in enumerate(q):
            tpos[tuple(int(x) for x in row)] = toffs[s] + n * blk

    groups = []
    sector_group = {}   # bond sector -> (g, n)
    for (R, C) in sorted(by_rc):
        secs = by_rc[(R, C)]
        N = len(secs)
        K = min(R, C)
        idx = np.full((N, R, C), -1, np.int64)
        cap_mask = np.zeros((N, K), bool)
        for n, b in enumerate(secs):
            sector_group[b] = (len(groups), n)
            cap_mask[n, :min(int(caps[b]), K)] = True
            for (a, c) in rows_of[b]:
                ro = row_off[(b, a, c)]
                rs = size[0][a] * size[1][c]
                for (cc, d) in cols_of[b]:
                    base = tpos.get((a, c, cc, d))
                    if base is None:
                        continue   # not charge-allowed given qtotal_theta
                    co = col_off[(b, cc, d)]
                    cs = size[2][cc] * size[3][d]
                    idx[n, ro:ro + rs, co:co + cs] = (
                        base + np.arange(rs * cs, dtype=np.int64)
                    ).reshape(rs, cs)
        groups.append(_SplitGroup(R, C, N, idx, cap_mask, list(secs)))

    # ---- flat U / V / S offsets (stacked per group)
    uoffs, voffs, soffs = [], [], []
    uo = vo = so = 0
    for g in groups:
        uoffs.append(uo)
        voffs.append(vo)
        soffs.append(so)
        uo += g.N * g.R * g.K
        vo += g.N * g.C * g.K
        so += g.N * g.K

    # ---- A assembly
    A_legs = (legs[0], legs[1], bond.conj())
    A_shapes, A_qdatas = pk.complete_structure(
        A_legs, tuple(int(x) for x in qtotal_A))
    A_idx = []
    for shape, qd in zip(A_shapes, A_qdatas):
        d0, d1, db = shape
        ii = np.full((qd.shape[0], d0 * d1, db), -1, np.int64)
        for n, (a, c, b) in enumerate(qd):
            gn = sector_group.get(int(b))
            ro = row_off.get((int(b), int(a), int(c)))
            if gn is None or ro is None:
                continue
            g_i, n_i = gn
            g = groups[g_i]
            rs = size[0][a] * size[1][c]
            kk = min(int(caps[b]), g.K, db)
            base = uoffs[g_i] + (n_i * g.R + ro) * g.K
            ii[n, :rs, :kk] = (base + np.arange(rs)[:, None] * g.K
                               + np.arange(kk)[None, :])
        A_idx.append(ii.reshape((qd.shape[0],) + tuple(shape)))

    # ---- B assembly (B = V^T)
    B_legs = (bond, legs[2], legs[3])
    B_shapes, B_qdatas = pk.complete_structure(
        B_legs, tuple(int(x) for x in qtotal_B))
    B_idx = []
    for shape, qd in zip(B_shapes, B_qdatas):
        db, d2, d3 = shape
        ii = np.full((qd.shape[0], db, d2 * d3), -1, np.int64)
        for n, (b, c, d) in enumerate(qd):
            gn = sector_group.get(int(b))
            co = col_off.get((int(b), int(c), int(d)))
            if gn is None or co is None:
                continue
            g_i, n_i = gn
            g = groups[g_i]
            cs = size[2][c] * size[3][d]
            kk = min(int(caps[b]), g.K, db)
            base = voffs[g_i] + n_i * g.C * g.K
            ii[n, :kk, :cs] = (base + (co + np.arange(cs))[None, :] * g.K
                               + np.arange(kk)[:, None])
        B_idx.append(ii.reshape((qd.shape[0],) + tuple(shape)))

    # ---- S assembly: bond-leg-ordered flat vector
    bond_dim = int(bond.slices[-1])
    S_idx = np.full(bond_dim, -1, np.int64)
    for b in range(bond.block_number):
        gn = sector_group.get(b)
        if gn is None:
            continue
        g_i, n_i = gn
        g = groups[g_i]
        kk = min(int(caps[b]), g.K)
        start = int(bond.slices[b])
        S_idx[start:start + kk] = soffs[g_i] + n_i * g.K + np.arange(kk)

    # every map points into its flat buffer or at the zero slot appended at
    # its end (position == flat length); gathers on the device do not check
    def to_zero_slot(ii, flat_len):
        ii = np.where(ii < 0, flat_len, ii)
        if ii.size and (ii.min() < 0 or ii.max() > flat_len):
            raise AssertionError("split plan: index out of range")
        return ii

    for g in groups:
        g.idx = to_zero_slot(g.idx, theta_len)
    plan = SplitPlan.__new__(SplitPlan)
    plan.flat_lens = (theta_len, uo, vo, so)
    plan.groups = groups
    plan.A_struct = (A_legs, tuple(int(x) for x in qtotal_A), A_shapes,
                     A_qdatas)
    plan.B_struct = (B_legs, tuple(int(x) for x in qtotal_B), B_shapes,
                     B_qdatas)
    plan.A_idx = [to_zero_slot(ii, uo) for ii in A_idx]
    plan.B_idx = [to_zero_slot(ii, vo) for ii in B_idx]
    plan.S_idx = to_zero_slot(S_idx, so)
    plan.bond = bond
    plan._dev = {}
    return plan


# ------------------------------------------------------ the decompositions
def _decomp_qr_eigh(M, f32_seed=False):
    """``(U, S, V)`` with ``M = U diag(S) V^H`` for a batch of matrices
    ``M`` (N, R, C), singular values descending, from the Gram matrix's
    eigh and a QR (matmul, eigh and qr only; ``tenpy_tpu``'s
    ``_decomp_qr_eigh``).

    For ``R >= C``: ``rho = M^H M`` is shifted by ``1e-13 / C`` of its
    trace on the diagonal (the padded groups make it exactly singular; the
    shift leaves the eigenvectors and is subtracted exactly from the
    eigenvalues), ``S = sqrt(max(w - shift, 0))`` and ``V`` its eigenvectors,
    descending, and ``U`` the Q of ``M V = Q R`` with each column's phase
    set by ``diag(R)``, so that ``U S = M V``.  (``tenpy_tpu``, which takes
    real matrices only, multiplies by the conjugate of that sign: the same
    for a real sign.)  A wide ``M`` is decomposed through ``M^H``.
    ``f32_seed`` takes the eigenvectors from a float32 (complex64) eigh of
    ``rho`` divided by its trace (where that is not 0), orthonormalizes
    them by a QR in the working type and orders them by their Rayleigh
    quotients in ``rho``, which are then the eigenvalues.  The division
    leaves the eigenvectors; ``tenpy_tpu`` casts ``rho`` as it is, which
    cuSOLVER's complex64 eigh failed to converge on for the padded,
    small-trace groups of a chi=512 TEBD update (NVIDIA H100 80GB HBM3,
    700.00 W)."""
    R, C = M.shape[-2], M.shape[-1]
    Mh = M.conj().transpose(-1, -2)
    if R < C:
        V, S, U = _decomp_qr_eigh(Mh, f32_seed)
        return U, S, V
    rho = torch.matmul(Mh, M)
    shift = (1e-13 / C) * torch.diagonal(rho, dim1=-2, dim2=-1).sum(-1).real
    rho = rho + shift[:, None, None] * torch.eye(C, dtype=rho.dtype,
                                                 device=rho.device)
    if f32_seed:
        low = torch.complex64 if rho.is_complex() else torch.float32
        tr = torch.diagonal(rho, dim1=-2, dim2=-1).sum(-1).real
        scale = torch.where(tr > 0, tr, torch.ones_like(tr))
        _, V0 = torch.linalg.eigh((rho / scale[:, None, None]).to(low))
        V, _ = torch.linalg.qr(V0.to(M.dtype).flip(-1))
        w = (V.conj() * torch.matmul(rho, V)).sum(-2).real
        order = torch.argsort(w, dim=-1, descending=True)
        w = w.gather(-1, order)
        V = V.gather(-1, order[:, None, :].expand(V.shape))
    else:
        w, V = torch.linalg.eigh(rho)
        w, V = w.flip(-1), V.flip(-1)
    S = torch.sqrt(torch.clamp(w - shift[:, None], min=0.))
    U, Ru = torch.linalg.qr(torch.matmul(M, V))
    d = torch.diagonal(Ru, dim1=-2, dim2=-1)
    big = d.abs() > 0
    sgn = torch.where(big, d / torch.where(big, d.abs(), 1.).to(d.dtype),
                      torch.ones_like(d))
    return U * sgn[:, None, :], S, V


def _decomp(M, backend):
    """``(U, S, Vh)`` of a batch of matrices by ``backend`` (``'svd'`` or
    an eigh-based one)."""
    if backend == 'svd':
        return torch.linalg.svd(M, full_matrices=False)
    U, S, V = _decomp_qr_eigh(M, f32_seed=backend == 'qr_eigh32')
    return U, S, V.conj().transpose(-1, -2)


def _resolve_backend(backend, device):
    """The backend's name after its defaults: ``None`` is ``'svd'``;
    ``'auto'`` is ``'svd'`` for a CPU tensor and ``'jacobi'`` on the card,
    as in ``tenpy_tpu``."""
    if backend not in (None, 'auto', 'svd', 'qr_eigh', 'qr_eigh32', 'jacobi',
                       'jacobi32'):
        raise ValueError(f"unknown device-SVD backend {backend!r}")
    if backend == 'auto':
        return 'svd' if device.type == 'cpu' else 'jacobi'
    return backend or 'svd'


# -------------------------------------------------------------- the split
def _host_cut_masks(Ss, tot, chi_max, svd_min, trunc_cut):
    """The kept values of the host's ``truncate`` on the singular values
    ``Ss`` (per group, unnormalized; ``tot`` their total weight): the
    largest number ``k`` admitted by ``chi_max``, ``svd_min`` (relative)
    and ``trunc_cut`` (the discarded weight stays at most ``trunc_cut**2``),
    a constraint that admits no ``k`` dropped, at least one value, and the
    ``k`` largest values kept by rank (one of exactly equal values at the
    cut, not both).  No host synchronisation."""
    if trunc_cut >= 1.:
        raise ValueError("trunc_cut >= 1.")
    sizes = [S.numel() for S in Ss]
    allS = torch.cat([S.reshape(-1) for S in Ss])
    n = allS.shape[0]
    order = torch.argsort(allS, descending=True, stable=True)
    desc = allS[order]
    k = torch.full((), n, dtype=torch.int64, device=allS.device)
    if chi_max is not None and chi_max > 0:
        k = torch.clamp(k, max=int(chi_max))
    counts = []
    if svd_min is not None:
        counts.append((desc >= svd_min * torch.sqrt(tot)).sum())
    tail = torch.flip(torch.cumsum(torch.flip(desc.square(), [0]), 0), [0])
    counts.append((tail > trunc_cut * trunc_cut * tot).sum())
    for c in counts:
        k = torch.where(c > 0, torch.minimum(k, c), k)
    k = torch.clamp(k, min=1)
    keep = torch.empty(n, dtype=torch.bool, device=allS.device)
    keep[order] = torch.arange(n, device=allS.device) < k
    keep &= allS > 0
    return [m.reshape(S.shape) for m, S in zip(torch.split(keep, sizes),
                                                Ss)]


def split_truncate(theta_p, plan, chi_max, svd_min=1e-14, backend=None,
                   expand=False, expand_rtol=1e-6, trunc_cut=None):
    """Decompose + truncate a packed theta (static shapes).

    Parameters
    ----------
    theta_p : PackedArray, legs (vL, p0, p1, vR), complete structure matching
        the plan.  Need not be normalized.
    plan : SplitPlan
    chi_max : int
    svd_min : float -- discard Schmidt values below this (relative).
    backend : ``None`` or ``'svd'`` (``torch.linalg.svd``), ``'qr_eigh'``
        or ``'qr_eigh32'`` (:func:`_decomp_qr_eigh`), ``'jacobi'`` or
        ``'jacobi32'`` (:func:`~tenpy_tpu_torch.linalg.jacobi_svd.
        decomp_jacobi`, every group in one call), ``'auto'`` (``'svd'`` on
        the host, ``'jacobi'`` on the card).
    expand : bool -- subspace expansion (the engine's mixer): A/B keep the
        orthonormal singular directions of every capacity slot whose raw
        singular value exceeds ``expand_rtol * |theta|``, while S stays zero
        below the truncation threshold, so the state is unchanged but the
        environments couple to the spare capacity.
    trunc_cut : float or None -- with a value, the cut is the host
        ``truncate``'s (``chi_max``, ``svd_min`` and ``trunc_cut``, by
        rank; :func:`_host_cut_masks`; 0 for none) and ``err`` its
        discarded weight, as the host computes them; with None, every
        value from the ``chi_max``-th largest and from ``max(svd_min,
        1e-14) |theta|`` up is kept and ``err`` is ``1 - kept / |theta|^2``,
        which also counts weight outside the capacity layout.

    Returns
    -------
    A : PackedArray (vL, p, vR), left-isometric (dropped columns zero)
    S : (bond_dim,) tensor, normalized Schmidt values in bond-leg order
    B : PackedArray (vL, p, vR), right-isometric
    err : 0-dim tensor, truncation error (sum of discarded weights)
    renorm : 0-dim tensor, sqrt(sum kept S^2) of the raw theta
    n_kept : 0-dim tensor, number of kept Schmidt values
    """
    backend = _resolve_backend(backend, theta_p.device)
    order = [theta_p.get_leg_index(l) for l in ('vL', 'p0', 'p1', 'vR')]
    if order != [0, 1, 2, 3]:
        theta_p = theta_p.transpose(order)
    dtype, device = theta_p.dtype, theta_p.device
    tb = plan.tables(device)
    zslot = torch.zeros(1, dtype=dtype, device=device)
    zslot_S = zslot.real    # S is real for complex theta too
    flat = torch.cat([d.reshape(-1) for d in theta_p.data] + [zslot])

    Ms = [flat[gidx].reshape(g.N, g.R, g.C)
          for g, (gidx, _) in zip(plan.groups, tb['groups'])]
    if backend in ('jacobi', 'jacobi32'):
        # one call for every group (one kernel launch on the card, two for
        # 'jacobi32'); Vh's transpose is conj(V)
        USVs = [(U, S, V.conj()) for U, S, V in js.decomp_jacobi(
            Ms, bulk_f32=backend == 'jacobi32')]
    else:
        USVs = [(U, S, Vh.transpose(-1, -2))
                for U, S, Vh in (_decomp(M, backend) for M in Ms)]
    Us = [U for U, _, _ in USVs]
    Ss = [torch.where(cap_mask, S, 0.)
          for (_, S, _), (_, cap_mask) in zip(USVs, tb['groups'])]
    Vs = [V for _, _, V in USVs]

    allS = torch.cat([S.reshape(-1) for S in Ss])
    # full norm of theta: weight outside the capacity layout is discarded by
    # the split and must show up in err/renorm
    tot = pk.norm_sq(theta_p)
    nrm = torch.sqrt(tot)
    if trunc_cut is None:
        k = min(int(chi_max), allS.shape[0])
        thr_chi = torch.topk(allS, k).values[-1]
        # floor at 1e-14: values below f64 roundoff of the dominant Schmidt
        # value are numerically meaningless
        thr = torch.maximum(thr_chi, max(svd_min, 1e-14) * nrm)
        masks = [(S >= thr) & (S > 0) for S in Ss]
    else:
        masks = _host_cut_masks(Ss, tot, chi_max, svd_min, trunc_cut)
    kept = sum((S.square() * m).sum() for S, m in zip(Ss, masks))
    n_kept = sum(m.sum() for m in masks)
    if trunc_cut is None:
        err = torch.clamp(1. - kept / tot, min=0.)
    else:
        # the host's err: the discarded singular values' weight, free of the
        # roundoff of 1 - kept / tot
        err = sum((S.square() * ~m).sum() for S, m in zip(Ss, masks)) / tot
    renorm = torch.sqrt(kept)
    col_masks = ([m | (S > expand_rtol * nrm) for S, m in zip(Ss, masks)]
                 if expand else masks)

    def masked_flat(Xs):
        return torch.cat([(X * m[:, None, :]).reshape(-1)
                          for X, m in zip(Xs, col_masks)] + [zslot])

    flatU = masked_flat(Us)
    flatV = masked_flat(Vs)
    flatS = torch.cat([(S * m / renorm).reshape(-1)
                       for S, m in zip(Ss, masks)] + [zslot_S])

    def assemble(flat_ch, idx_list, shapes, qdatas):
        return [flat_ch[ii].reshape((qd.shape[0],) + shape)
                for ii, shape, qd in zip(idx_list, shapes, qdatas)]

    A_legs, qtot_A, A_shapes, A_qdatas = plan.A_struct
    A = pk.PackedArray(A_legs, qtot_A, ('vL', 'p', 'vR'), A_shapes, A_qdatas,
                       assemble(flatU, tb['A'], A_shapes, A_qdatas), dtype)
    B_legs, qtot_B, B_shapes, B_qdatas = plan.B_struct
    B = pk.PackedArray(B_legs, qtot_B, ('vL', 'p', 'vR'), B_shapes, B_qdatas,
                       assemble(flatV, tb['B'], B_shapes, B_qdatas), dtype)
    return A, flatS[tb['S']], B, err, renorm, n_kept


# ---------------------------------------------------- bond-S scaling (guess)
class _ScalePlan:
    __slots__ = ('axis', 'idx', '_dev')

    def __init__(self, axis, idx):
        self.axis, self.idx, self._dev = axis, idx, {}

    def tables(self, device):
        t = self._dev.get(device)
        if t is None:
            t = self._dev[device] = [torch.from_numpy(ii).to(device)
                                     for ii in self.idx]
        return t


_SCALE_PLAN_CACHE = {}


def scale_bond_plan(p, axis):
    """Static gather maps to scale PackedArray ``p`` along bond leg ``axis``."""
    axis = p.get_leg_index(axis)
    key = (p.struct_sig(), axis)
    plan = _SCALE_PLAN_CACHE.get(key)
    if plan is None:
        bond = p.legs[axis]
        idx = []
        for shape, qd in zip(p.shapes, p.qdatas):
            starts = np.asarray(bond.slices, np.int64)[qd[:, axis]]
            idx.append(starts[:, None] + np.arange(shape[axis])[None, :])
        plan = _ScalePlan(axis, idx)
        pk._cache_put(_SCALE_PLAN_CACHE, key, plan, 1024)
    return plan


def scale_bond(p, S_flat, plan):
    """Multiply packed ``p`` by bond values ``S_flat`` along the planned
    axis."""
    out = []
    for d, ii in zip(p.data, plan.tables(S_flat.device)):
        shape = [d.shape[0]] + [1] * (d.dim() - 1)
        shape[1 + plan.axis] = d.shape[1 + plan.axis]
        out.append(d * S_flat[ii].reshape(shape).to(d.dtype))
    return p._like(out)
