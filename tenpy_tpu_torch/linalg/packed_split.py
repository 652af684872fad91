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
entries.  The decomposition is ``torch.linalg.svd`` per bucket group (the
JAX package used ``jnp.linalg.svd`` here too; its TPU-only Jacobi and
QR/eigh backends are not ported).
"""

from __future__ import annotations

import numpy as np
import torch

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
                chi_cap=None, multiple=64, total_cap=None, cap_floor=None):
    """Fixed-capacity bond leg for the split of a two-site theta.

    ``theta_legs``: the padded (vL, p0, p1, vR) legs; ``cap_hint``/
    ``cap_floor``: per-charge desired / minimal capacity; ``chi_cap`` bounds
    one sector; ``total_cap`` budgets the capacity above the floors.
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

    sizes = alloc(1.)
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


# -------------------------------------------------------------- the split
def split_truncate(theta_p, plan, chi_max, svd_min=1e-14, backend=None,
                   expand=False, expand_rtol=1e-6):
    """Decompose + truncate a packed theta (static shapes).

    Parameters
    ----------
    theta_p : PackedArray, legs (vL, p0, p1, vR), complete structure matching
        the plan.  Need not be normalized.
    plan : SplitPlan
    chi_max : int
    svd_min : float -- discard Schmidt values below this (relative).
    backend : ``None``, ``'auto'`` or ``'svd'`` (``torch.linalg.svd``).
    expand : bool -- subspace expansion (the engine's mixer): A/B keep the
        orthonormal singular directions of every capacity slot whose raw
        singular value exceeds ``expand_rtol * |theta|``, while S stays zero
        below the truncation threshold, so the state is unchanged but the
        environments couple to the spare capacity.

    Returns
    -------
    A : PackedArray (vL, p, vR), left-isometric (dropped columns zero)
    S : (bond_dim,) tensor, normalized Schmidt values in bond-leg order
    B : PackedArray (vL, p, vR), right-isometric
    err : 0-dim tensor, truncation error (sum of discarded weights)
    renorm : 0-dim tensor, sqrt(sum kept S^2) of the raw theta
    n_kept : 0-dim tensor, number of kept Schmidt values
    """
    if backend not in (None, 'auto', 'svd'):
        raise NotImplementedError(f"device-SVD backend {backend!r} is not "
                                  "ported (only 'svd')")
    order = [theta_p.get_leg_index(l) for l in ('vL', 'p0', 'p1', 'vR')]
    if order != [0, 1, 2, 3]:
        theta_p = theta_p.transpose(order)
    dtype, device = theta_p.dtype, theta_p.device
    tb = plan.tables(device)
    zslot = torch.zeros(1, dtype=dtype, device=device)
    flat = torch.cat([d.reshape(-1) for d in theta_p.data] + [zslot])

    Us, Ss, Vs = [], [], []
    for g, (gidx, cap_mask) in zip(plan.groups, tb['groups']):
        M = flat[gidx].reshape(g.N, g.R, g.C)
        U, S, Vh = torch.linalg.svd(M, full_matrices=False)
        Us.append(U)
        Ss.append(torch.where(cap_mask, S, 0.))
        Vs.append(Vh.transpose(-1, -2))

    allS = torch.cat([S.reshape(-1) for S in Ss])
    # full norm of theta: weight outside the capacity layout is discarded by
    # the split and must show up in err/renorm
    tot = sum(torch.dot(d.reshape(-1), d.reshape(-1)) for d in theta_p.data)
    nrm = torch.sqrt(tot)
    k = min(int(chi_max), allS.shape[0])
    thr_chi = torch.topk(allS, k).values[-1]
    # floor at 1e-14: values below f64 roundoff of the dominant Schmidt value
    # are numerically meaningless
    thr = torch.maximum(thr_chi, max(svd_min, 1e-14) * nrm)
    masks = [(S >= thr) & (S > 0) for S in Ss]
    kept = sum((S.square() * m).sum() for S, m in zip(Ss, masks))
    n_kept = sum(m.sum() for m in masks)
    err = torch.clamp(1. - kept / tot, min=0.)
    renorm = torch.sqrt(kept)
    col_masks = ([m | (S > expand_rtol * nrm) for S, m in zip(Ss, masks)]
                 if expand else masks)

    def masked_flat(Xs):
        return torch.cat([(X * m[:, None, :]).reshape(-1)
                          for X, m in zip(Xs, col_masks)] + [zslot])

    flatU = masked_flat(Us)
    flatV = masked_flat(Vs)
    flatS = torch.cat([(S * m / renorm).reshape(-1)
                       for S, m in zip(Ss, masks)] + [zslot])

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
