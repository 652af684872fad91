r"""Device-resident two-site DMRG sweeps on the bucket-packed layout.

Port of ``tenpy_tpu/algorithms/packed_dmrg.py`` (``DeviceSweepEngine`` and
its layout helpers).  The whole sweep state lives on one device; each site
update is

    theta = C . B_next            (guess; center-matrix carry)
    E0, theta = Lanczos (theta)   (packed matvec, early exit)
    A, S, B   = split_truncate    (batched SVD per charge sector, top-chi cut)
    LP'/RP'   = env update        (packed tensordot chain)

Every GEMM of the update is a packed tensordot, so on a CUDA device each
is one launch of the hand-written kernel of
:mod:`~tenpy_tpu_torch.linalg.grouped_gemm`.  Shapes are static: every bond
has a fixed, size-bucketed capacity layout, and dropped Schmidt states are
exact zeros.  PyTorch runs eagerly, so the JAX version's jit cache and
precompile step have no counterpart; the plans are cached on the host.

The engine starts from an :class:`~tenpy_tpu_torch.networks.exchange.
ExchangeState` (the host tensors after ``tenpy_tpu``'s host-side setup) and
returns its state with :meth:`DeviceSweepEngine.export_state`.  Finite and
infinite (iDMRG) bc; the ``mixer`` option is the subspace expansion of
:func:`~tenpy_tpu_torch.linalg.packed_split.split_truncate`.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..linalg import packed as pk
from ..linalg import packed_split as ps
from ..linalg.charges import QTYPE, LegCharge
from ..linalg.padding import bucket_size, embed_array, pad_leg
from ..networks import exchange
from .mps_common import _lanczos_K_2site_packed_impl, BUCKET_MULTIPLE

logger = logging.getLogger(__name__)

__all__ = ['DeviceSweepEngine', 'uniform_capacity_layout',
           'capacity_bond_layouts', 'pack_S_from_leg', 'pack_bond_S']


def _vL_leg(state, i):
    """The (qconj=+1) left bond leg of site ``i`` (``i == L``: the right
    boundary of a finite chain)."""
    if state.finite and i == state.L:
        leg = state.B[state.L - 1].get_leg('vR').conj()
    else:
        leg = state.B[i % state.L].get_leg('vL')
    return leg if leg.qconj == 1 else leg.conj()


def uniform_capacity_layout(state, chi_max, multiple, cap_factor=1.3,
                            total_cap_factor=1.5, n_hops=2):
    """One shared capacity bond layout for all bonds of a regauged iMPS.

    Needs the uniform charge gauge (all bond legs in one charge frame, all
    site qtotals equal) and identical sites.  The layout is the union of
    every bond's current sectors (per-sector capacity = max over bonds),
    widened by the update-reachability passes of :func:`ps.bond_layout`.
    Returns ``(bond, psi_legs)`` with ``bond[i]`` the same LegCharge for every
    ``i``.
    """
    L = state.L
    chinfo = state.chinfo
    p_legs = [state.B[i].get_leg('p') for i in range(L)]
    if any(leg != p_legs[0] for leg in p_legs[1:]):
        raise ValueError("uniform layout needs identical physical legs")
    qtots = [np.asarray(state.B[i].qtotal, QTYPE) for i in range(L)]
    if any(np.any(q != qtots[0]) for q in qtots[1:]):
        raise ValueError("uniform layout needs equal site qtotals "
                         "(the uniform charge gauge)")
    qeff = qtots[0]
    psi_legs = [_vL_leg(state, i) for i in range(L)]
    floor = {}
    for leg in psi_legs:
        for s in range(leg.block_number):
            q = tuple(np.asarray(leg.charges[s], QTYPE))
            n = int(leg.slices[s + 1] - leg.slices[s])
            floor[q] = max(floor.get(q, 0), n)
    charges = sorted(floor)
    sizes = [bucket_size(floor[q], multiple) for q in charges]
    U = LegCharge(chinfo,
                  np.concatenate([[0], np.cumsum(sizes)]).astype(np.intp),
                  np.array(charges, QTYPE).reshape(len(charges),
                                                   chinfo.qnumber), 1)
    hint = {q: int(np.ceil(n * cap_factor)) for q, n in floor.items()}
    qtotal_th = chinfo.make_valid(2 * qeff)
    for _ in range(max(2, int(n_hops))):
        U = ps.bond_layout((U, p_legs[0], p_legs[0], U.conj()), qtotal_th,
                           qeff, cap_hint=hint, cap_floor=floor,
                           chi_cap=chi_max, multiple=multiple,
                           total_cap=int(np.ceil(total_cap_factor * chi_max)))
    return [U] * L, psi_legs


def _bond0_transition(A_old, A_new):
    """Exact old->new bond-0 basis transition of an iDMRG sweep.

    The leftward wrap update rewrites bond 0; its input and output
    ``A[L-1]`` share their ``vL`` basis, so
    ``M0[a, b] = sum_{vL,p} A_old[vL,p,a] A_new[vL,p,b]`` is the transition
    between the old and new bond-0 bases (used by :meth:`export_state`)."""
    return pk.tensordot(A_old.conj(), A_new, axes=(['vL*', 'p*'], ['vL', 'p']))


def _env_update_L(LP, A, W):
    """LP' strictly left of site i+1 from LP (left of i), A-form tensor, W.

    LP legs (vR*, wR, vR); A legs (vL, p, vR); W legs (wL, wR, p, p*)."""
    x = pk.tensordot(LP, A, axes=(['vR'], ['vL']))            # vR* wR p vR
    x = pk.tensordot(x, W, axes=(['wR', 'p'], ['wL', 'p*']))  # vR* vR wR p
    x = pk.tensordot(x, A.conj(), axes=(['vR*', 'p'], ['vL*', 'p*']))
    return x.transpose(['vR*', 'wR', 'vR'])


def _env_update_R(RP, B, W):
    """RP' strictly right of site i-1 from RP (right of i), B-form tensor, W.

    RP legs (wL, vL, vL*); B legs (vL, p, vR)."""
    x = pk.tensordot(B, RP, axes=(['vR'], ['vL']))            # vL p wL vL*
    x = pk.tensordot(x, W, axes=(['wL', 'p'], ['wR', 'p*']))  # vL vL* wL p
    x = pk.tensordot(x, B.conj(), axes=(['vL*', 'p'], ['vR*', 'p*']))
    return x.transpose(['wL', 'vL', 'vL*'])


def capacity_bond_layouts(state, chi_max, multiple, cap_factor=1.3,
                          total_cap_factor=1.5, n_hops=2):
    """Fixed padded capacity layouts, one per bond.

    ``bond[i]`` is the (qconj=+1) vL leg of site ``i`` padded to bucket
    multiples; interior bonds are widened to every ``n_hops``-update-reachable
    charge sector, with per-sector capacity grown by ``cap_factor`` and the
    total budgeted to ``total_cap_factor * chi_max``.
    Returns ``(bond, psi_leg)``: the layouts and the unpadded legs.
    """
    L, finite = state.L, state.finite
    cur_legs = [_vL_leg(state, i) for i in range(L + 1 if finite else L)]
    p_legs = [state.B[i].get_leg('p') for i in range(L)]
    qtot = [np.asarray(state.B[i].qtotal, QTYPE) for i in range(L)]
    chinfo = state.chinfo

    def _bond(i, bond_list):
        return bond_list[i if finite else i % L]

    bond = [pad_leg(leg, multiple)[0] for leg in cur_legs]
    interior = list(range(1, L)) if finite else list(range(1, L)) + [0]
    # >= two passes: capacities are clipped by min(rows, cols) computed from
    # the neighbour layouts, so neighbours must be widened first
    for i in interior * max(2, int(n_hops)):
        iL, iR = (i - 1) % L, i % L
        cur = cur_legs[i if finite else i % L]
        hint, floor = {}, {}
        for s in range(cur.block_number):
            q = tuple(np.asarray(cur.charges[s], QTYPE))
            n = int(cur.slices[s + 1] - cur.slices[s])
            hint[q] = int(np.ceil(n * cap_factor))
            floor[q] = n
        theta_legs = (_bond(i - 1, bond), p_legs[iL], p_legs[iR],
                      _bond(i + 1, bond).conj())
        qtotal_th = chinfo.make_valid(qtot[iL] + qtot[iR])
        bond[i if finite else i % L] = ps.bond_layout(
            theta_legs, qtotal_th, qtot[iL], cap_hint=hint, cap_floor=floor,
            chi_cap=chi_max, multiple=multiple,
            total_cap=int(np.ceil(total_cap_factor * chi_max)))
    return bond, cur_legs


def pack_S_from_leg(S_host, leg, bond, device='cuda'):
    """A bond-S vector (in ``leg`` order) padded into ``bond``-layout order,
    as a float64 tensor on ``device`` (the card by default; raises where
    there is none)."""
    device = pk.checked_device(device)
    out = np.zeros(int(bond.slices[-1]))
    pos = {tuple(np.asarray(bond.charges[b], QTYPE)): b
           for b in range(bond.block_number)}
    for s in range(leg.block_number):
        b = pos.get(tuple(np.asarray(leg.charges[s], QTYPE)))
        if b is None:
            continue
        n = min(int(leg.slices[s + 1] - leg.slices[s]),
                int(bond.slices[b + 1] - bond.slices[b]))
        out[int(bond.slices[b]):int(bond.slices[b]) + n] = \
            S_host[int(leg.slices[s]):int(leg.slices[s]) + n]
    return torch.from_numpy(out).to(device)


def pack_bond_S(state, i, bond, device='cuda'):
    """Bond ``i``'s S as a flat padded tensor in bond-layout order, on
    ``device``."""
    return pack_S_from_leg(np.asarray(state.S[i]), _vL_leg(state, i), bond,
                           device)


class DeviceSweepEngine:
    """Device-resident two-site DMRG sweeps.

    Parameters
    ----------
    state : ExchangeState
        Finite or infinite state with its MPO and environments (B form).
    options : dict
        chi_max : int -- bond cap for truncation.
        svd_min : float -- relative Schmidt-value cutoff (default 1e-10).
        lanczos_K : int -- Lanczos steps per update (default 10).
        lanczos_K_seam : int -- cap at the two iDMRG wrap-seam updates.
        lanczos_P_tol : float -- early-exit tolerance (default 1e-14).
        n_sweeps : int -- sweeps to run (default 10).
        backend : str -- decomposition backend (only ``'svd'``).
        multiple : int -- bucket multiple of padded virtual legs (64).
        e_tol : float -- stop a phase once |Delta E| per sweep is below.
        mixer : bool -- subspace expansion (default True).
        settle_sweeps, polish_sweeps, cap_factor, total_cap_factor, n_hops,
        uniform_bonds, reortho, matvec_mode, exact_E, log_updates: as in
        ``tenpy_tpu``'s engine.
    device : str or torch.device
        Where the sweep state lives: the card by default, where every
        packed tensordot is one launch of the CUDA kernel; raises where
        there is no card.  ``'cpu'`` runs the kernels' plain versions.
    """

    def __init__(self, state, options, device='cuda'):
        self.device = pk.checked_device(device)
        self.state = state
        opts = dict(options)
        cur_chi = max(1, max(state.chi, default=1))
        self.chi_max = int(opts.get('chi_max', cur_chi))
        self.svd_min = float(opts.get('svd_min', 1e-10))
        self.K = int(opts.get('lanczos_K', 10))
        self.n_sweeps = int(opts.get('n_sweeps', 10))
        self.backend = opts.get('backend', None)
        self.multiple = int(opts.get('multiple', BUCKET_MULTIPLE))
        self.e_tol = float(opts.get('e_tol', 0.))
        # capacity reserve grows with the chi growth ratio (see tenpy_tpu)
        ratio = max(1., self.chi_max / cur_chi)
        self.cap_factor = float(opts.get('cap_factor', max(1.3, 1.3 * ratio)))
        self.total_cap_factor = float(opts.get('total_cap_factor', 1.5))
        self.n_hops = int(opts.get(
            'n_hops', max(2, int(np.ceil(np.log2(ratio))) + 1)))
        self.uniform_bonds = bool(opts.get('uniform_bonds', True))
        self.mixer = bool(opts.get('mixer', True))
        # the last settle sweeps run with the expansion off, so the state
        # relaxes onto the fixed kept basis
        self.settle_sweeps = int(opts.get('settle_sweeps',
                                          2 if self.mixer else 0))
        self.lanczos_P_tol = float(opts.get('lanczos_P_tol', 1e-14))
        self.K_seam = int(opts.get('lanczos_K_seam', max(6 * self.K, 60)))
        self.reortho = bool(opts.get('reortho', False))
        self.matvec_mode = opts.get('matvec_mode', None)
        self.exact_E = bool(opts.get('exact_E', False))
        self.polish_sweeps = int(opts.get('polish_sweeps',
                                          1 if self.matvec_mode else 0))
        self.log_updates = bool(opts.get('log_updates', False))
        self.finite = state.finite
        self.L = state.L
        if self.L < 2:
            raise ValueError("DeviceSweepEngine needs L >= 2")
        self.n_bonds = self.L + 1 if self.finite else self.L
        self.sweep_stats = {'sweep': [], 'E': [], 'max_err': [], 'time': [],
                            'mode': [], 'flops_exec': [], 'lanczos_iters': [],
                            'update_E0': []}
        self._cur_mode = None
        self._cur_expand = self.mixer
        self._C = None            # center-matrix carry (site of last update)
        self._M0 = None           # bond-0 basis transition (iDMRG seam)
        self._setup()

    def _bond(self, i):
        return self.bond[i if self.finite else i % self.L]

    # ------------------------------------------------------------- setup
    def _setup(self):
        state, L = self.state, self.L
        self.bond = None
        if self.uniform_bonds and not self.finite and state.gauge is not None:
            try:
                self.bond, _ = uniform_capacity_layout(
                    state, self.chi_max, self.multiple, self.cap_factor,
                    self.total_cap_factor, self.n_hops)
                logger.info("uniform bond layout: %d sectors, capacity %d",
                            self.bond[0].block_number,
                            int(self.bond[0].slices[-1]))
            except ValueError as e:
                logger.info("uniform bond layout not applicable (%s); "
                            "using per-bond layouts", e)
        if self.bond is None:
            self.bond, _ = capacity_bond_layouts(
                state, self.chi_max, self.multiple, self.cap_factor,
                self.total_cap_factor, self.n_hops)
        self.qtotal_site = [tuple(int(x) for x in
                                  np.asarray(state.B[i].qtotal).ravel())
                            for i in range(L)]
        self.Bp = [self._pack_site(state.B[i], i) for i in range(L)]
        self.Wp = [pk.pack(state.W[i], pad=False, device=self.device)
                   for i in range(L)]
        self.Sp = [pack_bond_S(state, i, self._bond(i), self.device)
                   for i in range(self.n_bonds)]
        self.Ap = [None] * L
        self.LPp = [None] * L
        self.RPp = [None] * L
        self.LPp[0] = self._pack_env(state.LP0, 0, 'L')
        for i in range(L):
            self.RPp[i] = self._pack_env(
                state.RP[i], i + 1 if self.finite else (i + 1) % L, 'R')

    def _pack_site(self, B, i):
        padded = embed_array(B, {'vL': self._bond(i),
                                 'vR': self._bond(i + 1).conj()})
        return pk.pack(padded, pad=False, device=self.device)

    def _pack_env(self, E, i, side):
        if side == 'L':
            E = E.transpose(['vR*', 'wR', 'vR'])
            padded = {'vR*': self._bond(i), 'vR': self._bond(i).conj()}
        else:
            E = E.transpose(['wL', 'vL', 'vL*'])
            padded = {'vL': self._bond(i), 'vL*': self._bond(i).conj()}
        return pk.pack(embed_array(E, padded), pad=False, device=self.device)

    # ------------------------------------------------------------ the step
    def _step(self, move_right, plan, K, LP, RP, W0, W1, C, N):
        """One site update: guess, Lanczos, split, environment update."""
        if move_right:
            th0 = pk.tensordot(C.replace_labels(['p'], ['p0']),
                               N.replace_labels(['p'], ['p1']),
                               axes=(['vR'], ['vL']))
        else:
            th0 = pk.tensordot(N.replace_labels(['p'], ['p0']),
                               C.replace_labels(['p'], ['p1']),
                               axes=(['vR'], ['vL']))
        W0m = W0.replace_labels(['p', 'p*'], ['p0', 'p0*'])
        W1m = W1.replace_labels(['p', 'p*'], ['p1', 'p1*'])
        E0, th, n_iter, _ = _lanczos_K_2site_packed_impl(
            LP, RP, W0m, W1m, th0, K, self.lanczos_P_tol, 2, self.reortho,
            self._cur_mode, self.exact_E)
        A, S, B, err, _, _ = ps.split_truncate(
            th, plan, self.chi_max, self.svd_min, self.backend,
            expand=self._cur_expand)
        if move_right:
            Cn = ps.scale_bond(B, S, ps.scale_bond_plan(B, 'vL'))
            ENVn = _env_update_L(LP, A, W0)
        else:
            Cn = ps.scale_bond(A, S, ps.scale_bond_plan(A, 'vR'))
            ENVn = _env_update_R(RP, B, W1)
        return E0, A, S, B, Cn, ENVn, err, n_iter

    def _theta_struct(self, C, N, move_right):
        """Structure-only PackedArray of ``C . N`` (for plan construction)."""
        thL = (C if move_right else N).replace_labels(['p'], ['p0'])
        thR = (N if move_right else C).replace_labels(['p'], ['p1'])
        out_legs = (thL.legs[0], thL.legs[1], thR.legs[1], thR.legs[2])
        chinfo = out_legs[0].chinfo
        qtotal = tuple(int(x) for x in chinfo.make_valid(
            np.asarray(thL.qtotal, QTYPE) + np.asarray(thR.qtotal, QTYPE)))
        shapes, qdatas = pk.complete_structure(out_legs, qtotal)
        return pk.PackedArray(out_legs, qtotal, ('vL', 'p0', 'p1', 'vR'),
                              shapes, qdatas, [], C.dtype, C.device)

    def _update(self, i0, move_right, K=None):
        t0 = time.time()
        L = self.L
        iL, iR = i0 % L, (i0 + 1) % L
        N = self.Bp[iR] if move_right else self.Ap[iL]
        C = self._C
        plan = ps.split_plan(self._theta_struct(C, N, move_right),
                             self._bond(i0 + 1), self.qtotal_site[iL])
        rec = pk.FlopRecorder()
        with pk.flop_record(rec):
            E0, A, S, B, Cn, ENVn, err, n_iter = self._step(
                move_right, plan, self.K if K is None else K,
                self.LPp[iL], self.RPp[iR], self.Wp[iL], self.Wp[iR], C, N)
        self._upd.append((E0, err, n_iter, rec.flops))
        self.Ap[iL] = A
        self.Bp[iR] = B
        self.Sp[i0 + 1 if self.finite else (i0 + 1) % L] = S
        if move_right:
            self.LPp[iR] = ENVn
        else:
            self.RPp[iL] = ENVn
        self._C = Cn
        if self.log_updates:
            logger.info("  update (%d,%d) %s: E0=%.12f err=%.2e (%.2fs)",
                        iL, iR, 'R' if move_right else 'L', E0, float(err),
                        time.time() - t0)

    # --------------------------------------------------------------- sweep
    def sweep(self):
        """One right-then-left sweep; returns ``(E, max_err)``."""
        L = self.L
        self._upd = []
        if self._C is None:   # very first sweep: C = S[0] . B[0]
            self._C = ps.scale_bond(self.Bp[0], self.Sp[0],
                                    ps.scale_bond_plan(self.Bp[0], 'vL'))
        n_each = L - 1 if self.finite else L
        for j in range(n_each):                        # rightward
            # the iDMRG wrap update's guess is one half-sweep stale: its
            # Lanczos cap is K_seam
            K = self.K_seam if (not self.finite and j == n_each - 1) else None
            self._update(j, True, K=K)
        A_wrap_old = self.Ap[L - 1]
        for j in range(n_each):                        # leftward
            K = self.K_seam if (not self.finite and j == n_each - 1) else None
            self._update(n_each - 1 - j, False, K=K)
            if j == 0 and not self.finite:
                self._M0 = _bond0_transition(A_wrap_old, self.Ap[L - 1])
        errs = torch.stack([u[1] for u in self._upd]).cpu().numpy()
        self._sweep_E0 = [u[0] for u in self._upd]
        self._sweep_iters = [u[2] for u in self._upd]
        self._sweep_flops_exec = sum(u[3] for u in self._upd)
        return self._sweep_E0[-1], float(errs.max())

    def _record(self, E, max_err, dt):
        st = self.sweep_stats
        st['sweep'].append(len(st['E']) + 1)
        st['E'].append(E)
        st['max_err'].append(max_err)
        st['time'].append(dt)
        st['mode'].append(self._cur_mode or 'f64')
        st['flops_exec'].append(self._sweep_flops_exec)
        st['lanczos_iters'].append(self._sweep_iters)
        st['update_E0'].append(self._sweep_E0)

    def _timed_sweep(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        t0 = time.time()
        E, max_err = self.sweep()
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        return E, max_err, time.time() - t0

    def run(self):
        """Expansion sweeps (mixer) -> settle sweeps (expansion off) ->
        polish sweeps (full f64); returns the last sweep's energy."""
        E_prev = None
        n_p = min(self.polish_sweeps, self.n_sweeps)
        n_settle = (min(self.settle_sweeps, self.n_sweeps - n_p)
                    if self.mixer else 0)
        bounds = [self.n_sweeps - n_p - n_settle, self.n_sweeps - n_p,
                  self.n_sweeps]
        sw = 0
        while sw < self.n_sweeps:
            ph = 0 if sw < bounds[0] else (1 if sw < bounds[1] else 2)
            self._cur_mode = self.matvec_mode if ph < 2 else None
            self._cur_expand = self.mixer and ph == 0
            E, max_err, dt = self._timed_sweep()
            self._record(E, max_err, dt)
            logger.info("device sweep %d (%s): E0=%.14f max_err=%.2e "
                        "(%.2fs)", sw + 1, self._cur_mode or 'f64', E,
                        max_err, dt)
            converged = (E_prev is not None and self.e_tol > 0
                         and abs(E - E_prev) < self.e_tol)
            E_prev = E
            sw += 1
            if converged:
                if ph == 2 or sw >= self.n_sweeps:
                    break
                sw = max(sw, bounds[ph])   # converged early: next phase
                E_prev = None              # E jumps at the phase switch
        # tail guard: an unconverged seam Lanczos can spray truncation junk
        # into one sweep; if that was the final one, heal with up to 2 extra
        # sweeps at the final phase's settings
        errs = self.sweep_stats['max_err']
        for _ in range(2):
            if len(errs) < 5:
                break
            med = sorted(errs[-5:-1])[2]
            if errs[-1] <= 10 * max(med, 1e-300):
                break
            logger.info("final sweep max_err %.2e is an outlier (median "
                        "%.2e); healing with an extra sweep", errs[-1], med)
            self._record(*self._timed_sweep())
        return self.sweep_stats['E'][-1]

    # -------------------------------------------------------------- export
    def export_state(self):
        """The current state in the exchange format (a flat dict).

        B/S host arrays pruned to the nonzero Schmidt values; after a
        completed sweep site 0 is written in A form (for infinite bc rotated
        by the bond-0 transition of the last sweep), as ``tenpy_tpu``'s
        ``write_back`` does.  The charges stay in the engine's (gauged)
        frame; the stored gauge info inverts it.  No MPO or environments."""
        L = self.L
        Ss = [s.cpu().numpy() for s in self.Sp]
        keeps = []
        for S in Ss:
            keep = S > 0.
            if not keep.any():
                keep[0] = True
            keeps.append(keep)
        Bs, forms = [], []
        for i in range(L):
            if self.finite and i == 0 and self.Ap[0] is not None:
                T, form = pk.unpack(self.Ap[0]), 'A'
            elif (not self.finite and i == 0 and self.Ap[0] is not None
                    and self._M0 is not None):
                A0 = pk.tensordot(self._M0.conj(), self.Ap[0],
                                  axes=(['vR'], ['vL']))
                A0 = A0.replace_labels(['vR*'], ['vL'])
                T, form = pk.unpack(A0).transpose(['vL', 'p', 'vR']), 'A'
            else:
                T, form = pk.unpack(self.Bp[i]), 'B'
            T.iproject(keeps[i if self.finite else i % L], 'vL')
            T.iproject(keeps[i + 1 if self.finite else (i + 1) % L], 'vR')
            Bs.append(T)
            forms.append(form)
        chi = [Bs[i].get_leg('vR').ind_len
               for i in range(L - 1 if self.finite else L)]
        return exchange.state_to_flat(
            self.state.bc, chi, Bs, None, [S[k] for S, k in zip(Ss, keeps)],
            None, None, self.state.chinfo, gauge=self.state.gauge,
            forms=forms)
