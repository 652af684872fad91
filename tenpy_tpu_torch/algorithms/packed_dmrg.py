r"""Device-resident two-site DMRG sweeps on the bucket-packed layout.

Port of ``tenpy_tpu/algorithms/packed_dmrg.py``: ``DeviceSweepEngine``, the
capacity layouts and the chi ramp ``device_ramp`` (its charge gauge is in
:mod:`~tenpy_tpu_torch.networks.charge_gauge`).  The
whole sweep state lives on one device; each site update is

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

The engine starts from an :class:`~tenpy_tpu_torch.networks.mps.MPS` and a
model (its ``H_MPO``): the host half of the setup (charge gauge, MPO
charge rescale, environments from
:meth:`~tenpy_tpu_torch.networks.mpo.MPOTransferMatrix.find_init_LP_RP`)
runs on the host :class:`~tenpy_tpu_torch.linalg.np_conserved.Array` s and
is then packed onto the device.  The engine sweeps a gauged copy of
``psi``; :meth:`DeviceSweepEngine.run` ends in
:meth:`DeviceSweepEngine.write_back`, which moves the state to the host
once and writes it into the caller's MPS, in the caller's charge frame and
with its ``Site`` objects, and for infinite bc re-gauges it with
``MPS.canonical_form``.  :meth:`DeviceSweepEngine.export_state` returns the
state in the exchange format instead.
Finite and infinite (iDMRG) bc; the ``mixer`` option is the subspace
expansion of :func:`~tenpy_tpu_torch.linalg.packed_split.split_truncate`.
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
from ..networks.charge_gauge import apply_bond_charge_shift, \
    scale_mpo_charges, scale_psi_charges, uniformize_charge_gauge
from ..networks.mpo import MPOEnvironment, MPOTransferMatrix
from .mps_common import _lanczos_K_2site_packed_impl, BUCKET_MULTIPLE

logger = logging.getLogger(__name__)

__all__ = ['DeviceSweepEngine', 'device_ramp', 'uniform_capacity_layout',
           'capacity_bond_layouts', 'pack_S_from_leg', 'pack_bond_S']


def uniform_capacity_layout(psi, chi_max, multiple, cap_factor=1.3,
                            total_cap_factor=1.5, n_hops=2):
    """One shared capacity bond layout for all bonds of a regauged iMPS.

    Needs the uniform charge gauge (all site qtotals equal) and identical
    sites.  The layout is the union of every bond's current sectors
    (per-sector capacity = max over bonds), widened by the update
    reachability passes of :func:`ps.bond_layout`.  Returns
    ``(bond, psi_legs)`` with ``bond[i]`` the same LegCharge for every ``i``.
    """
    L = psi.L
    chinfo = psi.sites[0].leg.chinfo
    p_legs = [psi.get_B(i, None).get_leg('p') for i in range(L)]
    if any(leg != p_legs[0] for leg in p_legs[1:]):
        raise ValueError("uniform layout needs identical physical legs")
    qtots = [np.asarray(psi.get_B(i, None).qtotal, QTYPE) for i in range(L)]
    if any(np.any(q != qtots[0]) for q in qtots[1:]):
        raise ValueError("uniform layout needs equal site qtotals "
                         "(the uniform charge gauge)")
    qeff = qtots[0]
    psi_legs = []
    for i in range(L):
        leg = psi.get_B(i, 'B').get_leg('vL')
        psi_legs.append(leg if leg.qconj == 1 else leg.conj())
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


def device_ramp(psi, model, options, device='cuda'):
    """The chi ramp, device-resident: staged two-site sweeps.

    Each stage is a :class:`DeviceSweepEngine` at the stage's ``chi``; the
    first starts from ``psi``, every later one from the previous engine
    (:meth:`DeviceSweepEngine.from_engine`: the packed state and
    environments re-embedded into layouts rebuilt from the kept Schmidt
    directions, widened ``n_hops`` reachability hops, per-sector capacity
    extrapolated by ``grow_factor * chi_next / chi_cur``).

    Options
    -------
    chi_list : list of (chi, n_sweeps)
        Stages; default doubles from ``2 * max(psi.chi)`` to ``chi_max``
        with ``sweeps_per_stage`` sweeps each.
    chi_max : int
    sweeps_per_stage : int (default 2)
    grow_factor : float (default 1.3)
    n_hops : int (default 3)
    The rest goes to :class:`DeviceSweepEngine`; the final stage runs
    ``max(sweeps_per_stage, n_sweeps)`` sweeps.

    Returns the last stage's engine, with the sweep statistics of all
    stages in ``sweep_stats`` and one entry per stage in ``stages``
    (``chi``, ``n_sweeps``, ``first_sweep``, ``setup_s``: the host seconds
    of the stage's engine construction).  Only the last stage writes its
    state back into ``psi`` (:meth:`DeviceSweepEngine.write_back`); the
    stages before it hand theirs on on the device.
    """
    opts = dict(options)
    chi_max = int(opts.pop('chi_max', max(psi.chi)))
    sweeps_per_stage = int(opts.pop('sweeps_per_stage', 2))
    grow = float(opts.pop('grow_factor', 1.3))
    n_hops = int(opts.pop('n_hops', 3))
    stages = opts.pop('chi_list', None)
    if stages is None:
        stages = []
        c = max(psi.chi)
        while 2 * c < chi_max:
            c *= 2
            stages.append((c, sweeps_per_stage))
        stages.append((chi_max, sweeps_per_stage))
    eng = None
    all_stats = None
    stage_log = []
    chi_prev = max(1, max(psi.chi, default=1))
    for k, (chi_s, n_s) in enumerate(stages):
        last = k == len(stages) - 1
        stage_opts = dict(opts)
        stage_opts.update({
            'chi_max': chi_s,
            'n_sweeps': n_s if not last
            else max(n_s, int(opts.get('n_sweeps', n_s))),
            'cap_factor': grow * max(1., chi_s / chi_prev),
            'n_hops': n_hops,
        })
        if not last:
            # interior stages grow chi: the expansion stays on for every
            # sweep (settle and polish belong to the final stage)
            stage_opts.setdefault('settle_sweeps', 0)
        chi_prev = chi_s
        logger.info("device_ramp stage %d: chi -> %d (%d sweeps)",
                    k + 1, chi_s, stage_opts['n_sweeps'])
        t0 = time.time()
        if eng is None:
            eng = DeviceSweepEngine(psi, model, stage_opts, device)
        else:
            eng = DeviceSweepEngine.from_engine(eng, stage_opts)
        stage_log.append({'chi': chi_s, 'n_sweeps': stage_opts['n_sweeps'],
                          'first_sweep': len(all_stats['E'])
                          if all_stats else 0,
                          'setup_s': time.time() - t0})
        eng._write_back_on_run = last
        eng.run()
        if all_stats is None:
            all_stats = {k2: list(v) for k2, v in eng.sweep_stats.items()}
        else:
            for k2, v in eng.sweep_stats.items():
                all_stats[k2].extend(v)
    eng.sweep_stats = all_stats
    eng.stages = stage_log
    return eng


def _bond0_transition(A_old, A_new):
    """Exact old->new bond-0 basis transition of an iDMRG sweep.

    The leftward wrap update rewrites bond 0; its input and output
    ``A[L-1]`` share their ``vL`` basis, so
    ``M0[a, b] = sum_{vL,p} A_old[vL,p,a] A_new[vL,p,b]`` is the transition
    between the old and new bond-0 bases (used by :meth:`_host_state`)."""
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


def capacity_bond_layouts(psi, chi_max, multiple, cap_factor=1.3,
                          total_cap_factor=1.5, n_hops=2):
    """Fixed padded capacity layouts, one per bond.

    ``bond[i]`` is the (qconj=+1) vL leg of site ``i`` padded to bucket
    multiples; interior bonds are widened to every ``n_hops``-update-reachable
    charge sector, with per-sector capacity grown by ``cap_factor`` and the
    total budgeted to ``total_cap_factor * chi_max``.
    Returns ``(bond, psi_leg)``: the layouts and the unpadded legs.
    """
    L = psi.L
    finite = psi.bc == 'finite'
    psi_leg = []
    for i in range(L + 1 if finite else L):
        if finite and i == L:
            leg = psi.get_B(L - 1, 'B').get_leg('vR').conj()
        else:
            leg = psi.get_B(i % L, 'B').get_leg('vL')
        psi_leg.append(leg if leg.qconj == 1 else leg.conj())
    p_legs = [psi.get_B(i, None).get_leg('p') for i in range(L)]
    qtot = [np.asarray(psi.get_B(i, None).qtotal, QTYPE) for i in range(L)]
    bond = _capacity_layouts(psi_leg, p_legs, qtot, chi_max, multiple,
                             cap_factor, total_cap_factor, finite, n_hops)
    return bond, psi_leg


def _capacity_layouts(cur_legs, p_legs, qtot, chi_max, multiple, cap_factor,
                      total_cap_factor, finite, n_hops=2):
    """Core of :func:`capacity_bond_layouts`, from explicit current legs:
    those of a host MPS, or a running engine's kept Schmidt directions."""
    L = len(p_legs)
    chinfo = cur_legs[0].chinfo

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
    return bond


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


def pack_bond_S(psi, i, bond, device='cuda'):
    """Bond ``i``'s S as a flat padded tensor in bond-layout order, on
    ``device``."""
    L = psi.L
    if psi.bc == 'finite' and i == L:
        S_host = np.asarray(psi.get_SR(L - 1))
        leg = psi.get_B(L - 1, 'B').get_leg('vR').conj()
    else:
        S_host = np.asarray(psi.get_SL(i % L))
        leg = psi.get_B(i % L, 'B').get_leg('vL')
    if leg.qconj != 1:
        leg = leg.conj()
    return pack_S_from_leg(S_host, leg, bond, device)


class DeviceSweepEngine:
    """Device-resident two-site DMRG sweeps.

    Parameters
    ----------
    psi : :class:`~tenpy_tpu_torch.networks.mps.MPS`
        Finite or infinite MPS in canonical form; the engine sweeps a copy
        and :meth:`run` writes the result back into ``psi``.
    model : :class:`~tenpy_tpu_torch.models.model.MPOModel`
        Its ``H_MPO`` is the Hamiltonian.
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

    ``setup_seconds`` holds the host time of the setup's parts,
    ``write_back_stats`` the last write-back's seconds and ``norm_test``.
    """

    def __init__(self, psi, model, options=None, device='cuda',
                 _regrow_from=None):
        self.device = pk.checked_device(device)
        self.psi = psi
        self.model = model
        opts = dict(options or {})
        cur_chi = max(1, max(psi.chi, default=1))
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
        self.finite = psi.bc == 'finite'
        self.L = psi.L
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
        self._write_back_on_run = True
        self.setup_seconds = {}
        self.write_back_stats = {}
        if _regrow_from is None:
            self._setup()
        else:
            self._setup_from_engine(_regrow_from)

    @classmethod
    def from_engine(cls, old, options):
        """Stage transition of the chi ramp: a fresh engine at ``options``'
        ``chi_max`` whose packed state (B tensors, bond S) and environments
        are ``old``'s, re-embedded into new capacity layouts on the host
        (unpack, prune to the kept Schmidt directions, embed, pack), with no
        canonical-form conversion and no environment re-initialisation.
        New charge sectors enter with zero weight; the sweeps populate
        them."""
        return cls(old.psi, old.model, options, old.device, _regrow_from=old)

    def _bond(self, i):
        return self.bond[i if self.finite else i % self.L]

    # ------------------------------------------------------------- setup
    def _setup(self):
        """The host half of ``tenpy_tpu``'s setup on a copy of psi:
        ``real_if_close``, the uniform charge gauge (with the MPO rescale),
        the capacity layouts, packing, and the environments."""
        t0 = time.time()
        psi = self.psi.copy()
        L = self.L
        psi.real_if_close()
        if psi.dtype.is_complex and not self.model.H_MPO.dtype.is_complex:
            # real H: residual imaginary parts are gauge junk from
            # canonicalization eigensolvers
            psi.real_if_close(tol=1e-6)
        self.bond = None
        self.gauge = None
        self._H = self.model.H_MPO
        if self.uniform_bonds and not self.finite:
            try:
                self.gauge = uniformize_charge_gauge(psi, rescale=True)
                if self.gauge is not None:
                    if np.any(self.gauge['k'] != 1):
                        self._H = scale_mpo_charges(self.model.H_MPO,
                                                    self.gauge['k'])
                        logger.info("rescaled U(1) charge units by %s",
                                    list(self.gauge['k']))
                    self.bond, _ = uniform_capacity_layout(
                        psi, self.chi_max, self.multiple, self.cap_factor,
                        self.total_cap_factor, self.n_hops)
                    logger.info("uniform bond layout: %d sectors, capacity %d",
                                self.bond[0].block_number,
                                int(self.bond[0].slices[-1]))
            except ValueError as e:
                logger.info("uniform bond layout not applicable (%s); "
                            "using per-bond layouts", e)
        if self.bond is None:
            self.bond, _ = capacity_bond_layouts(
                psi, self.chi_max, self.multiple, self.cap_factor,
                self.total_cap_factor, self.n_hops)
        t1 = time.time()
        self.qtotal_site = []
        self.Bp, self.Wp = [], []
        for i in range(L):
            B = psi.get_B(i, 'B').transpose(['vL', 'p', 'vR'])
            self.qtotal_site.append(
                tuple(int(x) for x in np.asarray(B.qtotal, QTYPE).ravel()))
            self.Bp.append(self._pack_site(B, i))
            W = self._H.get_W(i).transpose(['wL', 'wR', 'p', 'p*'])
            self.Wp.append(pk.pack(W, pad=False, device=self.device))
        self.Sp = [pack_bond_S(psi, i, self._bond(i), self.device)
                   for i in range(self.n_bonds)]
        self.Ap = [None] * L
        t2 = time.time()
        # infinite bc: seed with the converged environments (age-0 ones make
        # H_eff the wrong operator for many sweeps)
        init_env_data = {}
        if not self.finite:
            init_env_data = MPOTransferMatrix.find_init_LP_RP(self._H, psi)
        t3 = time.time()
        env = MPOEnvironment(psi, self._H, psi, **init_env_data)
        self.LPp = [None] * L
        self.RPp = [None] * L
        self.LPp[0] = self._pack_env(env.get_LP(0), 0, 'L')
        for i in range(L - 1, -1, -1):
            self.RPp[i] = self._pack_env(env.get_RP(i),
                                         i + 1 if self.finite else (i + 1) % L,
                                         'R')
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        t4 = time.time()
        self.setup_seconds = {'gauge_layouts': t1 - t0, 'pack_state': t2 - t1,
                              'env_init': t3 - t2, 'envs': t4 - t3}

    def _setup_from_engine(self, old):
        """Adopt ``old``'s device state and environments in new layouts.

        Every tensor on bond ``i`` is pruned by the same keep mask (the
        final S > 0 slots) and re-embedded sector-prefix-wise, so state and
        environments stay aligned slot for slot; the dropped slots carry
        exact-zero weight by the engine's design.  No S^-1 anywhere."""
        t0 = time.time()
        L, finite = self.L, self.finite
        if (old.L, old.finite) != (L, finite):
            raise ValueError("from_engine: psi/model mismatch")
        # the stage transition stays in the old engine's charge frame
        self.gauge = old.gauge
        self._H = old._H
        Ss = [s.cpu().numpy() for s in old.Sp]
        keeps = []
        for S in Ss:
            keep = S > 0.
            if not keep.any():
                keep[0] = True
            keeps.append(keep)
        kept_legs = [old._bond(i).project(keeps[i])[2]
                     for i in range(self.n_bonds)]
        p_legs = [old.Bp[i].legs[1] for i in range(L)]
        self.qtotal_site = list(old.qtotal_site)
        qtot = [np.asarray(q, QTYPE) for q in self.qtotal_site]
        self.bond = _capacity_layouts(
            kept_legs, p_legs, qtot, self.chi_max, self.multiple,
            self.cap_factor, self.total_cap_factor, finite, self.n_hops)

        def keepm(i):
            return keeps[i if finite else i % L]

        def reembed(p_arr, ax_bonds):
            """unpack -> prune by the keep masks -> embed -> pack;
            ``ax_bonds``: label -> (bond index, conj?)."""
            T = pk.unpack(p_arr)
            grow = {}
            for lab, (bi, conj) in ax_bonds.items():
                T = T.iproject(keepm(bi), T.get_leg_index(lab))
                grow[lab] = self._bond(bi).conj() if conj else self._bond(bi)
            return pk.pack(embed_array(T, grow), pad=False,
                           device=self.device)

        self.Wp = list(old.Wp)   # layout-independent (wL/wR/p legs only)
        self.Bp = [reembed(old.Bp[i], {'vL': (i, False), 'vR': (i + 1, True)})
                   for i in range(L)]
        self.Sp = [pack_S_from_leg(Ss[i][keeps[i]], kept_legs[i],
                                   self._bond(i), self.device)
                   for i in range(self.n_bonds)]
        self.LPp = [reembed(old.LPp[i], {'vR*': (i, False), 'vR': (i, True)})
                    if old.LPp[i] is not None else None for i in range(L)]
        self.RPp = [reembed(old.RPp[i], {'vL': (i + 1, False),
                                         'vL*': (i + 1, True)})
                    if old.RPp[i] is not None else None for i in range(L)]
        self.Ap = [None] * L
        # C is dropped: sweep() re-seeds it from S[0] . B[0]
        self._C = None
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.setup_seconds = {'from_engine': time.time() - t0}

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
        polish sweeps (full f64), then :meth:`write_back`; returns
        ``(E, psi)``, the last sweep's energy and the caller's MPS holding
        the new state."""
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
        if self._write_back_on_run:
            self.write_back()
        return self.sweep_stats['E'][-1], self.psi

    # ---------------------------------------------------------- write-back
    def _host_state(self):
        """The device state on the host, in the engine's charge frame:
        ``(Bs, forms, Ss)``, pruned to the nonzero Schmidt values.  After a
        completed sweep site 0 is in A form: for finite bc the last update's
        A, for infinite bc that A rotated by the bond-0 transition of the
        last sweep, into the basis of ``S[0]`` and ``B[L-1]``'s vR (the
        stored ``B[0]`` is one generation stale on its vR); the other sites
        are in B form."""
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
        return Bs, forms, [S[k] for S, k in zip(Ss, keeps)]

    def write_back(self):
        """Write the device state into the caller's MPS ``self.psi``.

        One move to the host (:meth:`_host_state`); then the charge gauge
        of the setup is undone (bond charge shift, charge-unit rescale), so
        ``psi`` has the caller's charge frame and ``Site`` objects.  For
        infinite bc the unit-cell wrap leaves a seam drift at the truncation
        scale (``norm_test`` about 5x the per-update truncation error, not
        decaying with sweeps); where ``max(norm_test) > 1e-12``, ``psi`` is
        re-gauged with ``MPS.canonical_form``, as the reference's
        ``post_run_cleanup`` does: a gauge choice that changes the physics
        only at the truncation scale.  ``write_back_stats`` gets the
        seconds of the move (``unpack_s``) and of the re-gauge
        (``canonical_form_s``) and ``norm_test`` before and after it."""
        psi, L = self.psi, self.L
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        t0 = time.time()
        Bs, forms, Ss = self._host_state()
        sites = list(psi.sites)
        for i in range(L):
            psi.set_B(i, Bs[i], form=forms[i])
        for i in range(self.n_bonds):
            if self.finite and i == self.n_bonds - 1:
                psi.set_SR(L - 1, Ss[i])
            else:
                psi.set_SL(i, Ss[i])
        if self.gauge is not None:
            # a relabelling of the charges only: no block changes
            if any(np.any(o != 0) for o in self.gauge['o']):
                apply_bond_charge_shift(psi, [-o for o in self.gauge['o']])
            scale_psi_charges(psi, self.gauge['k'], div=True)
            psi.sites = sites
        st = {'unpack_s': time.time() - t0}
        if not self.finite:
            st['norm_test_before'] = float(np.max(psi.norm_test()))
            if st['norm_test_before'] > 1e-12:
                logger.info("write_back: norm_test=%.2e (seam drift at the "
                            "truncation scale); re-gauging",
                            st['norm_test_before'])
                t1 = time.time()
                psi.canonical_form()
                st['canonical_form_s'] = time.time() - t1
            st['norm_test_after'] = float(np.max(psi.norm_test()))
        self.write_back_stats = st

    def export_state(self):
        """The current state in the exchange format (a flat dict): the
        host tensors of :meth:`_host_state`, in the engine's (gauged)
        charge frame; the stored gauge info inverts it.  No MPO or
        environments."""
        Bs, forms, Ss = self._host_state()
        chi = [Bs[i].get_leg('vR').ind_len
               for i in range(self.L - 1 if self.finite else self.L)]
        return exchange.state_to_flat(
            self.psi.bc, chi, Bs, None, Ss, None, None, self.psi.chinfo,
            gauge=self.gauge, forms=forms)
