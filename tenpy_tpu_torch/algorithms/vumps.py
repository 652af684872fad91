r"""Variational Uniform Matrix Product States (VUMPS).

Port of ``tenpy_tpu/algorithms/vumps.py`` (:func:`_align_phase`,
:class:`VUMPSEngine`, :class:`SingleSiteVUMPSEngine`,
:class:`TwoSiteVUMPSEngine`); the algorithm of arXiv:1701.07035.

A tangent-space ground-state search in the thermodynamic limit on a
:class:`~tenpy_tpu_torch.networks.uniform_mps.UniformMPS`: per site, the
environments come from the fixed point of the MPO transfer matrix
(:meth:`~tenpy_tpu_torch.networks.mpo.MPOTransferMatrix.find_init_LP_RP`),
then two zero-site eigenproblems (the bond matrices C) and a one- or
two-site one (AC) are solved, and polar decompositions restore AL and AR
without an inversion.

``device`` (a keyword of the engines; default ``'cuda'``, which raises
where PyTorch sees no card) is where the three eigensolves of an update run
when the engine sends them to the packed Lanczos
(:func:`~tenpy_tpu_torch.algorithms.mps_common.lanczos_ground_packed`), by
DMRG's rule (:func:`~tenpy_tpu_torch.algorithms.mps_common.
use_device_lanczos`): ``lanczos_params['device_K']`` 0 disables, > 0
forces, else from ``DEVICE_LANCZOS_THRESHOLD`` up and never on the CPU.
There the environments and W tensors are packed once per effective H and
each matvec is two (zero-site), three (one-site) or four (two-site)
launches of the hand-written kernel.  The Ritz vector comes back to the
host, where :func:`_align_phase` fixes its phase.  The environment fixed
point, the polar decompositions and the truncated SVD run on the host.  A
failure on the card raises; nothing reruns on the host.

``eig_stats`` lists each eigensolve's ``(sites, N, route, Lanczos
steps)``; ``update_timing`` per update the seconds of the environment fixed
point, of each eigensolve by part (pack, Lanczos, unpack) and of the polar
decompositions and the SVD.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from . import mps_common
from .dmrg import _to_host
from .mps_common import (IterativeSweeps, OneSiteH, TwoSiteH, ZeroSiteH,
                         DensityMatrixMixer)
from ..linalg import np_conserved as npc
from ..linalg import packed as pk
from ..linalg.krylov_based import LanczosGroundState
from ..linalg.truncation import svd_theta
from ..networks.mpo import MPOEnvironment, MPOTransferMatrix
from ..networks.mps import MPS
from ..networks.uniform_mps import UniformMPS
from ..tools.math import entropy
from ..tools.params import asConfig

logger = logging.getLogger(__name__)

__all__ = ['VUMPSEngine', 'SingleSiteVUMPSEngine', 'TwoSiteVUMPSEngine']


def _align_phase(v, guess):
    """``v`` with its global phase rotated onto the guess's.

    A Lanczos eigenvector has an arbitrary phase (a sign if real); without
    this, AL, AC and C of different local updates pick up relative phases
    and ``AL C = AC = C AR`` holds only up to them.  A real ``v`` stays
    real (``tenpy_tpu`` multiplies by a complex scalar, which makes it
    complex with a zero imaginary part)."""
    ov = complex(npc.inner(guess.conj(), v, axes='range'))
    if abs(ov) > 1e-14:
        phase = abs(ov) / ov
        v = v * (phase if v.dtype.is_complex else float(np.sign(ov.real)))
    return v


class VUMPSEngine(IterativeSweeps):
    """The machinery shared by the single- and two-site VUMPS engines.

    Options (beside :class:`~tenpy_tpu_torch.algorithms.mps_common.
    IterativeSweeps`'): ``N_sweeps_check`` (1), ``max_E_err`` (1e-8),
    ``max_S_err`` (1e-5), ``max_split_err`` (1e-8), ``check_overlap``
    (True), ``norm_tol`` (1e-10), ``lanczos_params`` (with ``device_K``).
    ``device``: where the packed Lanczos runs (default ``'cuda'``).
    """

    EffectiveH = None

    def __init__(self, psi, model, options, *, device='cuda', **kwargs):
        self.device = pk.checked_device(device)
        if not isinstance(psi, UniformMPS):
            assert isinstance(psi, MPS)
            psi = UniformMPS.from_MPS(psi)
        options = asConfig(options, self.__class__.__name__)
        super().__init__(psi, model, options, **kwargs)
        assert psi.L % model.H_MPO.L == 0
        self.psi.left_U = self.psi.right_U = None
        self.psi.valid_umps = False
        self._entropy_approx = [None] * psi.L
        self.N_sweeps_check = self.options.get('N_sweeps_check', 1, int)
        self.options.setdefault('min_sweeps', int(1.5 * self.N_sweeps_check))

    def init_env(self, model=None, resume_data=None, orthogonal_to=None):
        if orthogonal_to:
            raise NotImplementedError("VUMPS does not support orthogonal_to")
        H = model.H_MPO if model is not None else self.env.H
        if resume_data is None:
            resume_data = {}
        self.guess_init_env_data = resume_data.get('init_env_data', None)
        data, Es, _ = MPOTransferMatrix.find_init_LP_RP(
            H, self.psi, calc_E=True,
            guess_init_env_data=self.guess_init_env_data)
        self.env = MPOEnvironment(self.psi, H, self.psi,
                                  init_LP=data['init_LP'],
                                  init_RP=data['init_RP'])
        self.transfer_matrix_energy = Es
        self.guess_init_env_data = data
        self.reset_stats()

    def reset_stats(self, resume_data=None):
        super().reset_stats(resume_data)
        self.update_stats = {k: [] for k in
                             ['i0', 'e_L', 'e_R', 'e_C1', 'e_C2', 'e_theta',
                              'N_lanczos', 'split_err_L', 'split_err_R',
                              'time']}
        self.sweep_stats = {k: [] for k in
                            ['sweep', 'E', 'Delta_E', 'S', 'Delta_S',
                             'max_S', 'time', 'max_chi', 'norm_err',
                             'max_split_err']}
        self.eig_stats = []
        self.update_timing = []

    # ----------------------------------------------------------- run loop
    def run(self):
        """The ground state: ``(E, psi)``, ``psi`` a new canonical
        :class:`~tenpy_tpu_torch.networks.mps.MPS` (:meth:`post_run_cleanup`)."""
        self.shelve = False
        self.pre_run_initialize()
        is_first_sweep = True
        while True:
            iteration_start_time = time.time()
            if self.stopping_criterion(
                    iteration_start_time=iteration_start_time):
                break
            if not is_first_sweep:
                self.checkpoint.emit(self)
            self.run_iteration()
            self.status_update(iteration_start_time=iteration_start_time)
            is_first_sweep = False
        return self.post_run_cleanup()

    def pre_run_initialize(self):
        super().pre_run_initialize()
        self.mixer_activate()

    def run_iteration(self):
        """``N_sweeps_check`` sweeps, then the statistics of the last."""
        if len(self.sweep_stats['E']) < 1:
            E_old = np.nan
            S_old = np.mean(self.psi.entanglement_entropy())
        else:
            E_old = self.sweep_stats['E'][-1]
            S_old = self.sweep_stats['S'][-1]
        for _ in range(self.N_sweeps_check):
            self.sweep()
        entropies = [s if s is not None else 0.
                     for s in self._entropy_approx]
        S = np.mean(entropies)
        L = self.psi.L
        us = self.update_stats
        E = np.mean(us['e_L'][-L:] + us['e_R'][-L:])
        max_split_err = np.max(us['split_err_L'][-L:]
                               + us['split_err_R'][-L:])
        ss = self.sweep_stats
        ss['sweep'].append(self.sweeps)
        ss['E'].append(E)
        ss['Delta_E'].append((E - E_old) / self.N_sweeps_check)
        ss['S'].append(S)
        ss['Delta_S'].append((S - S_old) / self.N_sweeps_check)
        ss['max_S'].append(np.max(entropies))
        ss['time'].append(time.time() - self.time0)
        ss['max_chi'].append(np.max(self.psi.chi))
        ss['norm_err'].append(np.linalg.norm(self.psi.norm_test()))
        ss['max_split_err'].append(max_split_err)
        return E, self.psi

    def status_update(self, iteration_start_time):
        ss = self.sweep_stats
        logger.info(
            "VUMPS sweep %d: E=%.14f, dE=%.3e, S=%.10f, max_split_err=%.3e, "
            "norm_err=%.1e, max_chi=%d", self.sweeps, ss['E'][-1],
            ss['Delta_E'][-1], ss['S'][-1], ss['max_split_err'][-1],
            ss['norm_err'][-1], ss['max_chi'][-1])

    def is_converged(self):
        """Converged once ``Delta E``, ``Delta S`` and the split error are
        all small."""
        max_E_err = self.options.get('max_E_err', 1e-8, 'real')
        max_S_err = self.options.get('max_S_err', 1e-5, 'real')
        max_split_err = self.options.get('max_split_err', 1e-8, 'real')
        ss = self.sweep_stats
        E = ss['E'][-1]
        return (abs(ss['Delta_E'][-1] / max(abs(E), 1.)) < max_E_err
                and abs(ss['Delta_S'][-1]) < max_S_err
                and ss['max_split_err'][-1] < max_split_err)

    def post_run_cleanup(self):
        """``(E, psi)``: the energy from the fixed point of the final state
        (where it is canonical within ``norm_tol``, else the last sweep's),
        and the state as a canonical infinite MPS (``to_MPS``)."""
        super().post_run_cleanup()
        check_overlap = self.options.get('check_overlap', True, bool)
        norm_tol = self.options.get('norm_tol', 1e-10, 'real')
        self.psi.test_validity()
        norm_err = np.linalg.norm(self.psi.norm_test())
        E = self.sweep_stats['E'][-1] if self.sweep_stats['E'] else np.nan
        if norm_err <= norm_tol:
            try:
                self.guess_init_env_data, Es, _ = \
                    MPOTransferMatrix.find_init_LP_RP(
                        self.model.H_MPO, self.psi, calc_E=True,
                        guess_init_env_data=self.guess_init_env_data)
                E = float(np.real(np.mean(Es)))
            except Exception as e:  # noqa: BLE001 - as tenpy_tpu
                logger.warning("final energy recomputation failed: %s", e)
        else:
            logger.warning("final VUMPS state not canonical: norm_err=%.2e",
                           norm_err)
        return E, self.psi.to_MPS(check_overlap=check_overlap)

    def environment_sweeps(self, N_sweeps):
        pass    # the environments are built anew at every update

    def get_sweep_schedule(self):
        """Left to right over the unit cell, storing no environments."""
        L = self.psi.L
        return zip(range(L), [True] * L, [[False, False]] * L)

    # ------------------------------------------------------------ updates
    def prepare_update_local(self):
        """The environments from the transfer-matrix fixed point, then the
        zero-site and n-site effective Hamiltonians; returns ``(theta, C1,
        C2)``, the guesses."""
        i0 = self.i0
        H = self.model.H_MPO
        psi = self.psi
        self.update_env()      # rotates the guess (single-site)
        t0 = time.time()
        data, Es, _ = MPOTransferMatrix.find_init_LP_RP(
            H, psi, calc_E=True, guess_init_env_data=self.guess_init_env_data)
        self.update_timing.append({'env': time.time() - t0, 'eig': [],
                                   'polar': 0., 'svd': 0.})
        self.env = MPOEnvironment(psi, H, psi, init_LP=data['init_LP'],
                                  init_RP=data['init_RP'])
        self.transfer_matrix_energy = Es
        self.make_eff_H()
        theta = psi.get_theta(i0, n=self.n_optimize)
        C1 = psi.get_C(i0)
        C2 = psi.get_C(i0 + self.n_optimize)
        return (theta, C1, C2)

    def make_eff_H(self):
        self.eff_H0_1 = ZeroSiteH(self.env, self.i0)
        self.eff_H0_2 = ZeroSiteH(self.env, self.i0 + self.n_optimize)
        self.eff_H = self.EffectiveH(self.env, self.i0, False, self.move_right)

    def _use_device_lanczos(self, eff):
        """Whether the eigensolve of ``eff`` runs as the packed Lanczos on
        ``self.device``: DMRG's rule,
        :func:`~tenpy_tpu_torch.algorithms.mps_common.use_device_lanczos`."""
        return mps_common.use_device_lanczos(self.lanczos_params,
                                             self.device, eff.N)

    def eigensolve(self, eff, guess):
        """The ground state of ``eff`` from ``guess``, its phase aligned
        to the guess's: ``(E0, theta, N)``.  On the card (by
        :meth:`_use_device_lanczos`) the packed Lanczos takes at most
        ``device_K`` (else ``N_max``, 20) steps and stops on ``P_tol``
        (1e-14) as the DMRG engines' card route does; on the host
        ``LanczosGroundState`` with ``lanczos_params``."""
        lp = self.lanczos_params
        timing = {'sites': eff.length, 'N': eff.N}
        t0 = time.time()
        if self._use_device_lanczos(eff):
            route = 'device'
            K = lp.get('device_K', None) or lp.get('N_max', 20, int)
            operands = eff.pack_operands(self.device)
            guess = guess.transpose(eff.acts_on)
            theta_p = mps_common.pack_virtual(guess, self.device)
            t1 = time.time()
            E0, th, N, _ = mps_common.lanczos_ground_packed(
                eff.packed_matvec, operands, theta_p, int(K),
                float(lp.get('P_tol', 1e-14, 'real')), 2,
                bool(lp.get('reortho', False)))
            t2 = time.time()
            theta = pk.unpack(_to_host(th),
                              orig_legs=[guess.get_leg(lbl)
                                         for lbl in th.get_leg_labels()])
            timing.update(pack=t1 - t0, lanczos=t2 - t1,
                          unpack=time.time() - t2)
        else:
            route = 'host'
            E0, theta, N = LanczosGroundState(eff, guess, lp).run()
            timing.update(pack=0., lanczos=time.time() - t0, unpack=0.)
        theta = _align_phase(theta, guess)
        timing.update(route=route, steps=N)
        self.eig_stats.append((eff.length, eff.N, route, N))
        if self.update_timing:
            self.update_timing[-1]['eig'].append(timing)
        return E0, theta, N

    def post_update_local(self, e_L, e_R, eps_L, eps_R, e_C1, e_C2, e_theta,
                          N0_L, N0_R, N1, **update_data):
        us = self.update_stats
        us['i0'].append(self.i0)
        us['e_L'].append(e_L)
        us['e_R'].append(e_R)
        us['e_C1'].append(e_C1)
        us['e_C2'].append(e_C2)
        us['e_theta'].append(e_theta)
        us['N_lanczos'].append([N0_L, N0_R, N1])
        us['split_err_L'].append(eps_L)
        us['split_err_R'].append(eps_R)
        us['time'].append(time.time() - self.time0)

    def free_no_longer_needed_envs(self):
        pass

    # a UniformMPS stores its bond matrices C anyway: switching the mixer
    # off leaves no matrix S to absorb
    def mixer_deactivate(self):
        if self.mixer is not None:
            logger.info("disable mixer after %d sweeps", self.sweeps)
        self.mixer = None

    def mixer_cleanup(self):
        pass

    def _polar_split(self, AC_L, C_L, AC_R, C_R):
        """``AL`` with ``AL C_L = AC_L`` and ``AR`` with ``C_R AR = AC_R``
        from polar decompositions, the split errors ``(eps_L, eps_R)`` and
        the entropies of ``C_R`` and ``C_L``."""
        t0 = time.time()
        U_ACL, _ = npc.polar(AC_L.combine_legs([['vL', 'p']], qconj=[+1]))
        U_CL, _ = npc.polar(C_L)
        AL = npc.tensordot(U_ACL.split_legs([0]), U_CL.conj(),
                           axes=[['vR'], ['vR*']]).ireplace_label('vL*',
                                                                  'vR')
        U_ACR, _ = npc.polar(AC_R.combine_legs([['p', 'vR']], qconj=[-1]),
                             left=True)
        U_CR, _ = npc.polar(C_R, left=True)
        AR = npc.tensordot(U_CR.conj(), U_ACR.split_legs([1]),
                           axes=[['vL*'], ['vL']]).ireplace_label('vR*',
                                                                  'vL')
        eps_L = float(npc.norm(AC_L - npc.tensordot(AL, C_L,
                                                    axes=[['vR'], ['vL']])))
        eps_R = float(npc.norm(AC_R - npc.tensordot(C_R, AR,
                                                    axes=[['vR'], ['vL']])))
        s1 = np.asarray(npc.svd(C_L, compute_uv=False))
        s2 = np.asarray(npc.svd(C_R, compute_uv=False))
        S_left = entropy(np.sort(s2 ** 2)[::-1] / np.sum(s2 ** 2), 1)
        S_right = entropy(np.sort(s1 ** 2)[::-1] / np.sum(s1 ** 2), 1)
        if self.update_timing:
            self.update_timing[-1]['polar'] += time.time() - t0
        return AL, AR, eps_L, eps_R, S_left, S_right


class SingleSiteVUMPSEngine(VUMPSEngine):
    """Single-site VUMPS: fixed bond dimension, fully translation
    invariant."""

    EffectiveH = OneSiteH

    def mixer_activate(self):
        # the raw option: with no DefaultMixer the base class would ignore
        # mixer=True silently
        if self.options.get('mixer', False):
            raise NotImplementedError(
                "no mixer for SingleSiteVUMPS (fixed chi); use "
                "TwoSiteVUMPSEngine to grow the bond dimension")
        super().mixer_activate()

    def update_env(self, **update_data):
        """The guess of the next fixed point: the current environments,
        rotated by the diagonal gauge's unitaries where they are set."""
        if self.env is not None:
            L = self.psi.L
            self.guess_init_env_data = {
                'init_LP': self.env.get_LP(0, store=False),
                'init_RP': self.env.get_RP(L - 1, store=False)}
        psi = self.psi
        if psi.left_U is not None and self.guess_init_env_data is not None:
            LP = self.guess_init_env_data['init_LP']
            LP = npc.tensordot(psi.left_U.conj(), LP,
                               axes=[['vL*'], ['vR*']])
            LP = npc.tensordot(LP, psi.left_U, axes=[['vR'], ['vL']])
            LP.iset_leg_labels(['vR*', 'wR', 'vR'])
            self.guess_init_env_data['init_LP'] = LP
        if psi.right_U is not None and self.guess_init_env_data is not None:
            RP = self.guess_init_env_data['init_RP']
            RP = npc.tensordot(psi.right_U, RP, axes=[['vR'], ['vL']])
            RP = npc.tensordot(RP, psi.right_U.conj(),
                               axes=[['vL*'], ['vR*']])
            RP.iset_leg_labels(['vL', 'wL', 'vL*'])
            self.guess_init_env_data['init_RP'] = RP
        psi.left_U = psi.right_U = None

    def update_local(self, theta, optimize=True):
        """Two zero-site and one one-site eigensolve, then AL and AR by
        polar decompositions."""
        psi = self.psi
        i0 = self.i0
        AC, C1, C2 = theta
        E0_1, theta0_1, N0_1 = self.eigensolve(self.eff_H0_1, C1)
        if psi.L > 1:
            E0_2, theta0_2, N0_2 = self.eigensolve(self.eff_H0_2, C2)
        E1, theta1, N1 = self.eigensolve(self.eff_H, AC)
        if psi.L == 1:
            E0_2, theta0_2, N0_2 = E0_1, theta0_1, N0_1
        theta1.ireplace_label('p0', 'p')
        psi.set_C(i0, theta0_1)
        psi.set_C(i0 + 1, theta0_2)
        psi.set_B(i0, theta1, 'AC')
        AL, AR, eps_L, eps_R, S_1, S_2 = self.polar_max(theta1, theta0_1,
                                                        theta0_2)
        psi.set_B(i0, AL, 'AL')
        psi.set_B(i0, AR, 'AR')
        self._entropy_approx[i0 % psi.L] = S_1
        self._entropy_approx[(i0 + 1) % psi.L] = S_2
        self.trunc_err_list.append(0.)
        # find_init_LP_RP's energies are [e_R, e_L]
        return {'e_L': np.real(self.transfer_matrix_energy[1]),
                'e_R': np.real(self.transfer_matrix_energy[0]),
                'eps_L': eps_L, 'eps_R': eps_R,
                'e_C1': E0_1, 'e_C2': E0_2, 'e_theta': E1,
                'N0_L': N0_1, 'N0_R': N0_2, 'N1': N1}

    def polar_max(self, AC, C1, C2):
        """AL and AR with ``AL C2 = AC = C1 AR``, by polar decompositions;
        the split errors and the entropies of C1 and C2."""
        return self._polar_split(AC, C2, AC, C1)


class TwoSiteVUMPSEngine(VUMPSEngine):
    """Two-site VUMPS: the bond dimension grows by a truncated SVD."""

    EffectiveH = TwoSiteH
    DefaultMixer = DensityMatrixMixer

    def __init__(self, psi, model, options, *, device='cuda', **kwargs):
        super().__init__(psi, model, options, device=device, **kwargs)
        if not self.psi.L > 1:
            raise ValueError("two-site VUMPS needs a unit cell of L > 1")

    def mixer_activate(self):
        super().mixer_activate()
        if isinstance(self.mixer, DensityMatrixMixer) and self.psi.L <= 2:
            # the density-matrix mixer needs independent LP(i0) and
            # RP(i0+1); in a cell of 2 sites they wrap onto the bond updated
            raise NotImplementedError(
                "DensityMatrixMixer needs a unit cell of L > 2 for VUMPS; "
                "use mixer='SubspaceExpansion'")

    def update_env(self, **update_data):
        self.guess_init_env_data = None     # chi changes: no reuse

    def update_local(self, theta, optimize=True):
        """Two zero-site and one two-site eigensolve, the truncated
        (mixed) SVD of theta, then AR1 and AL2 by polar decompositions."""
        psi = self.psi
        i0 = self.i0
        AC, C1, C2 = theta
        E0_1, theta0_1, N0_1 = self.eigensolve(self.eff_H0_1, C1)
        E0_2, theta0_2, N0_2 = self.eigensolve(self.eff_H0_2, C2)
        E2, theta2, N2 = self.eigensolve(self.eff_H, AC)
        theta2 = theta2.combine_legs([['vL', 'p0'], ['p1', 'vR']],
                                     qconj=[+1, -1])
        t0 = time.time()
        U, S, VH, err, S_a = self.mixed_svd(theta2)
        if self.update_timing:
            self.update_timing[-1]['svd'] += time.time() - t0
        AL1 = U.split_legs([0]).ireplace_label('p0', 'p')
        AR2 = VH.split_legs([1]).ireplace_label('p1', 'p')
        AC1 = npc.tensordot(AL1, S, axes=[['vR'], ['vL']])
        AC2 = npc.tensordot(S, AR2, axes=[['vR'], ['vL']])
        psi.set_C(i0, theta0_1)
        psi.set_C(i0 + 2, theta0_2)
        psi.set_C(i0 + 1, S)
        psi.set_B(i0, AL1, 'AL')
        psi.set_B(i0 + 1, AR2, 'AR')
        psi.set_B(i0, AC1, 'AC')
        psi.set_B(i0 + 1, AC2, 'AC')
        AL2, AR1, eps_L, eps_R, S_1, S_2 = self.polar_max(AC1, AC2, theta0_1,
                                                          theta0_2)
        psi.set_B(i0, AR1, 'AR')
        psi.set_B(i0 + 1, AL2, 'AL')
        self._entropy_approx[i0 % psi.L] = S_1
        self._entropy_approx[(i0 + 1) % psi.L] = entropy(
            S_a ** 2 / np.sum(S_a ** 2), 1)
        self._entropy_approx[(i0 + 2) % psi.L] = S_2
        self.trunc_err_list.append(err.eps)
        return {'e_L': np.real(self.transfer_matrix_energy[1]),
                'e_R': np.real(self.transfer_matrix_energy[0]),
                'eps_L': eps_L, 'eps_R': eps_R,
                'e_C1': E0_1, 'e_C2': E0_2, 'e_theta': E2,
                'N0_L': N0_1, 'N0_R': N0_2, 'N1': N2}

    def mixed_svd(self, theta):
        """The truncated SVD of the two-site theta, ``S`` as a bond matrix.

        Without a mixer a plain truncated SVD (``S`` diagonal); with a
        one-site mixer (``SubspaceExpansion``) its ``mixed_svd_2site``; with
        the ``DensityMatrixMixer`` its ``perturb_svd`` (``S`` then a
        general matrix, which a UniformMPS's C is anyway)."""
        if self.mixer is None:
            U, S, VH, err, _ = svd_theta(theta, self.trunc_params,
                                         inner_labels=['vR', 'vL'])
            S_a = np.asarray(S)
        elif self.mixer.update_sites == 1:
            U, S, VH, err, S_a = self.mixer.mixed_svd_2site(self, theta,
                                                             self.i0)
        else:
            U, S, VH, err, S_a = self.mixer.perturb_svd(self, theta, self.i0,
                                                        True, True)
        if isinstance(S, npc.Array):
            return U, S, VH, err, np.asarray(S_a)
        S_npc = npc.diag(np.asarray(S), U.get_leg('vR').conj(),
                         labels=['vL', 'vR'])
        return U, S_npc, VH, err, np.asarray(S_a)

    def polar_max(self, AC1, AC2, C1, C3):
        """AR1 with ``C1 AR1 = AC1`` and AL2 with ``AL2 C3 = AC2``; the
        split errors and the entropies of C1 and C3."""
        return self._polar_split(AC2, C3, AC1, C1)
