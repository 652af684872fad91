r"""Density Matrix Renormalization Group: two- and single-site, finite and
infinite, the way TeNPy users run it.

Port of ``tenpy_tpu/algorithms/dmrg.py``: :func:`run`,
:class:`DMRGEngine`, :class:`TwoSiteDMRGEngine`,
:class:`SingleSiteDMRGEngine`, :func:`chi_list` and
:func:`full_diag_effH`, on the sweeps of
:mod:`~tenpy_tpu_torch.algorithms.mps_common`.  The state, the
environments and the local updates live on the host as
:class:`~tenpy_tpu_torch.linalg.np_conserved.Array` s with CPU blocks.

``device`` (a keyword of the engines and of :func:`run`; default
``'cuda'``, which raises where PyTorch sees no card) says where the two-site
eigensolve runs when the engine sends it to the packed Lanczos
(:meth:`DMRGEngine._use_device_lanczos`: forced by
``lanczos_params['device_K'] > 0``, disabled by 0, else from
``DEVICE_LANCZOS_THRESHOLD`` = 256 up, the card's crossover against the
host Lanczos measured on an H100 by ``chip_smoke.py`` phase 9, ``chi_list``
ramp included; never on the CPU by default).  There the environments, W
tensors and guess are packed onto the device, each matvec is four launches
of the hand-written kernel
(:func:`~tenpy_tpu_torch.linalg.grouped_gemm.packed_contract`), and the
ground state comes back to the host.  A failure there raises; the
engine never retries on the host Lanczos.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from . import mps_common
from .mps_common import (IterativeSweeps, TwoSiteH, OneSiteH, EffectiveH,
                         DensityMatrixMixer, SubspaceExpansion)
from ..linalg import np_conserved as npc
from ..linalg import packed as pk
from ..linalg.krylov_based import LanczosGroundState, lanczos_arpack
from ..linalg.sparse import (FlatHermitianOperator,
                             OrthogonalNpcLinearOperator)
from ..linalg.truncation import svd_theta
from ..tools.params import asConfig
from ..tools.process import memory_usage

logger = logging.getLogger(__name__)

__all__ = ['run', 'DMRGEngine', 'TwoSiteDMRGEngine', 'SingleSiteDMRGEngine',
           'chi_list', 'full_diag_effH']


def run(psi, model, options, **kwargs):
    """Find the MPS ground state of ``model`` with DMRG; updates ``psi``.

    ``options['active_sites']`` (2) picks the engine; ``kwargs`` go to it
    (``device``, ``orthogonal_to``, ``resume_data``, ``cache``).  Returns a
    dict with ``'E'``, ``'shelve'``, ``'bond_statistics'`` and
    ``'sweep_statistics'``.
    """
    options = asConfig(options, 'DMRG')
    active_sites = options.get('active_sites', 2, int)
    if active_sites == 1:
        engine = SingleSiteDMRGEngine(psi, model, options, **kwargs)
    elif active_sites == 2:
        engine = TwoSiteDMRGEngine(psi, model, options, **kwargs)
    else:
        raise ValueError("active_sites must be 1 or 2")
    E, _ = engine.run()
    return {'E': E, 'shelve': engine.shelve,
            'bond_statistics': engine.update_stats,
            'sweep_statistics': engine.sweep_stats}


class DMRGEngine(IterativeSweeps):
    """The DMRG engine: variational ground-state search by sweeps.

    Options: ``N_sweeps_check`` (10; 1 for finite bc), ``min_sweeps``,
    ``max_sweeps``, ``max_E_err`` (1e-8), ``max_S_err`` (1e-5),
    ``lanczos_params`` (with ``device_K``), ``trunc_params``,
    ``chi_list``, ``mixer``, ``mixer_params``, ``combine``,
    ``diag_method`` ('default' | 'lanczos' | 'arpack' | 'ED_block' |
    'ED_all'), ``norm_tol`` (1e-5), ``update_env``, ``P_tol_to_trunc``,
    ``P_tol_min``, ``P_tol_max``.  ``device``: where the packed Lanczos
    runs (default ``'cuda'``).
    """

    EffectiveH = None
    DefaultMixer = None

    def __init__(self, psi, model, options, *, device='cuda', **kwargs):
        self.device = pk.checked_device(device)
        options = asConfig(options, self.__class__.__name__)
        self.diag_method = options.get('diag_method', 'default', str)
        self._entropy_approx = [None] * psi.L
        super().__init__(psi, model, options, **kwargs)

    def reset_stats(self, resume_data=None):
        super().reset_stats(resume_data)
        self.E_trunc_list = []
        self._meas_E_trunc = False
        self.device_lanczos_stats = {'plain': 0, 'plain_steps': 0,
                                     'projected': 0, 'projected_steps': 0,
                                     'N': []}
        self.update_stats = {'i0': [], 'age': [], 'E_total': [],
                             'E_trunc': [], 'N_lanczos': [], 'time': [],
                             'err': [], 'ov_change': []}
        self.sweep_stats = {'sweep': [], 'N_updates': [], 'E': [],
                            'Delta_E': [], 'S': [], 'Delta_S': [],
                            'max_S': [], 'time': [], 'max_trunc_err': [],
                            'max_E_trunc': [], 'max_chi': [],
                            'norm_err': []}
        self._entropy_approx = [None] * self.psi.L

    def pre_run_initialize(self):
        super().pre_run_initialize()
        self.mixer_activate()
        self.E_old = np.nan
        self.S_old = np.nan

    def run_iteration(self):
        """``N_sweeps_check`` sweeps, then the statistics of the last."""
        options = self.options
        N_sweeps_check = options.get('N_sweeps_check',
                                     1 if self.finite else 10, int)
        p_tol_to_trunc = options.get('P_tol_to_trunc', 0.05, 'real')
        p_tol_min = options.get('P_tol_min', 5e-16, 'real')
        p_tol_max = options.get('P_tol_max', 1e-4, 'real')
        self.E_trunc_list = []
        for _ in range(N_sweeps_check - 1):
            self.sweep()
        self._meas_E_trunc = True   # the energy after truncation, last sweep
        try:
            max_trunc_err = self.sweep()
        finally:
            self._meas_E_trunc = False
        # the Lanczos tolerance follows the truncation level
        if p_tol_to_trunc is not None and max_trunc_err > p_tol_min:
            self.lanczos_params['P_tol'] = max(
                p_tol_min, min(p_tol_max, max_trunc_err * p_tol_to_trunc))
        if not self.finite:
            update_env = options.get('update_env', N_sweeps_check // 2, int)
            self.environment_sweeps(update_env)
        entropy_bonds = [s for s in self._entropy_approx if s is not None] \
            or [0.]
        max_S = max(entropy_bonds)
        S = np.mean(entropy_bonds)
        if not self.finite:
            Es = self.update_stats['E_total']
            age = self.update_stats['age']
            delta = min(1 + 2 * self.env.L, len(age))
            growth = max(age[-1] - age[-delta], 1)
            E = (Es[-1] - Es[-delta]) / growth
        else:
            E = self.update_stats['E_total'][-1]
        norm_err = np.linalg.norm(self.psi.norm_test())
        ss = self.sweep_stats
        ss['sweep'].append(self.sweeps)
        ss['N_updates'].append(len(self.update_stats['i0']))
        ss['E'].append(E)
        ss['Delta_E'].append((E - self.E_old) / max(N_sweeps_check, 1))
        ss['S'].append(S)
        ss['Delta_S'].append((S - self.S_old) / max(N_sweeps_check, 1))
        ss['max_S'].append(max_S)
        ss['time'].append(time.time() - self.time0)
        ss['max_trunc_err'].append(max_trunc_err)
        ss['max_E_trunc'].append(np.max(self.E_trunc_list)
                                 if self.E_trunc_list else 0.)
        ss['max_chi'].append(max(self.psi.chi) if self.psi.chi else 1)
        ss['norm_err'].append(norm_err)
        self.E_old = E
        self.S_old = S
        return E, self.psi

    def status_update(self, iteration_start_time):
        logger.info(
            "sweep %d: E=%.14f, dE=%.3e, S=%.10f, max_chi=%d, trunc=%.3e, "
            "norm_err=%.1e, mem=%.1fMB",
            self.sweeps, self.sweep_stats['E'][-1],
            self.sweep_stats['Delta_E'][-1], self.sweep_stats['S'][-1],
            self.sweep_stats['max_chi'][-1],
            self.sweep_stats['max_trunc_err'][-1],
            self.sweep_stats['norm_err'][-1], memory_usage())

    def _plot_stats(self, stats, axes, xaxis, yaxis, y_exact, **kwargs):
        if axes is None:
            import matplotlib.pyplot as plt
            axes = plt.gca()
        if xaxis is None or xaxis == 'index':
            x = np.arange(len(stats[yaxis]))
            xlabel = 'index'
        else:
            x = np.asarray(stats[xaxis])
            xlabel = xaxis
        y = np.asarray(stats[yaxis])
        ylabel = yaxis
        if y_exact is not None:
            y = np.abs(y - y_exact)
            ylabel = f'|{yaxis} - exact|'
            axes.set_yscale('log')
        axes.plot(x[:len(y)], y, **kwargs)
        axes.set_xlabel(xlabel)
        axes.set_ylabel(ylabel)
        return axes

    def plot_update_stats(self, axes=None, xaxis='time', yaxis='E_total',
                          y_exact=None, **kwargs):
        """Plot a statistic per update (default: energy against time);
        ``y_exact`` plots ``|y - y_exact|`` on a log scale."""
        stats = dict(self.update_stats)
        if not stats.get('time'):
            stats['time'] = list(range(len(stats[yaxis])))
        if yaxis == 'E':
            yaxis = 'E_total'
        return self._plot_stats(stats, axes, xaxis, yaxis, y_exact, **kwargs)

    def plot_sweep_stats(self, axes=None, xaxis='time', yaxis='E',
                         y_exact=None, **kwargs):
        """Plot a statistic per sweep (default: energy against time)."""
        return self._plot_stats(self.sweep_stats, axes, xaxis, yaxis,
                                y_exact, **kwargs)

    def is_converged(self):
        """Converged once ``|Delta E| < max_E_err max(|E|, 1)`` and
        ``|Delta S| < max_S_err``."""
        max_E_err = self.options.get('max_E_err', 1e-8, 'real')
        max_S_err = self.options.get('max_S_err', 1e-5, 'real')
        if len(self.sweep_stats['E']) < 1:
            return False
        E = self.sweep_stats['E'][-1]
        return abs(self.sweep_stats['Delta_E'][-1]) < \
            max_E_err * max(abs(E), 1.) and \
            abs(self.sweep_stats['Delta_S'][-1]) < max_S_err

    def run(self):
        E, psi = super().run()
        if not self.finite:
            # the sweep estimate of the energy density (finite differences
            # of aged contractions) is noisy across environment restarts;
            # the transfer-matrix fixed point of the final state is the
            # energy reported, evaluated on a copy with noise-floor Schmidt
            # directions compressed away and guarded by the sweep estimate
            from ..networks.mpo import MPOTransferMatrix
            try:
                psi_eval = self.psi.copy()
                if min((float(np.min(np.asarray(s))) for s in psi_eval._S
                        if not isinstance(s, npc.Array)), default=1.) < 1e-8:
                    psi_eval.compress_svd({'chi_max': max(psi_eval.chi),
                                           'svd_min': 3e-8,
                                           'trunc_cut': None})
                _, Es, _ = MPOTransferMatrix.find_init_LP_RP(
                    self.env.H, psi_eval, calc_E=True)
                E_tm = float(np.mean(np.real(Es)))
                if abs(E_tm - E) > 1e-1 * max(1., abs(E)):
                    logger.warning(
                        "final TM energy %.10f disagrees with the sweep"
                        "-statistics estimate %.10f at O(1); keeping the "
                        "sweep estimate (pathological TM solve?)", E_tm, E)
                else:
                    if abs(E_tm - E) > 1e-3 * max(1., abs(E)):
                        logger.info("sweep-statistics energy estimate %.10f "
                                    "is far from the final TM energy %.10f "
                                    "(young environments?); reporting the "
                                    "TM energy", E, E_tm)
                    E = E_tm
            except Exception as e:
                logger.warning("final TM energy evaluation failed (%s); "
                               "keeping the sweep-statistics estimate", e)
        return E, psi

    def post_run_cleanup(self):
        """Canonicalize where the norm error grew above ``norm_tol``."""
        super().post_run_cleanup()
        if self.psi.bc == 'segment':
            return
        norm_tol = self.options.get('norm_tol', 1e-5, 'real')
        norm_err = np.linalg.norm(self.psi.norm_test())
        if norm_err > norm_tol:
            logger.info("norm_err=%.2e > norm_tol: canonicalize", norm_err)
            self._canonicalize()
        elif not self.finite and self.psi.gauge_consistency_error() > 1e-6:
            # noise-floor Schmidt directions carrying Lanczos residue:
            # canonical_form compresses them away
            logger.info("noise-floor Schmidt directions are gauge-"
                        "inconsistent: canonicalize")
            self._canonicalize()

    def _canonicalize(self):
        norm_tol_iter = self.options.get('norm_tol_iter', 5, 'real')
        self.psi.canonical_form()
        self.env.clear()
        self.env.init_first_LP_last_RP()
        if not self.finite:
            self.environment_sweeps(int(norm_tol_iter))
        if not self.env.H.dtype.is_complex:
            self.psi.real_if_close()

    # ----------------------------------------------------------- updates
    def update_local(self, theta, optimize=True):
        """Diagonalize ``eff_H``, truncate, set the new tensors."""
        i0 = self.i0
        age = self.env.get_LP_age(i0) + self.n_optimize + \
            self.env.get_RP_age(i0 + self.n_optimize - 1)
        if optimize:
            E0, theta, N, ov_change = self.diag(theta)
        else:
            E0, N, ov_change = None, 0, 0.
        theta = self.prepare_svd(theta)
        U, S, VH, err, S_approx = self.mixed_svd(theta)
        self.set_B(U, S, VH)
        return {'E0': E0, 'err': err, 'N': N, 'age': age, 'U': U, 'VH': VH,
                'ov_change': ov_change}

    def post_update_local(self, E0, age, N, ov_change, err, **update_data):
        self.trunc_err_list.append(err.eps)
        E_trunc = None
        meas = self._meas_E_trunc and getattr(self, 'mixer', None) is None
        if meas or E0 is None:
            # the energy of the truncated state from the updated
            # environments (not with a mixer on: the bond then holds a
            # matrix and the state is not canonical mid-sweep).
            # full_contraction(j) contracts LP[j] with RP[j-1], the bond
            # (j-1, j): j = i + 1 has both halves fresh
            i = self.i0 if (self.n_optimize == 2 or self.move_right) \
                else self.i0 - 1
            try:
                E_trunc = float(np.real(self.env.full_contraction(i + 1)))
            except ValueError:
                # an aged iDMRG environment may still hold a bond whose chi
                # changed during this sweep
                E_trunc = None
            if E_trunc is not None:
                if E0 is None:
                    E0 = E_trunc
                E_trunc = E_trunc - E0
            if E0 is None:
                Es = self.update_stats['E_total']
                E0 = next((e for e in reversed(Es) if e is not None), np.nan)
        us = self.update_stats
        us['i0'].append(self.i0)
        us['age'].append(age)
        us['E_total'].append(E0)
        us['E_trunc'].append(E_trunc)
        us['N_lanczos'].append(N)
        us['ov_change'].append(ov_change)
        us['err'].append(err)
        us['time'].append(time.time() - self.time0)
        self.E_trunc_list.append(0. if E_trunc is None else E_trunc)

    def diag(self, theta_guess):
        """Diagonalize the effective Hamiltonian: ``(E0, theta, N,
        ov_change)``.

        ``diag_method`` 'default' takes ``ED_block`` for an effective H of
        dimension below 64, else 'lanczos' (the packed Lanczos where
        :meth:`_use_device_lanczos` says so)."""
        N = 0
        ov_change = 0.
        if self.diag_method == 'default':
            plain = isinstance(self.eff_H, EffectiveH)
            method = 'ED_block' if (plain and self.eff_H.N < 64) \
                else 'lanczos'
        else:
            method = self.diag_method
        if method == 'lanczos':
            if self._use_device_lanczos():
                return self._diag_device_lanczos(theta_guess)
            solver = LanczosGroundState(self.eff_H, theta_guess,
                                        self.lanczos_params)
            E0, theta, N = solver.run()
            ov_change = 1. - abs(complex(npc.inner(theta_guess.conj(), theta,
                                                   axes='range')))
        elif method == 'arpack':
            E0, theta = lanczos_arpack(self.eff_H, theta_guess,
                                       self.lanczos_params)
        elif method == 'ED_block':
            E0, theta = full_diag_effH(self.eff_H, theta_guess,
                                       keep_sector=True)
        elif method == 'ED_all':
            E0, theta = full_diag_effH(self.eff_H, theta_guess,
                                       keep_sector=False)
        else:
            raise ValueError(f"unknown diag_method {method!r}")
        return E0, theta, N, ov_change

    # ------------------------------------------------- the packed Lanczos
    def _base_eff_H(self):
        """``(eff_H, ortho_vecs)``: the effective H under the projection of
        ``orthogonal_to`` (if any) and the projected vectors."""
        eff = self.eff_H
        if isinstance(eff, OrthogonalNpcLinearOperator):
            return eff.orig_operator, eff.ortho_vecs
        return eff, []

    def _use_device_lanczos(self):
        """Whether this update's eigensolve runs as the packed Lanczos on
        ``self.device``: only for a plain :class:`TwoSiteH` (no
        ``combine``), projected by ``orthogonal_to`` or not, then by
        :func:`~tenpy_tpu_torch.algorithms.mps_common.use_device_lanczos`
        (``lanczos_params['device_K']``: 0 disables, > 0 forces with that
        many steps at most; else never on the CPU, and from
        ``DEVICE_LANCZOS_THRESHOLD`` up, during a ``chi_list`` ramp
        too)."""
        eff, _ = self._base_eff_H()
        if type(eff) is not TwoSiteH or eff.combine:
            return False
        return mps_common.use_device_lanczos(self.lanczos_params,
                                             self.device, eff.N)

    def _diag_device_lanczos(self, theta_guess):
        """The packed Lanczos of this update on ``self.device``.

        LP, RP, W0 and W1 are packed once per effective H
        (:meth:`~tenpy_tpu_torch.algorithms.mps_common.EffectiveH.
        pack_operands`), the guess per call, and the projected vectors of
        ``orthogonal_to`` once per effective H in the guess's layout
        (:func:`~tenpy_tpu_torch.algorithms.mps_common.pack_ortho`); the
        Ritz vector comes back to the host in one copy.
        ``self.device_lanczos_stats`` counts the solves and their Lanczos
        steps, those with a vector projected out apart, and lists their
        N.

        The loop stops by the host ``LanczosGroundState``'s rule
        (``stop='residual'`` with ``lanczos_params``' ``N_min``, ``P_tol``,
        ``E_tol`` and ``cutoff``), after ``N_max`` steps at most (20, the
        host's default) or ``device_K`` where that is set.  ``tenpy_tpu``
        stops here on the relative change of the Ritz value after at most
        10 steps, which loosens as an iDMRG environment ages and made the
        two routes part (a departure in TeNPy's favour)."""
        eff, ortho_vecs = self._base_eff_H()
        lp = self.lanczos_params
        K = lp.get('device_K', None)
        if not K:
            K = lp.get('N_max', 20, int)
        K = int(K)
        LPp, RPp, W0p, W1p = eff.pack_operands(self.device)
        theta_p = mps_common.pack_virtual(theta_guess, self.device)
        ortho = mps_common.pack_ortho(ortho_vecs, theta_p, self.device)
        E0, th, K, _ = mps_common.lanczos_K_2site_packed(
            LPp, RPp, W0p, W1p, theta_p, K,
            float(lp.get('P_tol', 1e-14, 'real')), lp.get('N_min', 2, int),
            bool(lp.get('reortho', False)), ortho=ortho, stop='residual',
            E_tol=float(lp.get('E_tol', np.inf, 'real')),
            cutoff=float(lp.get('cutoff', 1e-12, 'real')))
        st = self.device_lanczos_stats
        kind = 'projected' if ortho else 'plain'
        st[kind] += 1
        st[kind + '_steps'] += K
        st['N'].append(eff.N)
        theta = _keep_blocks_of(pk.unpack(
            _to_host(th), orig_legs=[theta_guess.get_leg(l)
                                     for l in th.get_leg_labels()]),
            theta_guess)
        ov_change = 1. - abs(complex(npc.inner(theta_guess.conj(), theta,
                                               axes='range'))) \
            / max(float(npc.norm(theta_guess)), 1e-300)
        return E0, theta, K, ov_change

    def prepare_svd(self, theta):
        raise NotImplementedError

    def mixed_svd(self, theta):
        raise NotImplementedError

    def set_B(self, U, S, VH):
        raise NotImplementedError


def _to_host(p):
    """A packed array's buckets on the host, by one device-to-host copy."""
    if p.device.type == 'cpu':
        return p
    flat = torch.cat([d.reshape(-1) for d in p.data]).cpu()
    data = list(torch.split(flat, [d.numel() for d in p.data]))
    return pk.PackedArray(p.legs, p.qtotal, p.get_leg_labels(), p.shapes,
                          p.qdatas, [h.view(d.shape) for h, d in
                                     zip(data, p.data)], p.dtype, 'cpu')


def _keep_blocks_of(theta, guess):
    """``theta`` with a zero block for each block of ``guess`` that it
    lacks.  The host Lanczos's Ritz vector stores every block of its guess,
    one that stays zero too, while the unpack of the packed Ritz vector
    drops all-zero blocks; a stored zero block adds a sector to the
    density-matrix mixer's split, so the two routes handed the mixer
    different block structures (first at update 67 of the dipolar S=1
    chain's first sweep).  With it they hand over the same."""
    perm = [guess.get_leg_index(l) for l in theta.get_leg_labels()]
    have = {tuple(int(x) for x in r) for r in theta._qdata}
    missing = [r for r in (tuple(int(x) for x in row[perm])
                           for row in guess._qdata) if r not in have]
    if not missing:
        return theta
    zeros = [torch.zeros(npc._block_shape(theta.legs, r), dtype=theta.dtype)
             for r in missing]
    return theta._set_blocks(
        np.concatenate([theta._qdata, np.array(missing, theta._qdata.dtype)]),
        theta._data + zeros)


def _entropy(S):
    S = np.asarray(S)
    return float(-np.sum(S ** 2 * np.log(np.maximum(S ** 2, 1e-300))))


class TwoSiteDMRGEngine(DMRGEngine):
    """Two-site DMRG."""

    EffectiveH = TwoSiteH
    DefaultMixer = DensityMatrixMixer

    def prepare_svd(self, theta):
        if not self.eff_H.combine:
            theta = theta.combine_legs([['vL', 'p0'], ['p1', 'vR']],
                                       qconj=[+1, -1])
        return theta

    def mixed_svd(self, theta):
        """The truncated SVD of theta (perturbed by the mixer if on)."""
        i0 = self.i0
        update_LP, update_RP = self.update_LP_RP
        if self.mixer is None:
            qtotal_i0 = self.psi.get_B(i0, None).qtotal
            U, S, VH, err, _ = svd_theta(theta, self.trunc_params,
                                         qtotal_LR=[qtotal_i0, None],
                                         inner_labels=['vR', 'vL'])
            return U, S, VH, err, S
        if self.mixer.update_sites == 1:
            # a single-site mixer (SubspaceExpansion) on the enclosed bond
            return self.mixer.mixed_svd_2site(self, theta, i0)
        return self.mixer.perturb_svd(self, theta, i0, update_LP, update_RP)

    def set_B(self, U, S, VH):
        i0 = self.i0
        A0 = U.split_legs(['(vL.p0)']) if '(vL.p0)' in U.get_leg_labels() \
            else U
        B1 = VH.split_legs(['(p1.vR)']) \
            if '(p1.vR)' in VH.get_leg_labels() else VH
        A0.ireplace_label('p0', 'p')
        B1.ireplace_label('p1', 'p')
        self.psi.set_B(i0, A0, form='A')
        self.psi.set_B(i0 + 1, B1, form='B')
        self.psi.set_SR(i0, S)
        if isinstance(S, npc.Array):   # the mixer's bond matrix
            S = npc.svd(S, compute_uv=False)
        self._entropy_approx[(i0 + 1) % self.psi.L] = _entropy(S)


class SingleSiteDMRGEngine(DMRGEngine):
    """Single-site DMRG (grows chi through its default mixer,
    :class:`~tenpy_tpu_torch.algorithms.mps_common.SubspaceExpansion`)."""

    EffectiveH = OneSiteH
    DefaultMixer = SubspaceExpansion
    use_mixer_by_default = True

    def prepare_svd(self, theta):
        if self.eff_H.combine:
            return theta.split_legs()
        return theta

    def mixed_svd(self, theta):
        """Split theta (legs ``vL, p0, vR``) by an SVD towards the moving
        direction.  With the mixer the returned bond tensor already holds
        the Schmidt values (``self._vh_is_weighted``); without it
        :meth:`set_B` applies ``S``."""
        i0 = self.i0
        move_right = self.move_right
        psi = self.psi
        at_boundary = self.finite and ((move_right and i0 + 1 >= psi.L) or
                                       (not move_right and i0 == 0))
        self._vh_is_weighted = False
        if self.mixer is not None and not at_boundary:
            self._vh_is_weighted = True
            U_or_A, S, VH_or_B, err = self.mixer.perturb_svd(
                self, theta, i0, move_right, None)
            return U_or_A, S, VH_or_B, err, S
        if move_right:
            theta = theta.combine_legs([['vL', 'p0']], qconj=[+1])
            U, S, VH, err, _ = svd_theta(theta, self.trunc_params)
            return U.split_legs([0]), S, VH, err, S
        theta = theta.combine_legs([['p0', 'vR']], qconj=[-1])
        theta.itranspose(['vL', '(p0.vR)'])
        U, S, VH, err, _ = svd_theta(theta, self.trunc_params)
        return U, S, VH.split_legs([1]), err, S

    def set_B(self, U, S, VH):
        """Set the updated site; the other factor goes into the
        neighbour."""
        i0 = self.i0
        psi = self.psi
        if self.move_right:
            A = U.ireplace_label('p0', 'p') if 'p0' in U.get_leg_labels() \
                else U
            psi.set_B(i0, A, form='A')
            psi.set_SR(i0, S)
            if not (self.finite and i0 + 1 >= psi.L):
                nextB = psi.get_B(i0 + 1, form='B')
                C = npc.tensordot(VH, nextB, axes=[['vR'], ['vL']])
                if not self._vh_is_weighted:
                    C = C.iscale_axis(np.asarray(S), 'vL')
                psi.set_B(i0 + 1, C, form='Th')
        else:
            B = VH.ireplace_label('p0', 'p') \
                if 'p0' in VH.get_leg_labels() else VH
            psi.set_B(i0, B, form='B')
            psi.set_SL(i0, S)
            if not (self.finite and i0 - 1 < 0):
                prevA = psi.get_B(i0 - 1, form='A')
                C = npc.tensordot(prevA, U, axes=[['vR'], ['vL']])
                if not self._vh_is_weighted:
                    C = C.iscale_axis(np.asarray(S), 'vR')
                psi.set_B(i0 - 1, C, form='Th')
        self._entropy_approx[i0 % psi.L] = _entropy(S)


def chi_list(chi_max, dchi=20, nsweeps=20):
    """A ramp ``{sweep: chi}`` up to ``chi_max`` in steps of ``dchi``,
    every ``nsweeps`` sweeps."""
    chis = []
    chi = chi_max
    while chi > dchi:
        chis.append(chi)
        chi -= dchi
    chis.append(chi)
    return {i * nsweeps: c for i, c in enumerate(chis[::-1])}


def full_diag_effH(effH, theta_guess, keep_sector=True):
    """The ground state of a small effective Hamiltonian by exact
    diagonalization: ``(E0, theta)``, in the charge sector of
    ``theta_guess`` with ``keep_sector``, else over all sectors."""
    mat = effH.to_matrix()
    if keep_sector:
        theta_c = theta_guess.combine_legs([list(range(theta_guess.rank))]) \
            if theta_guess.rank > 1 else theta_guess
        flat_op = FlatHermitianOperator.from_NpcArray(
            mat, charge_sector=tuple(theta_c.qtotal))
        dense = mat.to_numpy()
        mask = flat_op._mask
        if mask is not None:
            dense = dense[np.ix_(mask, mask)]
        w, v = np.linalg.eigh(dense)
        theta = flat_op.flat_to_npc(v[:, 0])
        if theta_guess.rank > 1:
            theta = theta.split_legs([0])
        theta.iset_leg_labels(theta_guess.get_leg_labels())
        return float(w[0]), theta
    E, V = npc.eigh(mat)
    i0 = int(np.argmin(np.asarray(E)))
    vec = np.zeros(mat.legs[0].ind_len)
    vec[i0] = 1.
    # the unit vector lives on V's column leg, mat.legs[0] (tenpy_tpu puts
    # it on the conjugate leg, and its tensordot raises there)
    theta = npc.tensordot(V, npc.Array.from_ndarray(
        vec, [mat.legs[0]], warn_wrong_sector=False), axes=[[1], [0]])
    if theta_guess.rank > 1:
        theta = theta.split_legs([0])
    theta.iset_leg_labels(theta_guess.get_leg_labels())
    return float(np.asarray(E)[i0]), theta
