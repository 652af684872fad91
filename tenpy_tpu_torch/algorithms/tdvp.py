r"""Time-Dependent Variational Principle: one- and two-site TDVP of a finite
MPS, with the local evolutions on the card.

Port of ``tenpy_tpu/algorithms/tdvp.py``: :class:`TDVPEngine`,
:class:`SingleSiteTDVPEngine`, :class:`TwoSiteTDVPEngine` and the
time-dependent :class:`TimeDependentSingleSiteTDVP`,
:class:`TimeDependentTwoSiteTDVP`.  A step of ``dt`` is a right sweep and a
left sweep of ``dt/2`` each (the second-order symmetric integrator); the
sweeps carry the centre tensor, so the cached environments stay valid for
the opposite sweep.  The state and environments are host Arrays.

Every local update is a Krylov exponential ``exp(delta H_eff) theta``.
``device`` (a keyword of the engines; default ``'cuda'``, which raises
where PyTorch sees no card) says where the two- and one-site ones run:
on a CUDA device those with an effective problem of size N from
``mps_common.DEVICE_EVOLUTION_THRESHOLD`` (64; its comment gives the
measurements behind it) up go to
:func:`~tenpy_tpu_torch.algorithms.mps_common.lanczos_evolve_packed`,
whose matvecs are packed tensordots (four launches of the hand-written
kernel per two-site matvec, three per one-site matvec); LP, RP and theta
are promoted once per update to the type of the problem and packed, each W
once per engine and type.  The rest, the zero-site (bond) evolutions of
single-site TDVP included, run the host
:class:`~tenpy_tpu_torch.linalg.krylov_based.LanczosEvolution`.  A failure
on the card raises; nothing retries on the host.
"""

from __future__ import annotations

import logging

import numpy as np

from . import mps_common
from .algorithm import TimeEvolutionAlgorithm, TimeDependentHAlgorithm
from .mps_common import TwoSiteH, OneSiteH, ZeroSiteH
from ..linalg import np_conserved as npc
from ..linalg import packed as pk
from ..linalg.krylov_based import LanczosEvolution
from ..linalg.truncation import TruncationError, svd_theta
from ..networks.mpo import MPOEnvironment
from ..tools.params import asConfig
from .dmrg import _to_host

logger = logging.getLogger(__name__)

__all__ = ['TDVPEngine', 'TwoSiteTDVPEngine', 'SingleSiteTDVPEngine',
           'TimeDependentSingleSiteTDVP', 'TimeDependentTwoSiteTDVP']

class TDVPEngine(TimeEvolutionAlgorithm):
    """The base of the TDVP engines (finite MPS).

    Options: ``dt``, ``N_steps``, ``trunc_params`` (two-site),
    ``lanczos_options`` (of the local Krylov evolutions: ``N_min`` 2,
    ``N_max`` 20, ``P_tol`` 1e-14, ``cutoff`` 1e-12, ``E_shift`` None, on
    either route).  ``device``: where
    the two- and one-site local evolutions run from the threshold up
    (default ``'cuda'``).  ``evolve_stats`` lists per local evolution
    ``(sites, N, 'device' | 'host', Krylov steps)``.
    """

    def __init__(self, psi, model, options, *, device='cuda', **kwargs):
        self.device = pk.checked_device(device)
        super().__init__(psi, model, options, **kwargs)
        if psi.bc != 'finite':
            raise NotImplementedError("TDVP is implemented for finite MPS")
        self.lanczos_options = self.options.subconfig('lanczos_options')
        self.env = MPOEnvironment(psi, model.H_MPO, psi)
        self.trunc_err = TruncationError()
        self.evolve_stats = []
        self._packed_W = {}
        self._packed_env = []

    def prepare_evolve(self, dt):
        pass

    def evolve(self, N_steps, dt):
        trunc_err = TruncationError()
        for _ in range(N_steps):
            trunc_err += self.evolve_step(dt)
        self.evolved_time = self.evolved_time + N_steps * dt
        self.trunc_err = self.trunc_err + trunc_err
        return trunc_err

    def evolve_step(self, dt):
        raise NotImplementedError

    # ----------------------------------------------------- local evolutions
    def _lanczos_opts(self):
        opts = dict(self.lanczos_options.as_dict())
        opts.setdefault('N_max', 20)
        opts.setdefault('P_tol', 1e-14)
        return opts

    def _evolve_local(self, H, theta, delta):
        """``exp(delta H) theta``, normalized (``delta = -1j dt/2`` forward,
        ``+1j dt/2`` backward)."""
        if self._use_device_evolution(H):
            psi_t, N = self._evolve_device(H, theta, delta)
            route = 'device'
        else:
            psi_t, N = LanczosEvolution(H, theta, self._lanczos_opts()).run(
                delta, normalize=True)
            route = 'host'
        self.evolve_stats.append((H.length, H.N, route, N))
        return psi_t

    def _use_device_evolution(self, H):
        """Whether this local evolution runs packed on ``self.device``: a
        plain two- or one-site effective H of size N from
        ``mps_common.DEVICE_EVOLUTION_THRESHOLD`` up, never with the engine
        on the CPU."""
        if type(H) not in (TwoSiteH, OneSiteH) or H.combine:
            return False
        if self.device.type == 'cpu':
            return False
        return H.N >= mps_common.DEVICE_EVOLUTION_THRESHOLD

    def _pack_env(self, arr, dtype):
        """``arr`` (an LP or RP) in ``dtype``, packed on the device; the
        last few are kept, so an environment shared by neighbouring
        updates is packed once."""
        for src, dt, packed in self._packed_env:
            if src is arr and dt == dtype:
                return packed
        packed = mps_common.pack_virtual(arr, self.device, dtype)
        self._packed_env = [(arr, dtype, packed)] + self._packed_env[:3]
        return packed

    def _pack_W(self, i, W, dtype):
        """The W of site ``i`` (labels as given) in ``dtype``, packed once
        per engine."""
        key = (i, tuple(W.get_leg_labels()), dtype)
        if key not in self._packed_W:
            self._packed_W[key] = mps_common.pack_W(W, self.device, dtype)
        return self._packed_W[key]

    def _evolve_device(self, H, theta, delta):
        """The local evolution by
        :func:`~tenpy_tpu_torch.algorithms.mps_common.lanczos_evolve_packed`
        on ``self.device``; the result comes back to the host in one
        copy."""
        Ws = [H.W0] + ([H.W1] if H.length == 2 else [])
        dtype = npc.result_type(H.LP.dtype, H.RP.dtype, theta.dtype,
                                *[W.dtype for W in Ws])
        LPp = self._pack_env(H.LP, dtype)
        RPp = self._pack_env(H.RP, dtype)
        Wps = [self._pack_W(H.i0 + k, W, dtype) for k, W in enumerate(Ws)]
        theta = theta.copy(deep=False).itranspose(H.acts_on)
        theta_p = mps_common.pack_virtual(theta, self.device, dtype)
        if H.length == 2:
            def matvec(v):
                return mps_common._matvec_2site_packed(LPp, RPp, *Wps, v)
        else:
            def matvec(v):
                return mps_common._matvec_1site_packed(LPp, RPp, *Wps, v)
        opts = asConfig(self._lanczos_opts(), 'LanczosEvolution')
        th, N = mps_common.lanczos_evolve_packed(
            matvec, theta_p, delta, N_min=opts.get('N_min', 2, int),
            N_max=opts.get('N_max', 20, int),
            P_tol=opts.get('P_tol', 1e-14, 'real'),
            cutoff=opts.get('cutoff', 1e-12, 'real'),
            E_shift=opts.get('E_shift', None, 'real'), normalize=True)
        res = pk.unpack(_to_host(th), orig_legs=[theta.get_leg(lab) for lab
                                                 in th.get_leg_labels()])
        return res, N

    def _site0_to_B_form(self):
        """Bring site 0 from Th into B form, keeping the global phase and
        norm: the 1x1 U of the boundary SVD is a pure phase (kept in the
        tensor), the SVD's norm goes into ``psi.norm``."""
        psi = self.psi
        th0_c = psi.get_B(0, None).combine_legs([['p', 'vR']], qconj=[-1])
        th0_c.itranspose(['vL', '(p.vR)'])
        U, S, VH = npc.svd(th0_c, inner_labels=['vR', 'vL'])
        renorm = np.linalg.norm(np.asarray(S))
        phase = complex(U.to_numpy().item())
        B0 = VH.split_legs([1])
        if abs(phase - 1.) > 1e-15:
            B0 = B0 * (phase / abs(phase))
        psi.set_B(0, B0, form='B')
        psi.set_SL(0, np.ones(1))
        psi.norm *= renorm * abs(phase)


class SingleSiteTDVPEngine(TDVPEngine):
    """One-site TDVP: the bond dimension stays, no truncation.  Each site's
    forward evolution is followed by the backward evolution of the bond
    matrix (``ZeroSiteH``, on the host)."""

    def evolve_step(self, dt):
        psi = self.psi
        env = self.env
        L = psi.L
        # the right sweep with dt/2
        theta = psi.get_theta(0, 1)
        for i in range(L):
            H1 = OneSiteH(env, i, combine=False)
            theta = self._evolve_local(H1, theta, -0.5j * dt)
            if i < L - 1:
                theta = theta.combine_legs([['vL', 'p0']], qconj=[+1])
                U, S, VH = npc.svd(theta, inner_labels=['vR', 'vL'])
                S = np.asarray(S)
                S = S / np.linalg.norm(S)
                psi.set_B(i, U.split_legs([0]).ireplace_label('p0', 'p'),
                          form='A')
                psi.set_SR(i, S)
                H1.update_LP(env, i + 1)
                C = VH.iscale_axis(S, 'vL')
                C.iset_leg_labels(['vL', 'vR'])
                C = self._evolve_local(ZeroSiteH(env, i + 1), C, +0.5j * dt)
                theta = npc.tensordot(C, psi.get_B(i + 1, 'B'),
                                      axes=[['vR'], ['vL']])
                theta.ireplace_label('p', 'p0')
            else:
                psi.set_B(i, theta.replace_label('p0', 'p'), form='Th')
        # the left sweep with dt/2
        theta = psi.get_theta(L - 1, 1)
        for i in range(L - 1, -1, -1):
            H1 = OneSiteH(env, i, combine=False, move_right=False)
            theta = self._evolve_local(H1, theta, -0.5j * dt)
            if i > 0:
                theta = theta.combine_legs([['p0', 'vR']], qconj=[-1])
                theta.itranspose(['vL', '(p0.vR)'])
                U, S, VH = npc.svd(theta, inner_labels=['vR', 'vL'])
                S = np.asarray(S)
                S = S / np.linalg.norm(S)
                psi.set_B(i, VH.split_legs([1]).ireplace_label('p0', 'p'),
                          form='B')
                psi.set_SL(i, S)
                H1.update_RP(env, i - 1)
                C = U.iscale_axis(S, 'vR')
                C.iset_leg_labels(['vL', 'vR'])
                C = self._evolve_local(ZeroSiteH(env, i), C, +0.5j * dt)
                theta = npc.tensordot(psi.get_B(i - 1, 'A'), C,
                                      axes=[['vR'], ['vL']])
                theta.ireplace_label('p', 'p0')
            else:
                psi.set_B(0, theta.replace_label('p0', 'p'), form='Th')
        self._site0_to_B_form()
        return TruncationError()


class TwoSiteTDVPEngine(TDVPEngine):
    """Two-site TDVP: two-site thetas evolved and split by a truncated SVD
    (the bond dimension grows up to ``trunc_params``), each followed by the
    backward one-site evolution of the next centre."""

    def evolve_step(self, dt):
        psi = self.psi
        env = self.env
        L = psi.L
        err_tot = TruncationError()
        # the right sweep with dt/2
        theta = psi.get_theta(0, 2)
        for i in range(L - 1):
            H2 = TwoSiteH(env, i, combine=False)
            theta = self._evolve_local(H2, theta, -0.5j * dt)
            theta = theta.combine_legs([['vL', 'p0'], ['p1', 'vR']],
                                       qconj=[+1, -1])
            U, S, VH, err, renorm = svd_theta(theta, self.trunc_params,
                                              inner_labels=['vR', 'vL'])
            err_tot += err
            psi.norm *= renorm
            psi.set_B(i, U.split_legs([0]).ireplace_label('p0', 'p'),
                      form='A')
            psi.set_SR(i, S)
            H2.update_LP(env, i + 1)
            theta1 = VH.iscale_axis(np.asarray(S), 'vL').split_legs([1])
            theta1.ireplace_label('p1', 'p0')
            if i < L - 2:
                H1 = OneSiteH(env, i + 1, combine=False)
                theta1 = self._evolve_local(H1, theta1, +0.5j * dt)
                theta = npc.tensordot(theta1,
                                      psi.get_B(i + 2, 'B', label_p=1),
                                      axes=[['vR'], ['vL']])
            else:
                theta = theta1
        # the left sweep with dt/2, from the one-site theta of site L-1
        for i in range(L - 2, -1, -1):
            theta = npc.tensordot(psi.get_B(i, 'A', label_p=0),
                                  theta.replace_label('p0', 'p1'),
                                  axes=[['vR'], ['vL']])
            H2 = TwoSiteH(env, i, combine=False)
            theta = self._evolve_local(H2, theta, -0.5j * dt)
            theta = theta.combine_legs([['vL', 'p0'], ['p1', 'vR']],
                                       qconj=[+1, -1])
            U, S, VH, err, renorm = svd_theta(theta, self.trunc_params,
                                              inner_labels=['vR', 'vL'])
            err_tot += err
            psi.norm *= renorm
            psi.set_B(i + 1, VH.split_legs([1]).ireplace_label('p1', 'p'),
                      form='B')
            psi.set_SR(i, S)
            H2.update_RP(env, i)
            theta1 = U.iscale_axis(np.asarray(S), 'vR').split_legs([0])
            if i > 0:
                H1 = OneSiteH(env, i, combine=False, move_right=False)
                theta = self._evolve_local(H1, theta1, +0.5j * dt)
            else:
                psi.set_B(0, theta1.replace_label('p0', 'p'), form='Th')
        self._site0_to_B_form()
        return err_tot


class TimeDependentSingleSiteTDVP(TimeDependentHAlgorithm,
                                  SingleSiteTDVPEngine):
    """One-site TDVP with ``H(t)``: the environments are rebuilt with each
    re-built model."""

    def reinit_model(self):
        TimeDependentHAlgorithm.reinit_model(self)
        self.env = MPOEnvironment(self.psi, self.model.H_MPO, self.psi)
        self._packed_W = {}


class TimeDependentTwoSiteTDVP(TimeDependentHAlgorithm, TwoSiteTDVPEngine):
    """Two-site TDVP with ``H(t)``."""

    def reinit_model(self):
        TimeDependentHAlgorithm.reinit_model(self)
        self.env = MPOEnvironment(self.psi, self.model.H_MPO, self.psi)
        self._packed_W = {}
