r"""Plane-wave (quasiparticle) excitations of a uniform MPS.

Port of ``tenpy_tpu/algorithms/plane_wave_excitation.py``
(:func:`append_right_env`, :func:`append_left_env`,
:func:`construct_orthogonal`, :class:`PlaneWaveExcitationEngine`,
:class:`MultiSitePlaneWaveExcitationEngine`); the tangent-space ansatz of
haegeman2012 and vanderstraeten2019.

The excited state is a momentum superposition in which one ground-state
tensor is replaced by ``B = VL X`` (``VL`` the orthogonal complement of
``AL``).  The effective Hamiltonian of the ``X`` tensors splits into an
*aligned* part (the B in the same unit cell) and an *unaligned* part (the B
strictly left or right of it, summed as geometric series over the unit
cell's mixed transfer matrix with momentum phases), and Lanczos finds the
lowest excitation in each momentum and charge sector.

``device`` (a keyword of :class:`PlaneWaveExcitationEngine`; default
``'cuda'``, which raises where PyTorch sees no card) is where a solve runs
when the engine sends it there: a solve whose X holds ``N`` entries goes to
the card from ``mps_common.DEVICE_EXCITATION_THRESHOLD`` up (its comment
gives the measurement behind it), never on the CPU; the option
``device_threshold`` forces the route (0), disables it (None) or sets
another threshold, on any device.  There the engine packs, once, ``AL``,
``AR``, ``VL``, ``W``, the ground-state environments and the X-independent
``LP_VL`` terms in complex128 (the sums' phases make everything complex,
as in ``tenpy_tpu``), and a matvec is the same chain of tensordots as on
the host, each one :func:`~tenpy_tpu_torch.linalg.packed.tensordot` (one
launch of the hand-written kernel on a CUDA device), with packed additions
and scalar phases between them.  The Krylov vectors (lists of packed X)
stay on the card: Lanczos, Arnoldi, the sums' GMRES and the
``orthogonal_to`` boost run through the list and packed helpers of
:mod:`~tenpy_tpu_torch.linalg.krylov_based`.  The explicit sums read one
norm per term (``sum_tol`` decides where they stop).  The initial guess's
zero-site eigensolves take VUMPS's packed zero-site Lanczos by DMRG's rule
(:func:`~tenpy_tpu_torch.algorithms.mps_common.use_device_lanczos`).  A
failure on the card raises; nothing reruns on the host.

``excitation_stats`` lists per solve its momentum, ``N``, route, Krylov
steps, matvecs, sum iterations per matvec (right, left), host reads of
device scalars, tensordots and seconds.  With the attribute
``time_matvec`` set, each matvec waits for the card after each part and
adds its seconds to ``matvec_timing`` (B build, aligned, right sum, left
sum, unaligned; clear it to time one matvec); unset, as by default, a
matvec never waits for the card.

:class:`MultiSitePlaneWaveExcitationEngine` runs on the host only, as in
``tenpy_tpu``.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from . import mps_common
from .algorithm import Algorithm
from .dmrg import _to_host
from .mps_common import ZeroSiteH
from ..linalg import krylov_based
from ..linalg import np_conserved as npc
from ..linalg import packed as pk
from ..linalg.charges import LegPipe
from ..linalg.krylov_based import GMRES, Arnoldi, LanczosGroundState, \
    _v_inner
from ..linalg.sparse import BoostNpcLinearOperator, NpcLinearOperator, \
    SumNpcLinearOperator
from ..networks.momentum_mps import MomentumMPS
from ..networks.mpo import MPOEnvironment, MPOTransferMatrix
from ..networks.mps import MPS
from ..networks.uniform_mps import UniformMPS

logger = logging.getLogger(__name__)

__all__ = ['append_right_env', 'append_left_env', 'construct_orthogonal',
           'PlaneWaveExcitationEngine', 'MultiSitePlaneWaveExcitationEngine']

_VW = [['vR', 'wR'], ['vL', 'wL']]


class _HostOps:
    """The host route's tensor operations, on Arrays."""
    packed = False

    @staticmethod
    def td(a, b, axes):
        return npc.tensordot(a, b, axes=axes)

    @staticmethod
    def add(a, b):
        return a + b

    @staticmethod
    def sub(a, b):
        return a - b

    @staticmethod
    def scale(a, c):
        return c * a

    @staticmethod
    def norm(a):
        return float(npc.norm(a))

    @staticmethod
    def relabel(a, old, new):
        return a.ireplace_labels(old, new)

    @staticmethod
    def zeros_like(a):
        return a.zeros_like()

    @staticmethod
    def sync():
        pass


class _PackedOps:
    """The card route's tensor operations, on PackedArrays: each tensordot
    one call of the packed contraction (one kernel launch on a CUDA
    device, counted in ``n_contract`` where it has work), each addition on
    one label order, each norm one host read.  The tensors that do not
    depend on X are registered with :meth:`constant`: each is transposed
    once per leg order a tensordot needs, not at every call."""
    packed = True

    def __init__(self, device):
        self.device = device
        self.n_contract = 0
        self._const = {}
        self._oriented = {}

    def constant(self, x):
        self._const[id(x)] = x
        return x

    def _orient(self, x, contracted, first):
        """``x`` with ``contracted`` first (``first``) or last, as
        :func:`~tenpy_tpu_torch.linalg.packed.tensordot` takes it; cached
        for constants."""
        if id(x) not in self._const:
            return x
        key = (id(x), tuple(contracted), first)
        y = self._oriented.get(key)
        if y is None:
            kept = [l for l in x.get_leg_labels() if l not in contracted]
            y = x.transpose(list(contracted) + kept if first
                            else kept + list(contracted))
            self._oriented[key] = y
        return y

    def td(self, a, b, axes):
        a = self._orient(a, axes[0], False)
        b = self._orient(b, axes[1], True)
        out = pk.tensordot(a, b, axes=(axes[0], axes[1]))
        if a.data and b.data and out.n_blocks:
            self.n_contract += 1
        return out

    @staticmethod
    def add(a, b):
        return a + b.transpose(a.get_leg_labels())

    @staticmethod
    def sub(a, b):
        return a - b.transpose(a.get_leg_labels())

    @staticmethod
    def scale(a, c):
        return a * complex(c)

    @staticmethod
    def norm(a):
        return krylov_based._v_norm(a)

    @staticmethod
    def relabel(a, old, new):
        return a.replace_labels(old, new)

    @staticmethod
    def zeros_like(a):
        return a * 0.

    def sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)


def _right_env(ops, As, Bcs, R, Ws):
    """``append_right_env`` with the bra tensors ``Bcs`` conjugated
    already."""
    temp = R
    for i in reversed(range(len(As))):
        temp = ops.td(Bcs[i], temp, [['vR*'], ['vL*']])
        if Ws is not None:
            temp = ops.td(Ws[i], temp, [['wR', 'p'], ['wL', 'p*']])
        temp = ops.td(As[i], temp, [['vR', 'p'], ['vL', 'p*']])
    return temp


def _left_env(ops, As, Bcs, L, Ws):
    """``append_left_env`` with the bra tensors ``Bcs`` conjugated
    already."""
    temp = L
    for i in range(len(As)):
        temp = ops.td(temp, Bcs[i], [['vR*'], ['vL*']])
        if Ws is not None:
            temp = ops.td(temp, Ws[i], [['wR', 'p*'], ['wL', 'p']])
        temp = ops.td(temp, As[i], [['vR', 'p*'], ['vL', 'p']])
    return temp


def append_right_env(As, Bs, R, Ws=None):
    """Absorb sites into a right environment: ``As`` on top, ``Bs``
    (conjugated) below.  R has legs ``vL (wL) vL*``."""
    return _right_env(_HostOps, As, [B.conj() for B in Bs], R, Ws)


def append_left_env(As, Bs, L, Ws=None):
    """Absorb sites into a left environment: ``As`` on top, ``Bs``
    (conjugated) below.  L has legs ``vR* (wR) vR``."""
    return _left_env(_HostOps, As, [B.conj() for B in Bs], L, Ws)


def construct_orthogonal(M, left=True):
    """The orthogonal complement ``VL`` of an isometry M (labels ``vL p
    vR``): every column orthogonal to M's, so any ``VL X`` is orthogonal to
    the state."""
    if left:
        Mc = M.combine_legs([['vL', 'p']], qconj=[+1])
        Q = npc.orthogonal_columns(Mc, 'vR')
        err = npc.norm(npc.tensordot(Q.conj(), Mc, axes=[[0], [0]]))
    else:
        Mc = M.combine_legs([['p', 'vR']], qconj=[-1])
        Mt = Mc.transpose([1, 0])
        Q = npc.orthogonal_columns(Mt, 'vL').itranspose([1, 0])
        err = npc.norm(npc.tensordot(Q.conj(), Mt, axes=[[1], [0]]))
    assert err < 1e-10, f"orthogonal complement failed: {err}"
    return Q.split_legs()


def _n_entries(X):
    return sum(int(b.numel()) for b in X._data)


def _offset_lambda_C1(C0, LW, RW):
    """The energy of the infinite environments across bond 0,
    ``<C0|LW RW|C0> / <C0|C0>``."""
    norm = npc.tensordot(C0, C0.conj(), axes=[['vL', 'vR'], ['vL*', 'vR*']])
    lam = npc.tensordot(C0, RW, axes=[['vR'], ['vL']])
    lam = npc.tensordot(LW, lam, axes=[['wR', 'vR'], ['wL', 'vL']])
    lam = npc.tensordot(lam, C0.conj(), axes=[['vR*', 'vL*'],
                                              ['vL*', 'vR*']])
    return float(np.real(complex(lam) / complex(norm)))


class _Tensors:
    """One route's tensors: per site AL, AR, VL, W, the conjugated AL, AR
    and VL, the ground-state environments LP and RP, and ``LP_VL`` =
    ``append_left_env([AL], [VL], LP, W)``; Arrays on the host, complex128
    PackedArrays on ``device`` (packed once per engine)."""

    def __init__(self, eng, ops):
        self.ops = ops
        L = eng.L
        if ops.packed:
            dev = ops.device
            cx = torch.complex128

            def virt(a):
                return mps_common.pack_virtual(a, dev, cx)
            self.AL = [virt(a) for a in eng.ALs]
            self.AR = [virt(a) for a in eng.ARs]
            self.VL = [virt(a) for a in eng.VLs]
            self.W = [mps_common.pack_W(W, dev, cx) for W in eng.Ws]
            self.LP = [virt(eng.GS_env.get_LP(i)) for i in range(L)]
            self.RP = [virt(eng.GS_env.get_RP(i)) for i in range(L)]
        else:
            self.AL, self.AR, self.VL, self.W = eng.ALs, eng.ARs, eng.VLs, \
                eng.Ws
            self.LP = [eng.GS_env.get_LP(i) for i in range(L)]
            self.RP = [eng.GS_env.get_RP(i) for i in range(L)]
        self.ALc = [a.conj() for a in self.AL]
        self.ARc = [a.conj() for a in self.AR]
        self.VLc = [a.conj() for a in self.VL]
        self.LP_VL = [_left_env(ops, [self.AL[i]], [self.VLc[i]], self.LP[i],
                                [self.W[i]]) for i in range(L)]
        if ops.packed:
            for xs in (self.AL, self.AR, self.VL, self.W, self.LP, self.RP,
                       self.ALc, self.ARc, self.VLc, self.LP_VL):
                for x in xs:
                    ops.constant(x)

    def vector(self, Xs):
        """Host X tensors as this route's Krylov vector."""
        if not self.ops.packed:
            return list(Xs)
        return [mps_common.pack_virtual(X, self.ops.device, torch.complex128)
                for X in Xs]

    def to_host(self, Xs, like):
        """This route's Krylov vector as host X tensors with the legs of
        ``like``."""
        if not self.ops.packed:
            return Xs
        return [pk.unpack(_to_host(x), orig_legs=[
            X0.get_leg(lbl) for lbl in x.get_leg_labels()])
            for x, X0 in zip(Xs, like)]

    def Bs(self, vec):
        """``B_i = VL_i X_i`` of the Krylov vector ``vec``."""
        return [self.ops.td(VL, X, [['vR'], ['vL']])
                for VL, X in zip(self.VL, vec)]


class PlaneWaveExcitationEngine(Algorithm):
    r"""Quasiparticle excitations of a uniform MPS at fixed momentum.

    ``run(p, qtotal_change)`` returns the lowest excitation energies
    (relative to the ground state), the :class:`~tenpy_tpu_torch.networks.
    momentum_mps.MomentumMPS` states and the Krylov steps.

    Options: ``lanczos_params``, ``init_env_data``, ``lambda_C1``,
    ``sum_method`` ('explicit' | 'GMRES', with ``GMRES_params``),
    ``sum_tol`` (1e-10), ``sum_iterations`` (100), ``E_boost`` (100),
    ``device_threshold`` (see the module docstring).  ``device``: where
    the solves run from the threshold up (default ``'cuda'``).
    """

    def __init__(self, psi, model, options, *, device='cuda', **kwargs):
        self.device = pk.checked_device(device)
        if not isinstance(psi, UniformMPS) and isinstance(psi, MPS):
            psi = UniformMPS.from_MPS(psi)
        super().__init__(psi, model, options, **kwargs)
        assert self.psi.L == self.model.H_MPO.L
        self.L = self.psi.L
        self.ALs = [self.psi.get_AL(i) for i in range(self.L)]
        self.ARs = [self.psi.get_AR(i) for i in range(self.L)]
        self.ACs = [self.psi.get_AC(i) for i in range(self.L)]
        self.Cs = [self.psi.get_C(i) for i in range(self.L)]
        self.H = self.model.H_MPO
        self.Ws = [self.H.get_W(i) for i in range(self.L)]
        self.IdL = self.H.get_IdL(0)
        self.IdR = self.H.get_IdR(-1)
        self.guess_init_env_data = self.options.get('init_env_data', None)
        # B = VL X parametrization (tangent space, Eq. 85 of
        # vanderstraeten2019)
        self.VLs = [construct_orthogonal(self.ALs[i]) for i in range(self.L)]
        self.boundary_env_data, self.energy_density, _ = \
            MPOTransferMatrix.find_init_LP_RP(
                self.H, self.psi, calc_E=True,
                guess_init_env_data=self.guess_init_env_data)
        self.energy_density = float(np.real(np.mean(self.energy_density)))
        self.LW = self.boundary_env_data['init_LP']
        self.RW = self.boundary_env_data['init_RP']
        self.GS_env = self.GS_env_L = self.GS_env_R = MPOEnvironment(
            self.psi, self.H, self.psi, init_LP=self.LW, init_RP=self.RW)
        self.lambda_C1 = self.options.get('lambda_C1', None, 'real')
        if self.lambda_C1 is None:
            self.lambda_C1 = _offset_lambda_C1(self.Cs[0], self.LW, self.RW)
        self._routes = {'host': _Tensors(self, _HostOps)}
        self.aligned_H = self.Aligned_Effective_H(self)
        self.excitation_stats = []
        self.time_matvec = False
        self.matvec_timing = {}
        self._solve = None
        strange = []
        for i in range(self.L):
            t = append_left_env([self.VLs[i]], [self.ACs[i]],
                                self.GS_env.get_LP(i), Ws=[self.Ws[i]])
            t = npc.tensordot(t, self.GS_env.get_RP(i),
                              axes=[['wR', 'vR*'], ['wL', 'vL*']])
            strange.append(float(npc.norm(t)))
        logger.info("tangent-space projection of H|psi> per site: %r",
                    strange)

    # ------------------------------------------------------------- routes
    def route_for(self, N):
        """``'device'`` or ``'host'`` for a solve whose X holds ``N``
        entries."""
        threshold = self.options.get('device_threshold', 'auto')
        if threshold is None:
            return 'host'
        if threshold == 'auto':
            threshold = mps_common.DEVICE_EXCITATION_THRESHOLD
            if self.device.type == 'cpu' or threshold is None:
                return 'host'
        return 'device' if N >= threshold else 'host'

    def tensors(self, route):
        """The route's :class:`_Tensors` (the card's packed at the first
        call)."""
        if route not in self._routes:
            self._routes[route] = _Tensors(self, _PackedOps(self.device))
        return self._routes[route]

    def _effective_H(self, p, T):
        """The effective H at momentum ``p`` on the route of ``T``."""
        self.aligned_H = self.Aligned_Effective_H(self, T)
        self.unaligned_H = self.Unaligned_Effective_H(self, p, T)
        return SumNpcLinearOperator(self.aligned_H, self.unaligned_H)

    # ---------------------------------------------------------------- run
    def run(self, p, qtotal_change=None, orthogonal_to=(), E_boosts=(),
            num_ev=1):
        """The lowest excitation(s) at momentum ``p``: ``(Es, psis, N)``.

        ``orthogonal_to``: X lists (host Arrays) of excitations to raise by
        ``E_boosts`` (default the option ``E_boost``, 100 each)."""
        t0 = time.time()
        X_init = self.initial_guess(qtotal_change)
        N_entries = sum(_n_entries(X) for X in X_init)
        route = self.route_for(N_entries)
        stats = {'p': float(p), 'N': N_entries, 'route': route,
                 'matvecs': 0, 'sum_iterations': [],
                 'guess_tensordots': self._guess_tensordots}
        reads0 = krylov_based.PACKED_READS
        n0 = self._n_contract()
        self._solve = stats
        T = self.tensors(route)
        effective_H = self._effective_H(p, T)
        lanczos_params = self.options.subconfig('lanczos_params')
        orthogonal_to = list(orthogonal_to)
        E_boosts = list(E_boosts)
        if len(E_boosts) != len(orthogonal_to):
            E_boost = self.options.get('E_boost', 100, 'real')
            E_boosts = [E_boost] * len(orthogonal_to)
        if len(orthogonal_to) > 0:
            effective_H = BoostNpcLinearOperator(
                effective_H, E_boosts, [T.vector(o) for o in orthogonal_to])
        X0 = T.vector(X_init)
        offset = self.lambda_C1 + self.energy_density * self.L
        if num_ev > 1:
            opts = dict(lanczos_params.as_dict())
            opts['which'] = 'SR'
            opts['num_ev'] = num_ev
            energies, Xs, N = Arnoldi(effective_H, X0, opts).run()
            Es = [float(np.real(E)) - offset for E in energies]
            psis = [MomentumMPS(T.to_host(X, X_init), self.psi, p)
                    for X in Xs]
        else:
            energy, X, N = LanczosGroundState(effective_H, X0,
                                              lanczos_params).run()
            Es = [energy - offset]
            psis = [MomentumMPS(T.to_host(X, X_init), self.psi, p)]
        if N == lanczos_params.get('N_max', 20, int):
            logger.warning("maximum Lanczos iterations reached; "
                           "excitation energies may not be converged")
        stats.update(steps=N, host_reads=krylov_based.PACKED_READS - reads0,
                     tensordots=self._n_contract() - n0,
                     seconds=time.time() - t0)
        self.excitation_stats.append(stats)
        self._solve = None
        return np.real_if_close(Es), psis, N

    def energy(self, p, X):
        """The energy of given excitation tensors (host Arrays) at momentum
        ``p``, on the route a solve of their size takes."""
        T = self.tensors(self.route_for(sum(_n_entries(x) for x in X)))
        effective_H = self._effective_H(p, T)
        Xv = T.vector(X)
        HX = effective_H.matvec(Xv)
        E = float(np.real(_v_inner(Xv, HX)))
        return E - self.energy_density * self.L - self.lambda_C1

    def _n_contract(self):
        T = self._routes.get('device')
        return 0 if T is None else T.ops.n_contract

    def _clock(self, ops, key=None, since=None):
        """With ``time_matvec`` on: the time once the card has finished,
        the seconds since ``since`` added to ``matvec_timing[key]``; off:
        None, without waiting."""
        if not self.time_matvec:
            return None
        ops.sync()
        now = time.perf_counter()
        if key is not None:
            self.matvec_timing[key] = self.matvec_timing.get(key, 0.) + \
                now - since
        return now

    def _record_sum(self, side, n):
        if self._solve is not None:
            its = self._solve['sum_iterations']
            if side == 'right':
                its.append([n, 0])
            elif its:
                its[-1][1] = n

    # -------------------------------------------------------- infinite sums
    def _sum_options(self):
        return (self.options.get('sum_tol', 1e-10, 'real'),
                self.options.get('sum_iterations', 100, int),
                self.options.get('sum_method', 'explicit', str))

    def infinite_sum_right(self, p, X):
        """The geometric series of B environments to the right (Eq. 194 of
        vanderstraeten2019), on the host."""
        T = self._routes['host']
        return self._sum_right(p, T.Bs(X), T)

    def infinite_sum_left(self, p, X):
        """The geometric series of B environments to the left, on the
        host."""
        T = self._routes['host']
        return self._sum_left(p, T.Bs(X), T)

    def _sum_right(self, p, Bs, T):
        ops = T.ops
        sum_tol, sum_iterations, sum_method = self._sum_options()
        L = self.L
        RB = _right_env(ops, [Bs[L - 1]], [T.ARc[L - 1]], T.RP[L - 1],
                        [T.W[L - 1]])
        for i in reversed(range(L - 1)):
            RB = ops.add(_right_env(ops, [Bs[i]], [T.ARc[i]], T.RP[i],
                                    [T.W[i]]),
                         _right_env(ops, [T.AL[i]], [T.ARc[i]], RB,
                                    [T.W[i]]))
        R = RB
        if np.isclose(ops.norm(R), 0):
            self._record_sum('right', 0)
            return R
        phase = np.exp(-1j * p * L)
        if sum_method == 'explicit':
            R_sum = R
            n = 0
            for _ in range(sum_iterations):
                n += 1
                R = ops.scale(_right_env(ops, T.AL, T.ARc, R, T.W), phase)
                R_sum = ops.add(R_sum, R)
                if ops.norm(R) < sum_tol:
                    break
            self._record_sum('right', n)
            return R_sum
        elif 'GMRES' in sum_method:
            op = _SumTransfer(ops, lambda v: _right_env(ops, T.AL, T.ARc, v,
                                                        T.W), phase)
            R_sum, _ = GMRES(op, ops.scale(ops.zeros_like(R), 1j), R,
                             self.options.subconfig('GMRES_params')).run()
            self._record_sum('right', op.n)
            return R_sum
        raise ValueError(f"unknown sum_method {sum_method!r}")

    def _sum_left(self, p, Bs, T):
        ops = T.ops
        sum_tol, sum_iterations, sum_method = self._sum_options()
        L = self.L
        LB = _left_env(ops, [Bs[0]], [T.ALc[0]], T.LP[0], [T.W[0]])
        for i in range(1, L):
            LB = ops.add(_left_env(ops, [Bs[i]], [T.ALc[i]], T.LP[i],
                                   [T.W[i]]),
                         _left_env(ops, [T.AR[i]], [T.ALc[i]], LB, [T.W[i]]))
        Lenv = LB
        if np.isclose(ops.norm(Lenv), 0):
            self._record_sum('left', 0)
            return Lenv
        phase = np.exp(1j * p * L)
        if sum_method == 'explicit':
            L_sum = Lenv
            n = 0
            for _ in range(sum_iterations):
                n += 1
                Lenv = ops.scale(_left_env(ops, T.AR, T.ALc, Lenv, T.W),
                                 phase)
                L_sum = ops.add(L_sum, Lenv)
                if ops.norm(Lenv) < sum_tol:
                    break
            self._record_sum('left', n)
            return L_sum
        elif 'GMRES' in sum_method:
            op = _SumTransfer(ops, lambda v: _left_env(ops, T.AR, T.ALc, v,
                                                       T.W), phase)
            L_sum, _ = GMRES(op, ops.scale(ops.zeros_like(Lenv), 1j), Lenv,
                             self.options.subconfig('GMRES_params')).run()
            self._record_sum('left', op.n)
            return L_sum
        raise ValueError(f"unknown sum_method {sum_method!r}")

    # ---------------------------------------------------------- effective H
    class Aligned_Effective_H(NpcLinearOperator):
        """The B tensors inside the unit cell of the updated X."""

        def __init__(self, outer, T=None):
            self.outer = outer
            self.T = T or outer._routes['host']

        def matvec(self, vec):
            o, T = self.outer, self.T
            ops = T.ops
            t = o._clock(ops)
            Bs = T.Bs(vec)
            t = o._clock(ops, 'B', t)
            L = o.L
            total = [ops.zeros_like(v) for v in vec]
            for i in range(L):
                LB = None
                for j in range(i):
                    if j > 0 and LB is not None:
                        LB = ops.add(
                            _left_env(ops, [Bs[j]], [T.ALc[j]], T.LP[j],
                                      [T.W[j]]),
                            _left_env(ops, [T.AR[j]], [T.ALc[j]], LB,
                                      [T.W[j]]))
                    else:
                        LB = _left_env(ops, [Bs[j]], [T.ALc[j]], T.LP[j],
                                       [T.W[j]])
                LP2 = _left_env(ops, [Bs[i]], [T.VLc[i]], T.LP[i], [T.W[i]])
                RB = None
                for j in reversed(range(i + 1, L)):
                    if j < L - 1 and RB is not None:
                        RB = ops.add(
                            _right_env(ops, [Bs[j]], [T.ARc[j]], T.RP[j],
                                       [T.W[j]]),
                            _right_env(ops, [T.AL[j]], [T.ARc[j]], RB,
                                       [T.W[j]]))
                    else:
                        RB = _right_env(ops, [Bs[j]], [T.ARc[j]], T.RP[j],
                                        [T.W[j]])
                out = ops.td(LP2, T.RP[i], _VW)
                if i > 0 and LB is not None:
                    LB_i = _left_env(ops, [T.AR[i]], [T.VLc[i]], LB,
                                     [T.W[i]])
                    out = ops.add(out, ops.td(LB_i, T.RP[i], _VW))
                if i < L - 1 and RB is not None:
                    out = ops.add(out, ops.td(T.LP_VL[i], RB, _VW))
                out = ops.relabel(out, ['vR*', 'vL*'], ['vL', 'vR'])
                total[i] = ops.add(total[i], out)
            o._clock(ops, 'aligned', t)
            return total

    class Unaligned_Effective_H(NpcLinearOperator):
        """The B tensors strictly left or right of the updated unit cell,
        summed with momentum phases."""

        def __init__(self, outer, p, T=None):
            self.outer = outer
            self.p = p
            self.T = T or outer._routes['host']

        def matvec(self, vec):
            o, T, p = self.outer, self.T, self.p
            ops = T.ops
            t = o._clock(ops)
            Bs = T.Bs(vec)
            t = o._clock(ops, 'B', t)
            L = o.L
            if o._solve is not None:
                o._solve['matvecs'] += 1
            total = [ops.zeros_like(v) for v in vec]
            inf_sum_TR = o._sum_right(p, Bs, T)
            t = o._clock(ops, 'right_sum', t)
            cached_TR = [inf_sum_TR]
            for i in reversed(range(1, L)):
                cached_TR.insert(0, _right_env(ops, [T.AL[i]], [T.ARc[i]],
                                               cached_TR[0], [T.W[i]]))
            for i in range(L):
                out = ops.scale(ops.td(T.LP_VL[i], cached_TR[i], _VW),
                                np.exp(-1j * p * L))
                out = ops.relabel(out, ['vR*', 'vL*'], ['vL', 'vR'])
                total[i] = ops.add(total[i], out)
            t = o._clock(ops, 'unaligned', t)
            inf_sum_TL = o._sum_left(p, Bs, T)
            t = o._clock(ops, 'left_sum', t)
            cached_TL = [inf_sum_TL]
            for i in range(L - 1):
                cached_TL.append(_left_env(ops, [T.AR[i]], [T.ALc[i]],
                                           cached_TL[-1], [T.W[i]]))
            for i in range(L):
                TL_VL = _left_env(ops, [T.AR[i]], [T.VLc[i]], cached_TL[i],
                                  [T.W[i]])
                out = ops.scale(ops.td(TL_VL, T.RP[i], _VW),
                                np.exp(1j * p * L))
                out = ops.relabel(out, ['vR*', 'vL*'], ['vL', 'vR'])
                total[i] = ops.add(total[i], out)
            o._clock(ops, 'unaligned', t)
            return total

    # -------------------------------------------------------- initial guess
    def initial_guess(self, qtotal_change):
        """X guesses in the requested charge sector: per site the ground
        state of the zero-site H between ``LP VL`` and ``RP``, from ones.
        Its eigensolve takes the card's packed Lanczos by DMRG's rule
        (``lanczos_params['device_K']``, else from
        ``DEVICE_LANCZOS_THRESHOLD`` up off the CPU); the tensordots it
        launches there are counted in ``_guess_tensordots``."""
        X_init = []
        valid_charge = False
        lanczos_params = self.options.subconfig('lanczos_params')
        self._guess_tensordots = 0
        for i in range(self.L):
            vL = self.VLs[i].get_leg('vR').conj()
            vR = self.ALs[(i + 1) % self.L].get_leg('vL').conj()
            th0 = npc.Array.from_func(np.ones, [vL, vR],
                                      dtype=self.psi.dtype,
                                      qtotal=qtotal_change,
                                      labels=['vL', 'vR'])
            if np.isclose(float(npc.norm(th0)), 0):
                logger.warning("initial X guess zero on site %d "
                               "(charge not allowed there)", i)
            else:
                valid_charge = True
                LP = self.GS_env_L.get_LP(i, store=True)
                RP = self.GS_env_R.get_RP(i, store=True)
                LP = append_left_env([self.VLs[i]], [self.VLs[i]], LP,
                                     Ws=[self.Ws[i]])
                H0 = ZeroSiteH.from_LP_RP(LP, RP)
                if self.model.H_MPO.explicit_plus_hc:
                    H0 = SumNpcLinearOperator(H0, H0.adjoint())
                th0 = self._guess_eigensolve(H0, th0, lanczos_params)
            X_init.append(th0)
        assert valid_charge, "no valid X: requested charge cannot be realized"
        return X_init

    def _guess_eigensolve(self, H0, th0, lanczos_params):
        if not mps_common.use_device_lanczos(lanczos_params, self.device,
                                             H0.N):
            return LanczosGroundState(H0, th0, lanczos_params).run()[1]
        K = lanczos_params.get('device_K', None) or \
            lanczos_params.get('N_max', 20, int)
        operands = H0.pack_operands(self.device)
        _, th, N, _ = mps_common.lanczos_ground_packed(
            H0.packed_matvec, operands,
            mps_common.pack_virtual(th0, self.device), int(K),
            float(lanczos_params.get('P_tol', 1e-14, 'real')), 2,
            bool(lanczos_params.get('reortho', False)))
        self._guess_tensordots += 2 * N
        return pk.unpack(_to_host(th), orig_legs=[
            th0.get_leg(lbl) for lbl in th.get_leg_labels()])


class _SumTransfer(NpcLinearOperator):
    """``v - phase T(v)``, ``T`` one unit cell of the mixed transfer
    matrix: the operator of a geometric sum's GMRES; ``n`` counts its
    matvecs."""

    def __init__(self, ops, transfer, phase):
        self.ops, self.transfer, self.phase = ops, transfer, phase
        self.n = 0

    def matvec(self, vec):
        self.n += 1
        return self.ops.sub(vec, self.ops.scale(self.transfer(vec),
                                                self.phase))


class MultiSitePlaneWaveExcitationEngine(Algorithm):
    r"""Plane-wave excitations spanning several sites, on the host.

    Generalizes :class:`PlaneWaveExcitationEngine`: for each unit-cell site
    ``i`` the excited window is ``B_i = VL_i X_i``, where ``X_i`` carries
    ``excitation_size - 1`` extra physical legs ``p1..p{size-1}`` (the
    window covers sites ``i .. i+size-1``, completed with AR tensors to the
    right).  Options: ``excitation_size`` and those of the single-site
    engine (but ``device_threshold``).
    """

    def __init__(self, psi, model, options, **kwargs):
        if not isinstance(psi, UniformMPS) and isinstance(psi, MPS):
            psi = UniformMPS.from_MPS(psi)
        super().__init__(psi, model, options, **kwargs)
        assert self.psi.L == self.model.H_MPO.L
        self.L = L = self.psi.L
        self.size = self.options.get('excitation_size', 1, int)
        assert self.size >= 1
        self.ALs = [self.psi.get_AL(i) for i in range(L)]
        self.ARs = [self.psi.get_AR(i) for i in range(L)]
        # the bras of the sums' transfer matrices, conjugated once
        self._ALcs = [a.conj() for a in self.ALs]
        self._ARcs = [a.conj() for a in self.ARs]
        self.ACs = [self.psi.get_AC(i) for i in range(L)]
        self.Cs = [self.psi.get_C(i) for i in range(L)]
        self.H = self.model.H_MPO
        self.Ws = [self.H.get_W(i) for i in range(L)]
        self.guess_init_env_data = self.options.get('init_env_data', None)
        self.VLs = [construct_orthogonal(self.ALs[i]) for i in range(L)]
        self.boundary_env_data, self.energy_density, _ = \
            MPOTransferMatrix.find_init_LP_RP(
                self.H, self.psi, calc_E=True,
                guess_init_env_data=self.guess_init_env_data)
        self.energy_density = float(np.real(np.mean(self.energy_density)))
        self.LW = self.boundary_env_data['init_LP']
        self.RW = self.boundary_env_data['init_RP']
        self.GS_env = self.GS_env_L = self.GS_env_R = MPOEnvironment(
            self.psi, self.H, self.psi, init_LP=self.LW, init_RP=self.RW)
        self.lambda_C1 = self.options.get('lambda_C1', None, 'real')
        if self.lambda_C1 is None:
            self.lambda_C1 = _offset_lambda_C1(self.Cs[0], self.LW, self.RW)

    @property
    def _n_cells(self):
        """How many unit cells a window can extend over."""
        return int(np.ceil((self.L - 1 + self.size) / self.L))

    def run(self, p, qtotal_change=None, orthogonal_to=(), E_boosts=(),
            num_ev=1):
        """The lowest multi-site excitation(s) at momentum ``p``."""
        aligned = self.Aligned_Effective_H(self, p)
        unaligned = self.Unaligned_Effective_H(self, p)
        effective_H = SumNpcLinearOperator(aligned, unaligned)
        lanczos_params = self.options.subconfig('lanczos_params')
        X_init = self.initial_guess(qtotal_change)
        orthogonal_to = list(orthogonal_to)
        E_boosts = list(E_boosts)
        if len(E_boosts) != len(orthogonal_to):
            E_boost = self.options.get('E_boost', 100, 'real')
            E_boosts = [E_boost] * len(orthogonal_to)
        if len(orthogonal_to) > 0:
            effective_H = BoostNpcLinearOperator(effective_H, E_boosts,
                                                 orthogonal_to)
        offset = self.lambda_C1 + self.energy_density * self.L * self._n_cells
        if num_ev > 1:
            opts = dict(lanczos_params.as_dict())
            opts['which'] = 'SR'
            opts['num_ev'] = num_ev
            energies, Xs, N = Arnoldi(effective_H, X_init, opts).run()
            Es = [float(np.real(E)) - offset for E in energies]
            psis = [MomentumMPS(X, self.psi, p, self.size) for X in Xs]
        else:
            energy, X, N = LanczosGroundState(effective_H, X_init,
                                              lanczos_params).run()
            Es = [energy - offset]
            psis = [MomentumMPS(X, self.psi, p, self.size)]
        if N == lanczos_params.get('N_max', 20, int):
            logger.warning("maximum Lanczos iterations reached; "
                           "excitation energies may not be converged")
        return np.real_if_close(Es), psis, N

    def energy(self, p, X):
        effective_H = SumNpcLinearOperator(self.Aligned_Effective_H(self, p),
                                           self.Unaligned_Effective_H(self, p))
        E = float(np.real(_v_inner(X, effective_H.matvec(X))))
        return E - self.lambda_C1 - self.energy_density * self.L * \
            self._n_cells

    # ---------------------------------------------------- window attachment
    def attach_right(self, VL, X, As, R, Ws=None):
        """The right environment with the excited window ``VL X`` on the
        ket side and ``As`` (conjugated) on the bra side."""
        B = npc.tensordot(VL.replace_label('p', 'p0'), X,
                          axes=[['vR'], ['vL']])
        RB = npc.tensordot(B, R, axes=[['vR'], ['vL']])
        for i in reversed(range(len(As))):
            lbl = 'p' + str(i)
            if Ws is not None:
                RB = npc.tensordot(RB, Ws[i], axes=[[lbl, 'wL'], ['p*', 'wR']])
            RB = npc.tensordot(RB, As[i].conj(),
                               axes=[['p', 'vL*'], ['p*', 'vR*']])
        return RB

    def attach_left(self, VL, X, As, L, Ws=None):
        """The left environment with the excited window ``VL X`` on the ket
        side and ``As`` (conjugated) on the bra side."""
        B = npc.tensordot(VL.replace_label('p', 'p0'), X,
                          axes=[['vR'], ['vL']])
        LB = npc.tensordot(L, B, axes=[['vR'], ['vL']])
        for i in range(len(As)):
            lbl = 'p' + str(i)
            if Ws is not None:
                LB = npc.tensordot(Ws[i], LB, axes=[['p*', 'wL'], [lbl, 'wR']])
            LB = npc.tensordot(As[i].conj(), LB,
                               axes=[['p*', 'vL*'], ['p', 'vR*']])
        return LB

    # -------------------------------------------------------- infinite sums
    def _starting_right_TR(self, X):
        L, size = self.L, self.size
        RW = None
        for i in range(L):
            RP = self.GS_env_R.get_RP(i + size - 1)
            RB = self.attach_right(
                self.VLs[i], X[i],
                [self.ARs[j % L] for j in range(i, i + size)], RP,
                Ws=[self.Ws[j % L] for j in range(i, i + size)])
            RB = append_right_env(self.ALs[:i], self.ARs[:i], RB,
                                  Ws=self.Ws[:i])
            RW = RB if RW is None else RW + RB
        return RW

    def _starting_left_TL(self, X):
        L, size = self.L, self.size
        n_cells = self._n_cells
        LW = None
        for i in range(L):
            LP = self.GS_env_L.get_LP(i)
            LB = self.attach_left(
                self.VLs[i], X[i],
                [self.ALs[j % L] for j in range(i, i + size)], LP,
                Ws=[self.Ws[j % L] for j in range(i, i + size)])
            for j in range(i + size, n_cells * L):
                LB = append_left_env([self.ARs[j % L]], [self.ALs[j % L]], LB,
                                     Ws=[self.Ws[j % L]])
            LW = LB if LW is None else LW + LB
        return LW

    def _geometric_sum(self, start, transfer, phase):
        """``sum_n (phase T)^n start`` by the option ``sum_method``."""
        sum_tol = self.options.get('sum_tol', 1e-10, 'real')
        sum_iterations = self.options.get('sum_iterations', 100, int)
        sum_method = self.options.get('sum_method', 'explicit', str)
        if np.isclose(float(npc.norm(start)), 0):
            return start
        if sum_method == 'explicit':
            term, total = start, start
            for _ in range(sum_iterations):
                term = phase * transfer(term)
                total = total + term
                if float(npc.norm(term)) < sum_tol:
                    break
            return total
        elif 'GMRES' in sum_method:
            x, _ = GMRES(_SumTransfer(_HostOps, transfer, phase),
                         start.zeros_like() * 1j, start,
                         self.options.subconfig('GMRES_params')).run()
            return x
        raise ValueError(f"unknown sum_method {sum_method!r}")

    def infinite_sum_right(self, p, X):
        return self._geometric_sum(
            self._starting_right_TR(X),
            lambda v: _right_env(_HostOps, self.ALs, self._ARcs, v, self.Ws),
            np.exp(-1j * p * self.L))

    def infinite_sum_left(self, p, X):
        L, size = self.L, self.size
        # shift the starting window left far enough that every excitation
        # fits strictly left of the output unit cell
        if size == 1:
            self.shift_unit_cell = 0
        elif L == 1:
            self.shift_unit_cell = size - 1
        elif size > L:
            self.shift_unit_cell = size // L
        else:
            self.shift_unit_cell = 1
        LB = np.exp(1j * p * L * self.shift_unit_cell) * \
            self._starting_left_TL(X)
        return self._geometric_sum(
            LB, lambda v: _left_env(_HostOps, self.ARs, self._ALcs, v,
                                    self.Ws),
            np.exp(1j * p * L))

    # ---------------------------------------------------------- effective H
    class Aligned_Effective_H(NpcLinearOperator):
        """Windows overlapping the output window (within +-size sites)."""

        def __init__(self, outer, p):
            self.outer = outer
            self.p = p

        def matvec(self, vec):
            o = self.outer
            L, size = o.L, o.size
            n_cells = o._n_cells
            total = [v.zeros_like() for v in vec]
            for i in range(L):
                # windows starting at i+j (j >= 0): B shifted right by j
                for j in range(size):
                    LW = o.GS_env_L.get_LP(i)
                    RW = o.GS_env_R.get_RP((i + j + size - 1) % L)
                    for _ in range(int(np.ceil((i + j + size) / L)), n_cells):
                        sites = range(i + j + size, i + j + size + L)
                        RW = append_right_env([o.ARs[n % L] for n in sites],
                                              [o.ARs[n % L] for n in sites],
                                              RW,
                                              [o.Ws[n % L] for n in sites])
                    B = npc.tensordot(
                        o.VLs[(i + j) % L].replace_label('p', 'p0'),
                        vec[(i + j) % L], axes=[['vR'], ['vL']])
                    RW = npc.tensordot(B, RW, axes=[['vR'], ['vL']])
                    for n in reversed(range(j, size + j)):
                        lbl = 'p' + str(n - j)
                        RW = npc.tensordot(RW, o.Ws[(n + i) % L],
                                           axes=[[lbl, 'wL'], ['p*', 'wR']])
                        if n >= size:
                            RW = npc.tensordot(RW, o.ARs[(n + i) % L].conj(),
                                               axes=[['p', 'vL*'],
                                                     ['p*', 'vR*']])
                        else:
                            RW.ireplace_label('p', 'p' + str(n))
                    for k in range(j):
                        LW = npc.tensordot(LW, o.ALs[(i + k) % L],
                                           axes=[['vR'], ['vL']])
                        LW = npc.tensordot(LW, o.Ws[(i + k) % L],
                                           axes=[['wR', 'p'], ['wL', 'p*']])
                        LW.ireplace_label('p', 'p' + str(k))
                    if j == 0:
                        LW = npc.tensordot(LW, o.VLs[i].conj(),
                                           axes=[['vR*'], ['vL*']])
                        out = npc.tensordot(LW, RW, axes=[['vR', 'wR', 'p*'],
                                                          ['vL', 'wL', 'p0']])
                    else:
                        LW = npc.tensordot(LW, o.VLs[i].conj(),
                                           axes=[['vR*', 'p0'], ['vL*', 'p*']])
                        out = npc.tensordot(LW, RW, axes=_VW)
                    out.ireplace_labels(['vR*', 'vL*'], ['vL', 'vR'])
                    out.itranspose(total[i].get_leg_labels())
                    total[i] = total[i] + out * np.exp(
                        -1j * self.p * L * ((i + j) // L))
                # windows starting at j < i (overlapping from the left)
                for j in range(i - size + 1, i):
                    LW = o.GS_env_L.get_LP(j % L)
                    RW = o.GS_env_R.get_RP((size - 1 + i) % L)
                    B = npc.tensordot(o.VLs[j % L].replace_label('p', 'p0'),
                                      vec[j % L], axes=[['vR'], ['vL']])
                    LW = npc.tensordot(LW, B, axes=[['vR'], ['vL']])
                    for n in range(j, j + size):
                        lbl = 'p' + str(n - j)
                        LW = npc.tensordot(LW, o.Ws[n % L],
                                           axes=[[lbl, 'wR'], ['p*', 'wL']])
                        if n < i:
                            LW = npc.tensordot(LW, o.ALs[n % L].conj(),
                                               axes=[['p', 'vR*'],
                                                     ['p*', 'vL*']])
                        else:
                            LW.ireplace_label('p', 'p' + str(n - i))
                    for k in reversed(range(j + size, size + i)):
                        RW = npc.tensordot(o.ARs[k % L], RW,
                                           axes=[['vR'], ['vL']])
                        RW = npc.tensordot(o.Ws[k % L], RW,
                                           axes=[['wR', 'p*'], ['wL', 'p']])
                        RW.ireplace_label('p', 'p' + str(k - i))
                    LW = npc.tensordot(LW, o.VLs[i].conj(),
                                       axes=[['vR*', 'p0'], ['vL*', 'p*']])
                    out = npc.tensordot(LW, RW, axes=_VW)
                    out.ireplace_labels(['vR*', 'vL*'], ['vL', 'vR'])
                    out.itranspose(total[i].get_leg_labels())
                    total[i] = total[i] + out * np.exp(
                        -1j * self.p * L * (j // L))
            return total

    class Unaligned_Effective_H(NpcLinearOperator):
        """Windows strictly left or right of the output window (the
        geometric sums)."""

        def __init__(self, outer, p):
            self.outer = outer
            self.p = p

        def matvec(self, vec):
            o = self.outer
            L, size = o.L, o.size
            total = [v.zeros_like() for v in vec]

            inf_sum_TR = o.infinite_sum_right(self.p, vec)
            for i in range(L):
                n_cells_i = int(np.ceil((i + size) / L))
                LP_VL = append_left_env([o.ALs[i]], [o.VLs[i]],
                                        o.GS_env_L.get_LP(i), Ws=[o.Ws[i]])
                for j in range(1, size):
                    LP_VL = npc.tensordot(LP_VL, o.ALs[(i + j) % L],
                                          axes=[['vR'], ['vL']])
                    LP_VL = npc.tensordot(LP_VL, o.Ws[(i + j) % L],
                                          axes=[['wR', 'p'], ['wL', 'p*']])
                    LP_VL.ireplace_label('p', 'p' + str(j))
                RB = inf_sum_TR * np.exp(-1j * self.p * L * n_cells_i)
                for j in reversed(range(i + size, n_cells_i * L)):
                    RP = o.GS_env_R.get_RP((j + size - 1) % L)
                    RB = append_right_env([o.ALs[j % L]], [o.ARs[j % L]], RB,
                                          Ws=[o.Ws[j % L]])
                    RB = RB + o.attach_right(
                        o.VLs[j % L], vec[j % L],
                        [o.ARs[k % L] for k in range(j, j + size)], RP,
                        Ws=[o.Ws[k % L] for k in range(j, j + size)]) * \
                        np.exp(-1j * self.p * L * (n_cells_i - 1))
                out = npc.tensordot(LP_VL, RB, axes=_VW)
                out.ireplace_labels(['vR*', 'vL*'], ['vL', 'vR'])
                out.itranspose(total[i].get_leg_labels())
                total[i] = total[i] + out

            inf_sum_TL = o.infinite_sum_left(self.p, vec)
            for i in range(L):
                RP = o.GS_env_R.get_RP((i + size - 1) % L)
                for j in reversed(range(size)):
                    RP = npc.tensordot(o.ARs[(i + j) % L], RP,
                                       axes=[['vR'], ['vL']])
                    RP = npc.tensordot(o.Ws[(i + j) % L], RP,
                                       axes=[['wR', 'p*'], ['wL', 'p']])
                    RP.ireplace_label('p', 'p' + str(j))
                LB = inf_sum_TL * np.exp(1j * self.p * L)
                # windows fitting entirely left of site 0 but not in the sum
                for j in range(-L * o.shift_unit_cell, 0):
                    if j + size <= 0:
                        LP = o.GS_env_L.get_LP(j % L)
                        LP_B = o.attach_left(
                            o.VLs[j % L], vec[j % L],
                            [o.ALs[k % L] for k in range(j, j + size)], LP,
                            Ws=[o.Ws[k % L] for k in range(j, j + size)]) * \
                            np.exp(1j * self.p * L)
                        for k in range(j + size, 0):
                            LP_B = append_left_env([o.ARs[k % L]],
                                                   [o.ALs[k % L]], LP_B,
                                                   Ws=[o.Ws[k % L]])
                        LB = LB + LP_B
                for j in range(i):
                    LP = o.GS_env_L.get_LP((j - size + 1) % L)
                    LB = append_left_env([o.ARs[j % L]], [o.ALs[j % L]], LB,
                                         Ws=[o.Ws[j % L]])
                    LB = LB + o.attach_left(
                        o.VLs[(j - size + 1) % L], vec[(j - size + 1) % L],
                        [o.ALs[k % L] for k in range(j - size + 1, j + 1)],
                        LP,
                        Ws=[o.Ws[k % L] for k in range(j - size + 1, j + 1)]) \
                        * np.exp(-1j * self.p * L * ((j - size + 1) // L))
                LB = npc.tensordot(LB, o.VLs[i].conj(),
                                   axes=[['vR*'], ['vL*']])
                out = npc.tensordot(LB, RP, axes=[['vR', 'wR', 'p*'],
                                                  ['vL', 'wL', 'p0']])
                out.ireplace_labels(['vR*', 'vL*'], ['vL', 'vR'])
                out.itranspose(total[i].get_leg_labels())
                total[i] = total[i] + out
            return total

    # -------------------------------------------------------- initial guess
    def initial_guess(self, qtotal_change):
        """Random X guesses (numpy seed 42) in the requested charge
        sector, normalized per site."""
        X_init = []
        valid_charge = False
        rng = np.random.default_rng(42)
        for i in range(self.L):
            vL = self.VLs[i].get_leg('vR').conj()
            vL_label = 'vL'
            if self.size > 1:
                p_legs = [self.ALs[(i + j) % self.L].get_leg('p')
                          for j in range(1, self.size)]
                vL = LegPipe([vL] + p_legs)
                vL_label = '(vL' + ''.join(f'.p{j}'
                                           for j in range(1, self.size)) + ')'
            vR = self.ALs[(i + self.size) % self.L].get_leg('vL').conj()
            th0 = npc.Array.from_func(rng.standard_normal, [vL, vR],
                                      dtype=self.psi.dtype,
                                      qtotal=qtotal_change,
                                      labels=[vL_label, 'vR'])
            if self.size > 1:
                th0 = th0.split_legs()
            if np.isclose(float(npc.norm(th0)), 0):
                logger.warning("initial X guess zero on site %d "
                               "(charge not allowed there)", i)
            else:
                valid_charge = True
                th0 = th0 / npc.norm(th0)
            X_init.append(th0)
        assert valid_charge, "no valid X: requested charge cannot be realized"
        return X_init
