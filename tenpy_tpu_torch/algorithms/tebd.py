r"""Time-Evolving Block Decimation on the host, and the Trotter tables and
bond gates.

Port of ``tenpy_tpu/algorithms/tebd.py``: :class:`TEBDEngine` (real and
imaginary time, the ground state by imaginary time with a ``dt`` ramp),
:class:`QRBasedTEBDEngine`, :class:`RandomUnitaryEvolution` and
:class:`TimeDependentTEBD`, on host Arrays as in ``tenpy_tpu``.  The
Suzuki-Trotter tables and the gate construction are plain functions
(:func:`suzuki_trotter_time_steps`, :func:`suzuki_trotter_decomposition`,
:func:`calc_U_bond`), which the engine exposes as its static methods and
from which the device engine
(:class:`~tenpy_tpu_torch.algorithms.packed_tebd.DeviceTEBDEngine`) builds
its gates and its brickwall schedule.

Convention: ``U_bond[i]`` acts on sites ``(i-1, i)``, like ``H_bond[i]``;
the bonds are updated in odd and even layers.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .algorithm import TimeEvolutionAlgorithm, TimeDependentHAlgorithm
from ..linalg import np_conserved as npc
from ..linalg.charges import LegPipe
from ..linalg.random_matrix import GUE, U_close_1
from ..linalg.truncation import TruncationError, svd_theta

logger = logging.getLogger(__name__)

__all__ = ['suzuki_trotter_time_steps', 'suzuki_trotter_decomposition',
           'calc_U_bond', 'TEBDEngine', 'QRBasedTEBDEngine',
           'RandomUnitaryEvolution', 'TimeDependentTEBD']


def suzuki_trotter_time_steps(order):
    """The fractions of ``dt`` of the distinct Trotter substeps of
    ``order`` (1, 2, 4 or ``'4_opt'``)."""
    if order == 1:
        return [1.]
    if order == 2:
        return [0.5, 1.]
    if order == 4:
        t1 = 1. / (4. - 4. ** (1 / 3.))
        t3 = 1. - 4. * t1
        return [t1 / 2., t1, (t1 + t3) / 2., t3]
    if order == '4_opt':
        # the optimized fourth order of Barthel and Zhang (11 layers)
        a1 = 0.095848502741203681182
        b1 = 0.42652466131587616168
        a2 = -0.078111158921637922695
        b2 = -0.12039526945509726545
        return [a1, b1, a2, b2, 0.5 - a1 - a2, 1. - 2. * (b1 + b2)]
    raise ValueError(f"unknown order {order!r}")


def suzuki_trotter_decomposition(order, N_steps):
    """The layers of ``N_steps`` Trotter steps: a list of ``(k, odd)``,
    the gates of substep ``k`` (an index into
    :func:`suzuki_trotter_time_steps`) applied to the odd (``odd=1``,
    starting at bond 1) or even bonds.  Adjacent half steps of order 2 and
    4 are merged."""
    even, odd = 0, 1
    if N_steps == 0:
        return []
    if order == 1:
        return [(0, odd), (0, even)] * N_steps
    if order == 2:
        a, a2, b = (0, odd), (1, odd), (1, even)
        return [a, b] + [a2, b] * (N_steps - 1) + [a]
    if order == 4:
        a, a2, b, c, d = (0, odd), (1, odd), (1, even), (2, odd), (3, even)
        steps = [a, b, a2, b, c, d, c, b, a2, b]
        return steps + ([a2] + steps[1:]) * (N_steps - 1) + [a]
    if order == '4_opt':
        steps = [(0, odd), (1, even), (2, odd), (3, even), (4, odd),
                 (5, even), (4, odd), (3, even), (2, odd), (1, even),
                 (0, odd)]
        return steps * N_steps
    raise ValueError(f"unknown order {order!r}")


def calc_U_bond(H_bond, dt, type_evo='real'):
    """The bond gate ``exp(-i dt H_bond)`` (``type_evo='real'``, complex128)
    or ``exp(-dt H_bond)`` (``'imag'``), by a blockwise eigendecomposition
    of ``H_bond`` (legs ``p0, p1, p0*, p1*``).  Returns an Array with the
    legs of ``H_bond``.  (``tenpy_tpu``'s ``E_offset``, which no caller
    passes, is not ported.)"""
    H = H_bond.combine_legs([['p0', 'p1'], ['p0*', 'p1*']], qconj=[+1, -1])
    W, V = npc.eigh(H)
    W = np.asarray(W)
    if type_evo == 'imag':
        diag = np.exp(-dt * W)
    elif type_evo == 'real':
        diag = np.exp(-1j * dt * W)
    else:
        raise ValueError(f"unknown type_evo {type_evo!r}")
    U = V.copy(deep=False)
    if np.iscomplexobj(diag):
        U = U.astype(torch.complex128)
    U = U.iscale_axis(diag, 1)
    U = npc.tensordot(U, V.conj().itranspose([1, 0]), axes=[[1], [0]])
    U.iset_leg_labels(['(p0.p1)', '(p0*.p1*)'])
    return U.split_legs()


class TEBDEngine(TimeEvolutionAlgorithm):
    """TEBD on the host: real or imaginary time evolution of a finite or
    infinite MPS by Trotterized bond gates, every update a contraction and
    a truncated SVD of host Arrays.

    Options: ``dt``, ``N_steps``, ``order`` (2), ``trunc_params``,
    ``start_time``, ``start_trunc_err``; for :meth:`run_GS`
    ``delta_tau_list``, ``max_error_E`` (1e-13).  The device engine is
    :class:`~tenpy_tpu_torch.algorithms.packed_tebd.DeviceTEBDEngine`.
    """

    suzuki_trotter_time_steps = staticmethod(suzuki_trotter_time_steps)
    suzuki_trotter_decomposition = staticmethod(suzuki_trotter_decomposition)

    def __init__(self, psi, model, options, **kwargs):
        super().__init__(psi, model, options, **kwargs)
        self.trunc_err = self.options.get('start_trunc_err',
                                          TruncationError())
        self._U = None
        self._U_param = {}
        self._trunc_err_bonds = [TruncationError()
                                 for _ in range(psi.L + 1)]

    @property
    def TEBD_params(self):
        return self.options

    @property
    def trunc_err_bonds(self):
        return self._trunc_err_bonds[self.psi.nontrivial_bonds]

    # ------------------------------------------------------------ the gates
    def calc_U(self, order, delta_t, type_evo='real'):
        """The bond gates ``self._U[k][i]`` of each distinct Trotter
        substep ``k``; kept while the parameters stay the same."""
        U_param = dict(order=order, delta_t=delta_t, type_evo=type_evo)
        if self._U_param == U_param:
            return
        self._U_param = U_param
        L = self.psi.L
        self._U = []
        for dt_frac in self.suzuki_trotter_time_steps(order):
            U_bond = [None] * (L + 1)
            for i, h in enumerate(self.model.H_bond):
                if h is not None:
                    U_bond[i] = calc_U_bond(h, dt_frac * delta_t, type_evo)
            self._U.append(U_bond)

    # ------------------------------------------------------------ evolution
    def prepare_evolve(self, dt):
        self.calc_U(self.options.get('order', 2), dt, type_evo='real')

    def evolve(self, N_steps, dt):
        """``N_steps`` Trotter steps with the gates of :meth:`calc_U`."""
        trunc_err = TruncationError()
        order = self._U_param['order']
        for U_idx, odd in self.suzuki_trotter_decomposition(order, N_steps):
            trunc_err += self.evolve_step(U_idx, odd)
        self.evolved_time = self.evolved_time + \
            N_steps * self._U_param['delta_t']
        self.trunc_err = self.trunc_err + trunc_err
        return trunc_err

    def evolve_step(self, U_idx_dt, odd):
        """The gates ``U[U_idx_dt]`` on every odd (``odd=1``) or even
        bond."""
        Us = self._U[U_idx_dt]
        trunc_err = TruncationError()
        psi = self.psi
        L = psi.L
        for i in (range(1, L) if psi.finite else range(0, L)):
            if i % 2 == (1 if odd else 0):
                U = Us[i] if psi.finite else Us[i % L]
                if U is not None:
                    trunc_err += self.update_bond(i, U)
        return trunc_err

    def _gate_thetas(self, i0, U_bond):
        """``U theta`` and ``U C`` of sites ``(i0, i0 + 1)``, C the theta
        without the left Schmidt values."""
        psi = self.psi
        theta = npc.tensordot(U_bond, psi.get_theta(i0, 2),
                              axes=[['p0*', 'p1*'], ['p0', 'p1']])
        C = npc.tensordot(U_bond, psi.get_theta(i0, 2, formL=0.),
                          axes=[['p0*', 'p1*'], ['p0', 'p1']])
        return (theta.itranspose(['vL', 'p0', 'p1', 'vR']),
                C.itranspose(['vL', 'p0', 'p1', 'vR']))

    def _set_bond(self, i0, C, S, VH, renorm):
        """Store ``S`` and the two B tensors of the updated bond; the left
        one without inverting Schmidt values: ``B_L = C VH^dagger /
        renorm``."""
        psi = self.psi
        B_R = VH.split_legs([1]).ireplace_label('p1', 'p')
        B_L = npc.tensordot(C.combine_legs([['p1', 'vR']], qconj=[-1]),
                            VH.conj(), axes=[['(p1.vR)'], ['(p1*.vR*)']])
        B_L.ireplace_labels(['p0', 'vL*'], ['p', 'vR'])
        B_L.itranspose(['vL', 'p', 'vR'])
        psi.set_SR(i0, S)
        psi.set_B(i0, B_L / renorm, form='B')
        psi.set_B(i0 + 1, B_R, form='B')

    def update_bond(self, i, U_bond):
        """Update bond ``i`` (sites ``i-1, i``): ``U theta``, truncated SVD,
        the inverse-free left tensor."""
        i0 = i - 1
        theta, C = self._gate_thetas(i0, U_bond)
        theta = theta.combine_legs([['vL', 'p0'], ['p1', 'vR']],
                                   qconj=[+1, -1])
        U, S, VH, err, renorm = svd_theta(theta, self.trunc_params,
                                          inner_labels=['vR', 'vL'])
        self._set_bond(i0, C, S, VH, renorm)
        b = i % (self.psi.L + 1)
        self._trunc_err_bonds[b] = self._trunc_err_bonds[b] + err
        return err

    def update_bond_imag(self, i, U_bond):
        """Update bond ``i`` with a non-unitary gate and keep the canonical
        form: store the SVD's A, S and B (valid because
        :meth:`update_imag` sweeps in order)."""
        psi = self.psi
        i0 = i - 1
        theta = npc.tensordot(U_bond, psi.get_theta(i0, 2),
                              axes=[['p0*', 'p1*'], ['p0', 'p1']])
        theta.itranspose(['vL', 'p0', 'p1', 'vR'])
        theta = theta.combine_legs([['vL', 'p0'], ['p1', 'vR']],
                                   qconj=[+1, -1])
        U, S, VH, err, renorm = svd_theta(theta, self.trunc_params,
                                          inner_labels=['vR', 'vL'])
        psi.norm *= renorm
        psi.set_SR(i0, S)
        psi.set_B(i0, U.split_legs([0]).ireplace_label('p0', 'p'), form='A')
        psi.set_B(i0 + 1, VH.split_legs([1]).ireplace_label('p1', 'p'),
                  form='B')
        b = i % (psi.L + 1)
        self._trunc_err_bonds[b] = self._trunc_err_bonds[b] + err
        return err

    def update_imag(self, N_steps):
        """Second-order imaginary time evolution (order 2, finite bc): per
        step a right sweep and a left sweep of the ``dt/2`` gates, each
        bond update keeping the canonical form."""
        if self._U_param['order'] != 2 or not self.psi.finite:
            raise NotImplementedError("update_imag needs order=2 + finite bc")
        Us = self._U[0]  # the dt/2 gates
        trunc_err = TruncationError()
        L = self.psi.L
        for _ in range(N_steps):
            for i_bond in list(range(L)) + list(range(L - 1, -1, -1)):
                if Us[i_bond] is not None:
                    trunc_err += self.update_bond_imag(i_bond, Us[i_bond])
        self.evolved_time = self.evolved_time + \
            N_steps * self._U_param['delta_t']
        self.trunc_err = self.trunc_err + trunc_err
        self.psi.canonical_form_finite(renormalize=True)
        return trunc_err

    # --------------------------------------------------------- ground state
    def run_GS(self):
        """The ground state by imaginary time evolution, ``dt`` lowered
        along ``delta_tau_list``, each stage until the mean bond energy
        changes by less than ``max_error_E`` per ``N_steps``."""
        opts = self.options
        delta_tau_list = opts.get('delta_tau_list',
                                  [0.1, 0.01, 0.001, 1e-4, 1e-5, 1e-6])
        max_error_E = opts.get('max_error_E', 1e-13, 'real')
        N_steps = opts.get('N_steps', 10, int)
        order = opts.get('order', 2)
        for delta_tau in delta_tau_list:
            self.calc_U(order, delta_tau, type_evo='imag')
            E_old = np.mean(self.bond_energies())
            use_imag = self.psi.finite and order == 2
            while True:
                if use_imag:
                    self.update_imag(N_steps)
                else:
                    self.evolve(N_steps, delta_tau)
                E = np.mean(self.bond_energies())
                dE = abs(E - E_old)
                E_old = E
                logger.info("TEBD-GS: delta_tau=%.1e, E_bond=%.14f, dE=%.2e",
                            delta_tau, E, dE)
                if dE < max_error_E:
                    break

    def bond_energies(self):
        """``<psi|H_bond|psi>`` per bond."""
        psi = self.psi
        E = []
        for i in (range(1, psi.L) if psi.finite else range(psi.L)):
            h = self.model.H_bond[i] if psi.finite else \
                self.model.H_bond[i % psi.L]
            if h is None:
                continue
            theta = psi.get_theta(i - 1, 2)
            h_th = npc.tensordot(h, theta, axes=[['p0*', 'p1*'],
                                                 ['p0', 'p1']])
            val = npc.tensordot(theta.conj(), h_th,
                                axes=[['vL*', 'p0*', 'p1*', 'vR*'],
                                      ['vL', 'p0', 'p1', 'vR']])
            E.append(float(np.real(complex(val))))
        return np.array(E)


class QRBasedTEBDEngine(TEBDEngine):
    """TEBD whose bond update truncates by a QR of theta and an SVD of its
    small R factor instead of a full SVD (arXiv:2212.09782)."""

    def update_bond(self, i, U_bond):
        i0 = i - 1
        theta, C = self._gate_thetas(i0, U_bond)
        theta_c = theta.combine_legs([['vL', 'p0'], ['p1', 'vR']],
                                     qconj=[+1, -1])
        Q, R = npc.qr(theta_c, inner_labels=['vR', 'vL'])
        U, S, VH, err, renorm = svd_theta(R, self.trunc_params,
                                          inner_labels=['vR', 'vL'])
        self._set_bond(i0, C, S, VH, renorm)
        return err


class RandomUnitaryEvolution(TEBDEngine):
    """Random charge-conserving two-site unitaries on every bond, odd
    bonds then even bonds per step (e.g. to grow the bond dimension of a
    product state).

    Options: ``N_steps`` (1), ``trunc_params``, ``close_1`` (False:
    ``exp(i H)`` with H from the GUE; True: unitaries close to the
    identity), ``seed`` (a numpy ``Generator`` seed; the same seed gives
    ``tenpy_tpu``'s gates).
    """

    def __init__(self, psi, options, **kwargs):
        TimeEvolutionAlgorithm.__init__(self, psi, None, options, **kwargs)
        self.trunc_err = TruncationError()
        self._U = None
        self._U_param = {}
        self._trunc_err_bonds = [TruncationError()
                                 for _ in range(psi.L + 1)]

    def run(self):
        return self.evolve(self.options.get('N_steps', 1, int), 0.)

    def prepare_evolve(self, dt):
        self.calc_random_U()

    def evolve(self, N_steps, dt):
        trunc_err = TruncationError()
        for _ in range(N_steps):
            self.calc_random_U()
            trunc_err += self.evolve_step(0, odd=1)
            trunc_err += self.evolve_step(0, odd=0)
        self.trunc_err = self.trunc_err + trunc_err
        return trunc_err

    def calc_random_U(self):
        """A random unitary on every bond, block diagonal in the pipe of
        the two sites' legs."""
        seed = self.options.silent_get('seed', None)
        rng = np.random.default_rng(seed) if seed is not None else \
            getattr(self, '_rng', None) or np.random.default_rng()
        self._rng = rng
        close_1 = self.options.get('close_1', False)
        psi = self.psi
        L = psi.L
        U_bond = [None] * (L + 1)
        for i in range(1, L if psi.finite else L + 1):
            pipe = LegPipe([psi.get_site(i - 1).leg, psi.get_site(i % L).leg],
                           qconj=+1)
            func = (lambda size: U_close_1(size, a=0.1, rng=rng)) if close_1 \
                else (lambda size: GUE(size, rng))
            H2 = npc.Array.from_func(func, [pipe, pipe.conj()],
                                     dtype=np.complex128, shape_kw='size')
            if close_1:
                U2 = H2
            else:
                H2 = (H2 + H2.conj().itranspose([1, 0])) * 0.5
                U2 = npc.expm(H2 * 1j)
            U2 = U2.split_legs()
            U2.iset_leg_labels(['p0', 'p1', 'p0*', 'p1*'])
            U_bond[i % (L + 1) if psi.finite else i % L] = U2
        self._U = [U_bond]
        self._U_param = {'order': 1, 'delta_t': 0., 'type_evo': 'random'}


class TimeDependentTEBD(TimeDependentHAlgorithm, TEBDEngine):
    """TEBD with a Hamiltonian that depends on time: the gates are built
    anew after each re-built model."""

    def reinit_model(self):
        TimeDependentHAlgorithm.reinit_model(self)
        self._U_param = {}
