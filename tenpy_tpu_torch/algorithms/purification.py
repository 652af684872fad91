r"""Finite-temperature algorithms on a purification MPS, with the bond
updates on the card.

Port of ``tenpy_tpu/algorithms/purification.py``:
:class:`PurificationTEBD` (imaginary- and real-time TEBD whose gates act
on the physical legs ``p``, with an optional disentangler on the ancilla
legs ``q``), :class:`PurificationTEBD2` (sweeps of ``dt/2`` gates left to
right and back instead of the even/odd layers) and
:class:`PurificationApplyMPO` (variational MPO application; on the host,
as :class:`~tenpy_tpu_torch.algorithms.mps_common.VariationalApplyMPO`).

The state is a host :class:`~tenpy_tpu_torch.networks.purification_mps.
PurificationMPS`.  ``device`` (a keyword of the TEBD engines; default
``'cuda'``, which raises where PyTorch sees no card) says where a bond
update with a theta of ``N`` entries runs: on a CUDA device those from
``mps_common.DEVICE_SPLIT_THRESHOLD`` up (its comment gives the
measurement behind it; None: none); the option ``device_threshold``
forces the route (0), disables it (None) or sets another threshold, on
any device.  A card update

1. builds theta (``vL p0 q0 p1 q1 vR``) on the host and combines ``(p0,
   q0)`` and ``(p1, q1)`` into LegPipes (the packed split takes exactly
   ``vL, p0, p1, vR``);
2. packs it, and the gate ``U_p (x) 1_q`` on the same pipes (built once per
   bond and Trotter substep; with ``disentangle='backwards'`` in real time
   ``U_p (x) conj(U)_q``);
3. contracts them: one packed tensordot, one launch of the hand-written
   kernel of :mod:`~tenpy_tpu_torch.linalg.grouped_gemm`;
4. splits the result by
   :func:`~tenpy_tpu_torch.linalg.packed_split.split_truncate`, a batched
   SVD per charge sector with the host ``truncate``'s cut (the option
   ``split_backend`` is its ``backend``: None, the default, is
   ``torch.linalg.svd``; ``'jacobi'`` the hand-written Jacobi kernel);
5. unpacks A, S and B, splits the pipes, and stores them as the host route
   does.

With an iterative disentangler (any other than ``'backwards'``) the gate
and the disentangler run on the host and only the split goes to the card
(route ``'device_split'``).  ``update_stats`` lists per update ``(bond, N,
route, seconds)``, route ``'device'``, ``'device_split'`` or ``'host'``.
A failure on the card raises; nothing reruns on the host.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from . import mps_common
from .disentangler import BackwardDisentangler, get_disentangler
from .dmrg import _to_host
from .mps_common import VariationalApplyMPO
from .tebd import TEBDEngine
from ..linalg import np_conserved as npc
from ..linalg import packed as pk
from ..linalg import packed_split as ps
from ..linalg.truncation import TruncationError, svd_theta

logger = logging.getLogger(__name__)

__all__ = ['PurificationTEBD', 'PurificationTEBD2', 'PurificationApplyMPO']

_THETA_LABELS = ['vL', 'p0', 'q0', 'p1', 'q1', 'vR']
# The card's route packs theta and groups its split's matrices without
# padding (sector sizes and the split's (R, C) buckets rounded to 1, not to
# BUCKET_MULTIPLE): padding only adds zero rows and columns to the SVD's
# matrices, on which cuSOLVER's batched Jacobi SVD reported failures to
# converge.  chip_smoke.py phase 13c (H100 80GB HBM3, 700 W; PERF.md): the
# split of the chi=256 centre bond of the XX chain's purification takes
# 127.6-129.1 ms unpadded and 156.1-178.7 ms padded to 64.
PACK_MULTIPLE = 1


class PurificationTEBD(TEBDEngine):
    """TEBD on a purification: the gates act on the ``p`` legs.

    Options of :class:`~tenpy_tpu_torch.algorithms.tebd.TEBDEngine`, and
    ``disentangle`` (None or a spec of
    :func:`~tenpy_tpu_torch.algorithms.disentangler.get_disentangler`),
    ``device_threshold`` (see the module docstring).  ``device``: where
    the bond updates run from the threshold up (default ``'cuda'``).
    """

    def __init__(self, psi, model, options, *, device='cuda', **kwargs):
        self.device = pk.checked_device(device)
        super().__init__(psi, model, options, **kwargs)
        self._disentangler = get_disentangler(
            self.options.get('disentangle', None), self)
        self._update_index = None
        self.update_stats = []
        self._gates = {}
        self._gates_of = None

    # ---------------------------------------------------------- evolution
    def run_imaginary(self, beta):
        """Evolve by ``exp(-beta H / 2)``: the thermal state at inverse
        temperature ``beta`` from the infinite-temperature state.  Option
        ``dt`` (the imaginary step; ``round(beta / (2 dt))`` steps).  A
        finite state at order 2 takes :meth:`update_imag`, which keeps the
        canonical form (second order in ``dt``); otherwise
        :meth:`evolve`."""
        dt = self.options.get('dt', 0.1, 'real')
        N_steps = int(round(beta / 2. / dt))
        order = self.options.get('order', 2)
        self.calc_U(order, dt, type_evo='imag')
        if self.psi.finite and order == 2 and type(self) is PurificationTEBD:
            self.update_imag(N_steps)
        else:
            self.evolve(N_steps, dt)
        logger.info("purification: evolved to beta=%.3f", 2 * dt * N_steps)

    def update_bond_imag(self, i, U_bond):
        """Update bond ``i`` (sites ``i-1, i``) with a non-unitary gate,
        keeping the canonical form: the split's A, S and B."""
        psi = self.psi
        A_L, S, B_R, err, renorm = self._update(i, U_bond)
        psi.norm *= renorm
        psi.set_SR(i - 1, S)
        psi.set_B(i - 1, A_L, form='A')
        psi.set_B(i, B_R, form='B')
        self._add_trunc_err(i, err)
        return err

    def update_bond(self, i, U_bond):
        """Update bond ``i``; both tensors stored in B form (the left one
        as ``SL^-1 A S``)."""
        psi = self.psi
        A_L, S, B_R, err, _ = self._update(i, U_bond)
        SL_inv = psi._scale_S(psi.get_SL(i - 1), -1.)
        psi.set_SR(i - 1, S)
        psi.set_B(i - 1, A_L.iscale_axis(SL_inv, 'vL').iscale_axis(S, 'vR'),
                  form='B')
        psi.set_B(i, B_R, form='B')
        self._add_trunc_err(i, err)
        return err

    def _add_trunc_err(self, i, err):
        b = i % (self.psi.L + 1)
        self._trunc_err_bonds[b] = self._trunc_err_bonds[b] + err

    def bond_energies(self):
        """``<psi|H_bond|psi>`` per bond (ancillas traced out)."""
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
                                axes=[[l + '*' for l in _THETA_LABELS],
                                      ['vL', 'p0', 'q0', 'p1', 'q1', 'vR']])
            E.append(float(np.real(complex(val))))
        return np.array(E)

    # ------------------------------------------------------------ routes
    def theta_size(self, i):
        """The number of entries ``N`` of bond ``i``'s theta."""
        psi = self.psi
        B0, B1 = psi.get_B(i - 1, None), psi.get_B(i, None)
        n = B0.get_leg('vL').ind_len * B1.get_leg('vR').ind_len
        for B in (B0, B1):
            n *= B.get_leg('p').ind_len * B.get_leg('q').ind_len
        return n

    def route(self, N):
        """``'device'``, ``'device_split'`` or ``'host'`` for a theta of
        ``N`` entries."""
        threshold = self.options.get('device_threshold', 'auto')
        if threshold is None:
            return 'host'
        if threshold == 'auto':
            threshold = mps_common.DEVICE_SPLIT_THRESHOLD
            if self.device.type == 'cpu' or threshold is None:
                return 'host'
        if N < threshold:
            return 'host'
        if self._disentangler is None or \
                type(self._disentangler) is BackwardDisentangler:
            return 'device'
        return 'device_split'

    def _find_update_index(self, i, U_bond):
        """``(Trotter substep, index)`` of ``U_bond`` in the gates of
        :meth:`calc_U` (None for another gate)."""
        j = i if self.psi.finite else i % self.psi.L
        for k, Us in enumerate(self._U or []):
            if Us[j] is U_bond:
                return k, j
        return None

    def _update(self, i, U_bond):
        """Bond ``i``'s gate and truncated split by its route: ``(A_L, S,
        B_R, err, renorm)``, A_L and B_R with legs ``vL, p, q, vR``."""
        t0 = time.perf_counter()
        self._update_index = self._find_update_index(i, U_bond)
        N = self.theta_size(i)
        route = self.route(N)
        if route == 'host':
            res = self._update_host(i, U_bond)
        else:
            res = self._update_device(i, U_bond, route)
        self.update_stats.append((i, N, route, time.perf_counter() - t0))
        return res

    def _gate_theta(self, i, U_bond):
        """``U theta`` of bond ``i``, disentangled on the host, legs
        ``vL p0 q0 p1 q1 vR``."""
        theta = npc.tensordot(U_bond, self.psi.get_theta(i - 1, 2),
                              axes=[['p0*', 'p1*'], ['p0', 'p1']])
        if self._disentangler is not None:
            theta, _ = self._disentangler(theta)
        return theta.itranspose(_THETA_LABELS)

    def _update_host(self, i, U_bond):
        theta = self._gate_theta(i, U_bond)
        theta = theta.combine_legs([['vL', 'p0', 'q0'], ['p1', 'q1', 'vR']],
                                   qconj=[+1, -1])
        U, S, VH, err, renorm = svd_theta(theta, self.trunc_params,
                                          inner_labels=['vR', 'vL'])
        A_L = U.split_legs([0]).ireplace_labels(['p0', 'q0'], ['p', 'q'])
        B_R = VH.split_legs([1]).ireplace_labels(['p1', 'q1'], ['p', 'q'])
        return A_L, S, B_R, err, renorm

    # --------------------------------------------------- the card's route
    def _update_device(self, i, U_bond, route):
        if route == 'device':
            theta = self.psi.get_theta(i - 1, 2)
        else:
            theta = self._gate_theta(i, U_bond)
        theta = self.pipe_theta(theta)
        theta_p = self.pack_theta(theta)
        if route == 'device':
            G = self.packed_gate(theta.get_leg('p0'), theta.get_leg('p1'),
                                 U_bond)
            theta_p = self.apply_gate(G, theta_p)
        return self.split_device(theta_p, theta)

    def pack_theta(self, theta):
        """The piped ``theta`` packed on the device (no padding)."""
        return pk.pack(theta, multiple=PACK_MULTIPLE, pad_labels=('vL', 'vR'),
                       device=self.device)

    @staticmethod
    def pipe_theta(theta):
        """``theta`` (``vL p0 q0 p1 q1 vR``) with ``(p0, q0)`` and ``(p1,
        q1)`` combined into LegPipes labelled ``p0`` and ``p1``."""
        theta = theta.combine_legs([['p0', 'q0'], ['p1', 'q1']],
                                   qconj=[+1, +1])
        return theta.ireplace_labels(['(p0.q0)', '(p1.q1)'], ['p0', 'p1'])

    def packed_gate(self, pipe0, pipe1, U_bond):
        """The gate ``U_bond`` of the current update on the pipes ``(p0,
        q0)`` and ``(p1, q1)``, packed on the device: ``U_p (x) 1_q``, or
        ``U_p (x) conj(U)_q`` with the backwards disentangler in real time;
        kept per bond and Trotter substep while the gates of
        :meth:`calc_U` stay the same."""
        if self._gates_of is not self._U:
            self._gates, self._gates_of = {}, self._U
        key = self._update_index
        G = self._gates.get(key) if key is not None else None
        if G is not None:
            return G
        anc = self._disentangler.ancilla_gate() if isinstance(
            self._disentangler, BackwardDisentangler) else None
        if anc is None:
            anc = npc.outer(
                npc.diag(1., pipe0.legs[1], labels=['q0', 'q0*']),
                npc.diag(1., pipe1.legs[1], labels=['q1', 'q1*']))
        G = npc.outer(U_bond, anc).combine_legs(
            [['p0', 'q0'], ['p1', 'q1'], ['p0*', 'q0*'], ['p1*', 'q1*']],
            pipes=[pipe0, pipe1, pipe0.conj(), pipe1.conj()])
        G = mps_common.pack_W(G.iset_leg_labels(['p0', 'p1', 'p0*', 'p1*']),
                              self.device)
        if key is not None:
            self._gates[key] = G
        return G

    @staticmethod
    def apply_gate(G, theta_p):
        """The packed gate on packed theta: one kernel launch on the
        card; legs ``vL, p0, p1, vR``."""
        return pk.tensordot(G, theta_p, axes=(['p0*', 'p1*'],
                                              ['p0', 'p1'])).transpose(
            ['vL', 'p0', 'p1', 'vR'])

    def split_params(self):
        """``(chi_max, svd_min, trunc_cut)`` of the card's split, read as
        the host ``truncate`` reads them; ``chi_min`` and
        ``degeneracy_tol`` have no card form and raise."""
        tp = self.trunc_params
        chi_min = tp.get('chi_min', None, int)
        if (chi_min is not None and chi_min > 1) or \
                tp.get('degeneracy_tol', None, 'real'):
            raise NotImplementedError("the card's split has no chi_min or "
                                      "degeneracy_tol")
        # trunc_cut None: the host's cut without that constraint, which
        # split_truncate takes as trunc_cut 0
        return (tp.get('chi_max', 100, int), tp.get('svd_min', 1e-14, 'real'),
                tp.get('trunc_cut', 1e-14, 'real') or 0.)

    def split_device(self, theta_p, theta):
        """The truncated split of packed ``theta_p`` (legs ``vL, p0, p1,
        vR``; ``theta`` the host Array it was packed from) on its device,
        unpacked: ``(A_L, S, B_R, err, renorm)`` as the host route returns
        them."""
        chi_max, svd_min, trunc_cut = self.split_params()
        qA = np.zeros(theta_p.legs[0].chinfo.qnumber, np.int64)
        bond = ps.bond_layout(theta_p.legs, theta_p.qtotal, qA,
                              multiple=PACK_MULTIPLE, full_rank=True)
        plan = ps.split_plan(theta_p, bond, qA, group_multiple=PACK_MULTIPLE)
        A_p, S_p, B_p, err, renorm, _ = ps.split_truncate(
            theta_p, plan, chi_max, svd_min,
            backend=self.options.get('split_backend', None),
            trunc_cut=trunc_cut)
        return self.unpack_split(A_p, S_p, B_p, err, renorm, bond, theta)

    @staticmethod
    def unpack_split(A_p, S_p, B_p, err, renorm, bond, theta):
        """The split's packed results on the host: A and B without the
        padding and the dropped Schmidt directions, the pipes split."""
        S = S_p.cpu().numpy()
        keep = S > 0.
        A = pk.unpack(_to_host(A_p), (theta.get_leg('vL'),
                                      theta.get_leg('p0'), bond.conj()))
        B = pk.unpack(_to_host(B_p), (bond, theta.get_leg('p1'),
                                      theta.get_leg('vR')))
        A = A.iproject(keep, 'vR').ireplace_label('p', '(p.q)')
        B = B.iproject(keep, 'vL').ireplace_label('p', '(p.q)')
        eps = float(err)
        return (A.split_legs(['(p.q)']), S[keep], B.split_legs(['(p.q)']),
                TruncationError(eps, 1. - 2. * eps), float(renorm))


class PurificationTEBD2(PurificationTEBD):
    """:class:`PurificationTEBD` whose step sweeps the ``dt/2`` gates over
    the bonds left to right and back (second order by symmetry) instead
    of the even/odd layers."""

    def evolve(self, N_steps, dt):
        self.calc_U(2, dt, type_evo=self._U_param.get('type_evo', 'imag'))
        Us = self._U[0]
        trunc_err = TruncationError()
        psi = self.psi
        L = psi.L
        bonds = list(range(1, L)) if psi.finite else list(range(L))
        for _ in range(N_steps):
            for i in bonds + bonds[::-1]:
                U = Us[i if psi.finite else i % L]
                if U is not None:
                    trunc_err += self.update_bond(i, U)
        self.evolved_time = self.evolved_time + N_steps * dt
        self.trunc_err = self.trunc_err + trunc_err
        return trunc_err


class PurificationApplyMPO(VariationalApplyMPO):
    """Variational application of an MPO to a purification (the MPO acts
    on ``p``); on the host."""

    def update_bond(self, i0):
        env = self.env
        W0 = env.H.get_W(i0).replace_labels(['p', 'p*'], ['p0', 'p0*'])
        W1 = env.H.get_W(i0 + 1).replace_labels(['p', 'p*'], ['p1', 'p1*'])
        th = npc.tensordot(env.get_LP(i0), self.old_psi.get_theta(i0, n=2),
                           axes=[['vR'], ['vL']])
        th = npc.tensordot(th, W0, axes=[['wR', 'p0'], ['wL', 'p0*']])
        th = npc.tensordot(th, W1, axes=[['wR', 'p1'], ['wL', 'p1*']])
        th = npc.tensordot(th, env.get_RP(i0 + 1),
                           axes=[['wR', 'vR'], ['wL', 'vL']])
        th.ireplace_labels(['vR*', 'vL*'], ['vL', 'vR'])
        th = th.combine_legs([['vL', 'p0', 'q0'], ['p1', 'q1', 'vR']],
                             qconj=[+1, -1])
        U, S, VH, err, renorm = svd_theta(th, self.trunc_params)
        self.trunc_err_list.append(err.eps)
        self.renormalize.append(renorm)
        self.psi.set_B(i0, U.split_legs([0]).ireplace_labels(
            ['p0', 'q0'], ['p', 'q']), 'A')
        self.psi.set_SR(i0, S)
        self.psi.set_B(i0 + 1, VH.split_legs([1]).ireplace_labels(
            ['p1', 'q1'], ['p', 'q']), 'B')
        self.env.del_LP(i0 + 1)
        self.env.del_RP(i0)
