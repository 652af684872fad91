r"""Disentanglers: two-site unitaries on the ancilla legs of a purification
that lower the entanglement across the bond.

Port of ``tenpy_tpu/algorithms/disentangler.py``.  A disentangler takes the
two-site theta of a purification (legs ``vL p0 q0 p1 q1 vR``), applies a
unitary ``U`` on ``(q0, q1)`` and returns ``(U theta, U)``.  The ancilla
is traced out of every physical expectation value, so ``U`` is a gauge:
energies and correlations are unchanged, while a smaller entanglement
across the bond keeps the bond dimension of a finite-temperature
evolution small.  Every disentangler runs on the host, on host Arrays.

Two departures from ``tenpy_tpu``, both to reference TeNPy's behaviour:
:class:`BackwardDisentangler` applies ``conj(U_bond)`` to the ancillas in
real time (``tenpy_tpu``'s reads an update index its engine never sets,
so it never applies), and :class:`NoiseDisentangler` draws from a
generator seeded by the engine option ``disent_seed`` (``tenpy_tpu``
draws from an unseeded one).
"""

from __future__ import annotations

import logging

import numpy as np

from ..linalg import np_conserved as npc
from ..linalg.charges import LegPipe
from ..linalg.random_matrix import U_close_1
from ..tools.math import entropy

logger = logging.getLogger(__name__)

__all__ = ['Disentangler', 'BackwardDisentangler', 'RenyiDisentangler',
           'GradientDescentDisentangler', 'NormDisentangler',
           'NoiseDisentangler', 'LastDisentangler',
           'DiagonalizeDisentangler', 'CompositeDisentangler',
           'MinDisentangler', 'get_disentangler']


def _apply_q(U, theta):
    """``U`` (legs ``q0, q1, q0*, q1*``) on the ancillas of ``theta``."""
    return npc.tensordot(U, theta, axes=[['q0*', 'q1*'], ['q0', 'q1']])


class Disentangler:
    """The base class, and the identity: ``__call__(theta) -> (theta,
    None)``."""

    def __init__(self, parent):
        self.parent = parent

    def __call__(self, theta):
        return theta, None


class BackwardDisentangler(Disentangler):
    """In real time, the inverse evolution on the ancillas:
    ``conj(U_bond)`` on ``(q0, q1)`` (for a unitary gate ``U_p`` the state
    ``U_p conj(U)_q |psi>`` has the same ``rho``).  Does nothing in
    imaginary time, where the gate is not unitary, and for a gate not of
    the engine's Trotter tables.  The engine sets ``parent._update_index =
    (Trotter substep, bond)`` (None for such a gate) before each
    update."""

    def ancilla_gate(self):
        """The gate on ``(q0, q1)`` of the current update, or None."""
        eng = self.parent
        if eng._U_param.get('type_evo') != 'real' or \
                eng._update_index is None:
            return None
        U_idx, i = eng._update_index
        U = eng._U[U_idx][i]
        if U is None:
            return None
        U = U.conj()
        U.ireplace_labels(['p0*', 'p1*', 'p0', 'p1'],
                          ['q0', 'q1', 'q0*', 'q1*'])
        return U

    def __call__(self, theta):
        U = self.ancilla_gate()
        if U is None:
            return theta, None
        return _apply_q(U, theta), U


class GradientDescentDisentangler(Disentangler):
    """Gradient descent on the ``n``-th Renyi entropy of the bond: each
    iteration takes the anti-hermitian part of the entropy's gradient
    ``dS`` with respect to the ancilla unitary and the best of the steps
    ``U(t) = exp(-t dS)``, ``t`` in ``disent_stepsizes``.

    Options (of the engine): ``disent_max_iter`` (20), ``disent_eps``
    (1e-10), ``disent_n`` (1), ``disent_stepsizes`` ([0.2, 1, 2]).
    """

    def __init__(self, parent):
        super().__init__(parent)
        opts = parent.options
        self.max_iter = opts.get('disent_max_iter', 20, int)
        self.eps = opts.get('disent_eps', 1e-10, 'real')
        self.n = opts.get('disent_n', 1., 'real')
        self.stepsizes = opts.get('disent_stepsizes', [0.2, 1., 2.])

    def __call__(self, theta):
        S_old = np.inf
        U_tot = None
        for _ in range(self.max_iter):
            S, theta, U = self.iter(theta)
            U_tot = U if U_tot is None else \
                npc.tensordot(U, U_tot, axes=[['q0*', 'q1*'], ['q0', 'q1']])
            if abs(S_old - S) < self.eps:
                break
            S_old = S
        self.parent._last_disentangler_U = U_tot
        return theta, U_tot

    def iter(self, theta):
        """One step: ``(entropy, U theta, U)`` of the best step size."""
        th2 = theta.combine_legs([['vL', 'p0', 'q0'], ['vR', 'p1', 'q1']],
                                 qconj=[+1, -1])
        X, Y, Z = npc.svd(th2, inner_labels=['vR', 'vL'])
        n = self.n
        if n == 1:
            r = np.where(Y < 1e-14, 0.,
                         Y * np.log(np.where(Y < 1e-14, 1., Y)) * 2)
        else:
            Ys = np.where(Y < 1e-20, 1e-20, Y)
            r = Ys * Ys ** (2 * (n - 1)) * (n / (n - 1.)
                                           / np.sum(Ys ** (2 * n)))
        XrZ = npc.tensordot(X.scale_axis(r, 'vR'), Z,
                            axes=[['vR'], ['vL']]).split_legs()
        dS = npc.tensordot(
            theta, XrZ.conj(),
            axes=[['vL', 'p0', 'p1', 'vR'], ['vL*', 'p0*', 'p1*', 'vR*']])
        dS = dS.combine_legs([['q0', 'q1'], ['q0*', 'q1*']], qconj=[+1, -1])
        dS_ah = dS - dS.conj().transpose([1, 0]).iset_leg_labels(
            dS.get_leg_labels())
        best = None
        for t in self.stepsizes:
            U = npc.expm(dS_ah * (-t)).split_legs()
            U.iset_leg_labels(['q0', 'q1', 'q0*', 'q1*'])
            new_theta = _apply_q(U, theta)
            c2 = new_theta.combine_legs([['vL', 'p0', 'q0'],
                                         ['vR', 'p1', 'q1']], qconj=[+1, -1])
            S2 = npc.svd(c2, compute_uv=False)
            Sval = entropy(S2 ** 2 / np.sum(S2 ** 2), n)
            if best is None or Sval < best[0]:
                best = (Sval, new_theta, U)
        return best


class NoiseDisentangler(Disentangler):
    """A random unitary close to 1 on the ancillas (to leave a local
    minimum), ``exp(i a H)`` with ``H`` from the GUE of each charge
    sector.  ``rng``: the numpy generator to draw from; by default one
    seeded by the engine option ``disent_seed`` (None: unseeded)."""

    def __init__(self, parent, a=0.01, rng=None):
        super().__init__(parent)
        self.a = a
        if rng is None:
            rng = np.random.default_rng(
                parent.options.get('disent_seed', None))
        self.rng = rng

    def __call__(self, theta):
        pipe = LegPipe([theta.get_leg('q0').conj(),
                        theta.get_leg('q1').conj()], qconj=+1)
        U = npc.Array.from_func(
            lambda size: U_close_1(size, a=self.a, rng=self.rng),
            [pipe, pipe.conj()], dtype=np.complex128,
            shape_kw='size').split_legs()
        U.iset_leg_labels(['q0*', 'q1*', 'q0', 'q1'])
        return _apply_q(U, theta), U


class LastDisentangler(Disentangler):
    """The unitary of the engine's last renyi or graddesc
    disentangling, again (``tenpy_tpu`` keeps one per engine, not one per
    bond)."""

    def __call__(self, theta):
        U = getattr(self.parent, '_last_disentangler_U', None)
        if U is None:
            return theta, None
        return _apply_q(U, theta), U


class DiagonalizeDisentangler(Disentangler):
    """Rotate the ancillas into the eigenbasis of their two-site reduced
    density matrix (largest weight first)."""

    def __call__(self, theta):
        rho = npc.tensordot(
            theta, theta.conj(),
            axes=[['vL', 'p0', 'p1', 'vR'], ['vL*', 'p0*', 'p1*', 'vR*']])
        rho = rho.combine_legs([['q0', 'q1'], ['q0*', 'q1*']], qconj=[+1, -1])
        _, V = npc.eigh(rho, sort='m>')
        U = V.conj().itranspose([1, 0]).split_legs()
        U.iset_leg_labels(['q0', 'q1', 'q0*', 'q1*'])
        return _apply_q(U, theta), U


class RenyiDisentangler(Disentangler):
    """Maximize ``Tr(rho_L^2)`` of the bond (minimize the second Renyi
    entropy) by iterated polar decompositions of the unitary's
    environment (arXiv:1711.01288).  Options (of the engine):
    ``disent_eps`` (1e-10), ``disent_max_iter`` (20)."""

    def __init__(self, parent):
        super().__init__(parent)
        opts = parent.options
        self.max_iter = opts.get('disent_max_iter', 20, int)
        self.eps = opts.get('disent_eps', 1e-10, 'real')

    def __call__(self, theta):
        U = npc.outer(
            npc.diag(1., theta.get_leg('q0').conj(), labels=['q0*', 'q0']),
            npc.diag(1., theta.get_leg('q1').conj(), labels=['q1*', 'q1']))
        S2_old = None
        for _ in range(self.max_iter):
            S2, U = self.iter(theta, U)
            if S2_old is not None and abs(S2 - S2_old) < self.eps:
                break
            S2_old = S2
        self.parent._last_disentangler_U = U
        return _apply_q(U, theta), U

    def iter(self, theta, U):
        """One iteration: ``(-log Tr(rho_L^2), U)`` with ``U`` the polar
        unitary of the environment of the current one."""
        U_theta = _apply_q(U, theta)
        rho_L = npc.tensordot(U_theta, U_theta.conj(),
                              axes=[['p1', 'q1', 'vR'],
                                    ['p1*', 'q1*', 'vR*']])
        x = npc.tensordot(rho_L, U_theta,
                          axes=[['vL*', 'p0*', 'q0*'], ['vL', 'p0', 'q0']])
        dS = npc.tensordot(
            x, theta.conj(),
            axes=[['vL', 'p0', 'p1', 'vR'], ['vL*', 'p0*', 'p1*', 'vR*']])
        dS = dS.combine_legs([['q0', 'q1'], ['q0*', 'q1*']], qconj=[+1, -1])
        W, s, VH = npc.svd(dS, inner_labels=['vR', 'vL'])
        U_new = npc.tensordot(W, VH, axes=[['vR'], ['vL']]).split_legs()
        U_new.iset_leg_labels(['q0', 'q1', 'q0*', 'q1*'])
        return -np.log(max(float(np.sum(s)), 1e-300)), U_new


class NormDisentangler(Disentangler):
    """The norm kept at fixed chi, maximized; as in ``tenpy_tpu``, by the
    polar iteration of :class:`RenyiDisentangler`."""

    def __init__(self, parent):
        super().__init__(parent)
        self.renyi = RenyiDisentangler(parent)

    def __call__(self, theta):
        return self.renyi(theta)


class CompositeDisentangler(Disentangler):
    """Several disentanglers in sequence; returns the list of their
    unitaries."""

    def __init__(self, disentanglers):
        self.disentanglers = disentanglers

    def __call__(self, theta):
        Us = []
        for d in self.disentanglers:
            theta, U = d(theta)
            Us.append(U)
        return theta, Us


class MinDisentangler(Disentangler):
    """The one of several disentanglers (or none) whose result has the
    smallest second Renyi entropy across the bond."""

    def __init__(self, disentanglers, parent):
        self.disentanglers = disentanglers
        self.parent = parent

    @staticmethod
    def _S2(theta):
        rho = npc.tensordot(theta, theta.conj(),
                            axes=[['p1', 'q1', 'vR'], ['p1*', 'q1*', 'vR*']])
        rho_c = rho.combine_legs([['vL', 'p0', 'q0'], ['vL*', 'p0*', 'q0*']],
                                 qconj=[+1, -1])
        tr2 = npc.tensordot(rho_c, rho_c, axes=[[1, 0], [0, 1]])
        return -np.log(max(float(np.real(complex(tr2))), 1e-300))

    def __call__(self, theta):
        best = (self._S2(theta), theta, None)
        for d in self.disentanglers:
            th2, U = d(theta)
            s2 = self._S2(th2)
            if s2 < best[0]:
                best = (s2, th2, U)
        return best[1], best[2]


_DISENT_CLASSES = {
    'backwards': BackwardDisentangler,
    'graddesc': GradientDescentDisentangler,
    'renyi': RenyiDisentangler,
    'norm': NormDisentangler,
    'noise': NoiseDisentangler,
    'last': LastDisentangler,
    'diag': DiagonalizeDisentangler,
    'None': Disentangler,
}


def get_disentangler(method, parent):
    """The disentangler of a spec such as ``'renyi'``, ``'last-renyi'`` (in
    sequence) or ``'min(noise,renyi)'``; None for None or ``'None'``."""
    if method is None or method == 'None':
        return None

    def parse(spec):
        spec = spec.strip()
        if spec.startswith('min(') and spec.endswith(')'):
            parts = [p for p in spec[4:-1].split(',')
                     if p.strip() and p.strip() != 'None']
            return MinDisentangler([parse(p) for p in parts], parent)
        if '-' in spec:
            return CompositeDisentangler([parse(p)
                                          for p in spec.split('-')])
        cls = _DISENT_CLASSES.get(spec)
        if cls is None:
            raise ValueError(f"unknown disentangler {spec!r}")
        return cls(parent)

    return parse(method)
