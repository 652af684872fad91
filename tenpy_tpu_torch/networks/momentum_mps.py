r"""Momentum-superposition MPS: plane-wave excitations over a uniform MPS.

Port of ``tenpy_tpu/networks/momentum_mps.py`` (:class:`MomentumMPS`).

The state with momentum ``p`` is the translation-invariant superposition

.. math ::
    |\Phi_p(X)\rangle = \sum_n e^{i p n}
        (\dots AL_{n-1}\, B_n\, AR_{n+1} \dots), \qquad B_n = VL_n X_n,

where ``VL`` is the orthogonal complement of ``AL`` (so the excitation is
orthogonal to the ground state) and the ``X`` tensors, host
:class:`~tenpy_tpu_torch.linalg.np_conserved.Array` s, hold the
variational parameters, one per unit-cell site.
"""

from __future__ import annotations

import numpy as np

from ..linalg import np_conserved as npc

__all__ = ['MomentumMPS']


class MomentumMPS:
    """A plane-wave excitation over a uniform MPS ground state.

    Parameters
    ----------
    Xs : list of Array
        The excitation tensors, one per unit-cell site (legs ``vL, vR`` for
        single-site excitations, with ``p1 ...`` for wider ones).
    uMPS : :class:`~tenpy_tpu_torch.networks.uniform_mps.UniformMPS`
        The ground state the excitation lives on.
    p : float
        The momentum (the phase per unit cell of L sites is ``exp(i p L)``).
    n_sites : int
        The number of sites each excitation tensor spans.
    """

    def __init__(self, Xs, uMPS, p, n_sites=1):
        assert len(Xs) == uMPS.L, "need one X per unit-cell site"
        self.dtype = npc.result_type(*[X.dtype for X in Xs])
        self._X = [X.copy(deep=False) for X in Xs]
        self.uMPS_GS = uMPS
        self.p = p
        self.n_sites = n_sites

    @property
    def L(self):
        return len(self._X)

    def test_sanity(self):
        assert len(self._X) == self.uMPS_GS.L

    def copy(self):
        return MomentumMPS(self._X, self.uMPS_GS, self.p, self.n_sites)

    def get_X(self, i, copy=False):
        X = self._X[i % self.L]
        return X.copy(deep=False) if copy else X

    def set_X(self, i, X):
        self._X[i % self.L] = X

    def norm(self):
        """The norm of the X parametrization (the state's norm per
        momentum mode)."""
        return float(np.linalg.norm([float(npc.norm(X)) for X in self._X]))

    def __repr__(self):
        return (f"<MomentumMPS L={self.L} p={self.p:.4f} "
                f"n_sites={self.n_sites}>")
