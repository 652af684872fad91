r"""Time evolution by MPO approximations of ``exp(-i dt H)`` on the host.

Port of ``tenpy_tpu/algorithms/mpo_evolution.py``:
:class:`ExpMPOEvolution` and :class:`TimeDependentExpMPOEvolution`.  Each
step applies the W_I or W_II MPO (arXiv:1407.1832) of
:meth:`~tenpy_tpu_torch.networks.mpo.MPO.make_U` to the state and
compresses (:meth:`~tenpy_tpu_torch.networks.mpo.MPO.apply`: 'SVD',
'zip_up' or 'variational').  Unlike TEBD it takes any MPO (long-range
Hamiltonians), at the cost of an ``O(dt)`` (W_I) or ``O(dt^2)`` (W_II)
error per step.  Everything runs on host Arrays, as in ``tenpy_tpu``.
"""

from __future__ import annotations

import logging

import numpy as np

from .algorithm import TimeEvolutionAlgorithm, TimeDependentHAlgorithm
from ..linalg.truncation import TruncationError

logger = logging.getLogger(__name__)

__all__ = ['ExpMPOEvolution', 'TimeDependentExpMPOEvolution']


class ExpMPOEvolution(TimeEvolutionAlgorithm):
    """Evolve an MPS by applying ``U ~ exp(-i dt H)`` as an MPO, step by
    step.

    Options: ``dt``, ``N_steps``, ``approximation`` ('II' | 'I'),
    ``order`` (1 | 2: the product ``U(a dt) U(conj(a) dt)``, ``a = (1 +
    i)/2``, which cancels the ``O(dt^2)`` error), ``compression_method``
    ('SVD' | 'zip_up' | 'variational'), ``trunc_params``.
    """

    def __init__(self, psi, model, options, **kwargs):
        super().__init__(psi, model, options, **kwargs)
        self.trunc_err = TruncationError()
        self._U_MPO = None
        self._U_param = {}

    def prepare_evolve(self, dt):
        self.calc_U(dt)

    def calc_U(self, dt, type_evo='real'):
        """The evolution MPO(s) of one step, kept while the parameters
        stay the same."""
        order = self.options.get('order', 2, int)
        approximation = self.options.get('approximation', 'II', str)
        param = dict(dt=dt, type_evo=type_evo, order=order,
                     approximation=approximation)
        if self._U_param == param:
            return
        self._U_param = param
        H = self.model.H_MPO
        if type_evo == 'real':
            pref = 1j * dt
        elif type_evo == 'imag':
            pref = dt
        else:
            raise ValueError(f"unknown type_evo {type_evo!r}")
        if order == 1:
            self._U_MPO = [H.make_U(pref, approximation)]
        elif order == 2:
            a = 0.5 + 0.5j
            self._U_MPO = [H.make_U(a * pref, approximation),
                           H.make_U(np.conj(a) * pref, approximation)]
        else:
            raise ValueError(f"unsupported order {order}")

    def evolve(self, N_steps, dt):
        trunc_err = TruncationError()
        opts = {'compression_method': self.options.get('compression_method',
                                                       'zip_up', str),
                'trunc_params': self.trunc_params.as_dict()}
        for _ in range(N_steps):
            for U in self._U_MPO:
                err = U.apply(self.psi, dict(opts))
                if err is not None:
                    trunc_err += err
        self.evolved_time = self.evolved_time + N_steps * dt
        self.trunc_err = self.trunc_err + trunc_err
        return trunc_err


class TimeDependentExpMPOEvolution(TimeDependentHAlgorithm, ExpMPOEvolution):
    """:class:`ExpMPOEvolution` with ``H(t)``: the MPOs are built anew
    after each re-built model."""

    def reinit_model(self):
        TimeDependentHAlgorithm.reinit_model(self)
        self._U_param = {}
