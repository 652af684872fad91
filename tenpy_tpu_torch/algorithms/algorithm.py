"""The base class of the algorithms: state, model, options, checkpoints.

Port of ``Algorithm`` from ``tenpy_tpu/algorithms/algorithm.py``.  The
time-evolution bases (``TimeEvolutionAlgorithm``,
``TimeDependentHAlgorithm``) are not ported yet.
"""

from __future__ import annotations

from ..tools.cache import DictCache
from ..tools.events import EventHandler
from ..tools.misc import consistency_check
from ..tools.params import asConfig

__all__ = ['Algorithm']


class Algorithm:
    """An algorithm on ``psi`` with ``model`` and ``options``.

    Options: ``trunc_params`` (a sub-Config), ``max_N_sites_per_ring``
    (18: the largest circumference of an infinite cylinder accepted).
    ``resume_data`` carries state from an earlier run, ``cache`` the
    environments' storage (default: a new in-memory cache), and the
    ``checkpoint`` event is emitted between iterations.
    """

    time_dependent_H = False

    def __init__(self, psi, model, options, *, resume_data=None, cache=None):
        self.options = asConfig(options, self.__class__.__name__)
        self.psi = psi
        self.model = model
        self.resume_data = resume_data or {}
        self.checkpoint = EventHandler("algorithm")
        self.cache = cache if cache is not None else DictCache.trivial()
        self.trunc_params = self.options.subconfig('trunc_params')
        if model is not None and getattr(model, 'lat', None) is not None:
            bc = getattr(model.lat, 'bc_MPS', 'finite')
            if bc != 'finite' and model.lat.dim > 1:
                consistency_check(max(model.lat.Ls[1:])
                                  if len(model.lat.Ls) > 1 else 0,
                                  self.options, 'max_N_sites_per_ring', 18,
                                  "2D cylinder circumference too large")

    def run(self):
        raise NotImplementedError("subclass must implement run")

    def get_resume_data(self, sequential_simulations=False):
        """The data needed to resume the algorithm."""
        return {'psi': self.psi}
