"""The base class of the algorithms: state, model, options, checkpoints.

Port of ``Algorithm`` from ``tenpy_tpu/algorithms/algorithm.py``, with
its resume, RAM estimate and engine switch.  The time-evolution bases
(``TimeEvolutionAlgorithm``, ``TimeDependentHAlgorithm``) are not ported
yet.
"""

from __future__ import annotations

import numpy as np

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

    def resume_run(self):
        """Resume a run from ``resume_data`` (here: run)."""
        return self.run()

    def get_resume_data(self, sequential_simulations=False):
        """The data needed to resume the algorithm."""
        return {'psi': self.psi}

    def estimate_RAM(self, mem_saving_factor=None):
        """A rough RAM estimate in MB: four copies of the state's blocks at
        16 bytes per entry, as ``tenpy_tpu`` counts."""
        total = 0
        for B in getattr(self.psi, '_B', []):
            total += sum(int(np.prod(blk.shape)) for blk in B._data) * 16
        return total * 4 / 1024 ** 2

    def switch_engine(self, other_engine_class, *, options=None):
        """A new engine of ``other_engine_class`` that continues from this
        one's state (its resume data and cache), on this one's ``device``
        where it has one."""
        if options is None:
            options = self.options
        kw = {'device': self.device} if hasattr(self, 'device') else {}
        return other_engine_class(self.psi, self.model, options,
                                  resume_data=self.get_resume_data(),
                                  cache=self.cache, **kw)
