"""The base class of the algorithms: state, model, options, checkpoints.

Port of ``tenpy_tpu/algorithms/algorithm.py``: ``Algorithm`` with its
resume, RAM estimate and engine switch, and the bases of the time
evolutions, ``TimeEvolutionAlgorithm`` (``evolved_time``, the ``run`` of
``N_steps`` steps of ``dt``) and ``TimeDependentHAlgorithm`` (the model
re-built at each step's start time).
"""

from __future__ import annotations

import numpy as np

from ..tools.cache import DictCache
from ..tools.events import EventHandler
from ..tools.misc import consistency_check
from ..tools.params import asConfig

__all__ = ['Algorithm', 'TimeEvolutionAlgorithm', 'TimeDependentHAlgorithm']


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


class TimeEvolutionAlgorithm(Algorithm):
    """The common interface of the time evolutions: ``evolved_time`` and a
    ``run`` of ``N_steps`` steps of ``dt``.

    Options: ``start_time`` (0), ``dt`` (0.1), ``N_steps`` (1),
    ``preserve_norm`` (default: unless the Hamiltonian depends on time,
    the state's norm after ``run`` is the one before).  Subclasses define
    ``prepare_evolve(dt)`` and ``evolve(N_steps, dt)``.
    """

    time_dependent_H = False

    def __init__(self, psi, model, options, **kwargs):
        super().__init__(psi, model, options, **kwargs)
        self.evolved_time = self.options.get('start_time', 0.)
        if 'evolved_time' in self.resume_data:
            self.evolved_time = self.resume_data['evolved_time']

    def get_resume_data(self, sequential_simulations=False):
        data = super().get_resume_data(sequential_simulations)
        data['evolved_time'] = self.evolved_time
        return data

    def run(self):
        """Evolve by ``N_steps * dt``; returns the truncation error."""
        dt = self.options.get('dt', 0.1, 'real')
        N_steps = self.options.get('N_steps', 1, int)
        self.prepare_evolve(dt)
        preserve_norm = self.options.get('preserve_norm',
                                         not self.time_dependent_H)
        if preserve_norm:
            old_norm = self.psi.norm
        trunc_err = self.run_evolution(N_steps, dt)
        if preserve_norm:
            self.psi.norm = old_norm
        return trunc_err

    def run_evolution(self, N_steps, dt):
        return self.evolve(N_steps, dt)

    def prepare_evolve(self, dt):
        raise NotImplementedError

    def evolve(self, N_steps, dt):
        raise NotImplementedError


class TimeDependentHAlgorithm(TimeEvolutionAlgorithm):
    """A time evolution under ``H(t)``: before each step the model is
    re-built at the current ``evolved_time``
    (``model.update_time_parameter``)."""

    time_dependent_H = True

    def reinit_model(self):
        """Re-build the model at the current ``evolved_time``."""
        self.model = self.model.update_time_parameter(self.evolved_time)

    def run_evolution(self, N_steps, dt):
        trunc_err = None
        for _ in range(N_steps):
            self.reinit_model()
            self.prepare_evolve(dt)
            err = self.evolve(1, dt)
            trunc_err = err if trunc_err is None else trunc_err + err
        return trunc_err
