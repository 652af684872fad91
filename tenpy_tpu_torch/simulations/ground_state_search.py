r"""Excited-state simulations: orthogonalized searches and plane waves.

Port of ``tenpy_tpu/simulations/ground_state_search.py``
(:class:`OrthogonalExcitations` on finite ground states,
:class:`ExcitationInitialState`, :class:`PlaneWaveExcitations`);
``GroundStateSearch`` lives in :mod:`.simulation` and is re-exported here,
as in the reference layout.

* :class:`OrthogonalExcitations`: repeated DMRG runs, each orthogonal to
  the ground state and to every excitation found before it.  The DMRG
  runs are the port's engines with ``orthogonal_to``, which solve on the
  host (:class:`~tenpy_tpu_torch.algorithms.dmrg.TwoSiteDMRGEngine` routes
  no such update to the card).  An infinite ground state needs a segment
  in its infinite environments (segment bc), which is not ported:
  :meth:`OrthogonalExcitations._extract_segment` raises.
* :class:`PlaneWaveExcitations`: the momentum-resolved quasiparticle
  excitations of a uniform MPS by :class:`~tenpy_tpu_torch.algorithms.
  plane_wave_excitation.PlaneWaveExcitationEngine`, on the simulation's
  ``device``.

``TopologicalExcitations`` (domain walls between two ground states on a
segment) waits for segment bc and is not defined here.
"""

from __future__ import annotations

import inspect
import logging

import numpy as np

from .simulation import GroundStateSearch
from ..algorithms.algorithm import Algorithm
from ..networks.mps import MPS, InitialStateBuilder
from ..tools import io as tio
from ..tools.misc import find_subclass

logger = logging.getLogger(__name__)

__all__ = ['GroundStateSearch', 'OrthogonalExcitations',
           'PlaneWaveExcitations', 'ExcitationInitialState']


class OrthogonalExcitations(GroundStateSearch):
    """Excited states by repeated orthogonalized ground-state searches.

    Each excitation of a finite ground state is found by DMRG orthogonal
    to the ground state and to the excitations found before it.

    Options (beside :class:`GroundStateSearch`'s): ``N_excitations`` (1),
    ``ground_state_filename`` or the keyword ``ground_state_data``,
    ``ground_state_energy``, ``apply_local_op`` (``{'i': int, 'op':
    str}``: a local operator defining the initial guess, e.g. a spin flip,
    which also changes the charge sector), ``initial_state_params`` and
    ``initial_state_builder_class`` for each excitation's start.
    """

    def __init__(self, options, *, orthogonal_to=None, ground_state_data=None,
                 **kwargs):
        super().__init__(options, **kwargs)
        self.orthogonal_to = list(orthogonal_to) if orthogonal_to else None
        self.excitations = []
        self.results['excitation_energies'] = []
        if self.options.get('save_psi', True, bool):
            self.results['excitations'] = self.excitations
        self._gs_data = ground_state_data
        self.init_env_data = {}
        self.ground_state = None

    def init_state(self):
        if self.orthogonal_to is None:
            gs_fn = self.options.get('ground_state_filename', None)
            gs_data = self._gs_data
            if gs_data is None and gs_fn is not None:
                gs_data = tio.load(gs_fn)
            if gs_data is None:
                super().init_state()    # the ground state is found first
                self.ground_state = None
                self.orthogonal_to = []
                return
            psi0 = gs_data if isinstance(gs_data, MPS) else gs_data['psi']
            self.ground_state = psi0
            self.orthogonal_to = [psi0]
        if not self.ground_state.finite:
            self._extract_segment()
        self.psi = self._initial_guess()
        if self.options.get('save_psi', True, bool):
            self.results['psi'] = self.psi

    def _extract_segment(self):
        """An infinite ground state's segment with its infinite MPO
        environments: needs segment bc, which the port lacks."""
        raise NotImplementedError(
            "OrthogonalExcitations of an infinite ground state runs on a "
            "segment (bc_MPS='segment'), which is not ported; pass a "
            "finite ground state")

    def _initial_guess(self):
        """The next excitation's initial state from
        ``initial_state_builder_class`` (default
        :class:`ExcitationInitialState`); another
        :class:`~tenpy_tpu_torch.networks.mps.InitialStateBuilder` gets
        the usual ``(lattice, params)``."""
        params = self.options.subconfig('initial_state_params')
        builder_class = self.options.get('initial_state_builder_class',
                                         'ExcitationInitialState')
        Builder = find_subclass(InitialStateBuilder, builder_class)
        if issubclass(Builder, ExcitationInitialState):
            builder = Builder(self, params)
        else:
            builder = Builder(self.model.lat, params)
        return builder.run()

    def init_algorithm(self, **kwargs):
        """The engine of ``algorithm_class`` with ``orthogonal_to``, on
        ``self.device`` where the class takes a device."""
        AlgClass = find_subclass(Algorithm, self.options.get(
            'algorithm_class', self.default_algorithm))
        params = self.options.subconfig('algorithm_params')
        kw = {'orthogonal_to': list(self.orthogonal_to)}
        if self.init_env_data:
            kw['resume_data'] = {'init_env_data': dict(self.init_env_data)}
        if 'device' in inspect.signature(AlgClass.__init__).parameters:
            kw['device'] = self.device
        self.engine = AlgClass(self.psi, self.model, params, **kw)
        self.engine.checkpoint.connect(self.save_at_checkpoint)

    def run_algorithm(self):
        N = self.options.get('N_excitations', 1, int)
        if self.ground_state is None:
            GroundStateSearch.init_algorithm(self)
            E0, psi0 = self.engine.run()
            self.results['ground_state_energy'] = E0
            self.ground_state = psi0.copy()
            self.orthogonal_to = [self.ground_state]
            logger.info("OrthogonalExcitations: ground state E0=%.14f", E0)
        else:
            E0 = self.options.get('ground_state_energy', None, 'real')
            if E0 is None:
                E0 = float(np.real(
                    self.model.H_MPO.expectation_value(self.ground_state)))
            self.results.setdefault('ground_state_energy', E0)
        while len(self.excitations) < N:
            self.psi = self._initial_guess()
            self.init_algorithm()
            E, psi = self.engine.run()
            gap = E - self.results['ground_state_energy']
            self.results['excitation_energies'].append(gap)
            self.excitations.append(psi.copy())
            self.orthogonal_to.append(psi.copy())
            logger.info("excitation %d: E - E0 = %.14f",
                        len(self.excitations), gap)
            self.make_measurements()
        return self.results['excitation_energies']


class ExcitationInitialState(InitialStateBuilder):
    """Initial states for :class:`OrthogonalExcitations`: a builder that
    knows the simulation, so the next excitation starts from the states
    found before it.

    Options (method ``'from_orthogonal'`` by default):
    ``use_highest_excitation`` (True: perturb the last state of
    ``sim.orthogonal_to``; False: the ground state), ``apply_local_op``
    (``{'i': int, 'op': str}`` instead of the random perturbation; also
    read from the simulation's options), ``randomize_params`` (of
    :meth:`~tenpy_tpu_torch.networks.mps.MPS.perturb`: random two-site
    unitaries close to the identity), ``randomize_close_1`` (True).
    """

    def __init__(self, sim, options):
        self.sim = sim
        super().__init__(sim.model.lat, options)
        self.options.setdefault('method', 'from_orthogonal')

    def from_orthogonal(self):
        sim = self.sim
        use_highest = self.options.get('use_highest_excitation', True, bool)
        if use_highest and sim.orthogonal_to:
            psi = sim.orthogonal_to[-1]
        else:
            psi = sim.ground_state
        psi = psi.copy()
        local_op = self.options.get('apply_local_op', None)
        if local_op is None:
            local_op = sim.options.get('apply_local_op', None)
        if local_op is not None:
            psi.apply_local_op(local_op['i'], local_op['op'], unitary=False,
                               renormalize=True)
            psi.canonical_form()
            return psi
        return self._perturb(psi)

    def _perturb(self, psi):
        # a copy of the previous state is (nearly) parallel to the states
        # projected out, so the orthogonalized eigensolve would start from
        # about zero: perturb it by random unitaries close to the identity
        randomize = self.options.subconfig('randomize_params')
        randomize.setdefault('N_steps', 2)
        randomize.setdefault('trunc_params', {'chi_max': max(max(psi.chi), 8),
                                              'svd_min': 1e-12})
        close_1 = self.options.get('randomize_close_1', True, bool)
        psi.perturb(randomize, close_1=close_1)
        return psi


class PlaneWaveExcitations(GroundStateSearch):
    """Momentum-resolved quasiparticle excitations of a uniform MPS.

    Options: ``ground_state_filename`` or the keyword
    ``ground_state_data`` (an infinite canonical MPS or a UniformMPS),
    ``momenta`` (a list, else ``num_momenta`` (8) from 0 to pi),
    ``qtotal_change``, ``num_ev``, and the engine's options under
    ``algorithm_params``.  The engine runs on the simulation's ``device``.
    """

    default_algorithm = 'PlaneWaveExcitationEngine'

    def __init__(self, options, *, ground_state_data=None, **kwargs):
        super().__init__(options, **kwargs)
        self._gs_data = ground_state_data
        self.results['excitation_energies'] = []
        self.results['momenta'] = []

    def init_state(self):
        gs_data = self._gs_data
        gs_fn = self.options.get('ground_state_filename', None)
        if gs_data is None and gs_fn is not None:
            gs_data = tio.load(gs_fn)
        if gs_data is None:
            super().init_state()        # a state built from the options
            return
        self.psi = gs_data if isinstance(gs_data, MPS) else gs_data['psi']
        if self.options.get('save_psi', True, bool):
            self.results['psi'] = self.psi

    def init_algorithm(self, **kwargs):
        from ..algorithms.plane_wave_excitation import \
            PlaneWaveExcitationEngine
        params = self.options.subconfig('algorithm_params')
        self.engine = PlaneWaveExcitationEngine(self.psi, self.model, params,
                                                device=self.device)

    def run_algorithm(self):
        momenta = self.options.get('momenta', None)
        if momenta is None:
            n = self.options.get('num_momenta', 8, int)
            momenta = list(np.linspace(0., np.pi, n))
        qtotal_change = self.options.get('qtotal_change', None)
        num_ev = self.options.get('num_ev', 1, int)
        for p in momenta:
            Es, psis, N = self.engine.run(float(p),
                                          qtotal_change=qtotal_change,
                                          num_ev=num_ev)
            self.results['momenta'].append(float(p))
            self.results['excitation_energies'].append(
                [float(np.real(E)) for E in np.atleast_1d(Es)])
            logger.info("p=%.4f: E_exc=%s", p, Es)
        return self.results['excitation_energies']
