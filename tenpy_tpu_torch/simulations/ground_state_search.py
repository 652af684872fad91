r"""Excited-state simulations: orthogonalized searches, domain walls and
plane waves.

Port of ``tenpy_tpu/simulations/ground_state_search.py``;
``GroundStateSearch`` lives in :mod:`.simulation` and is re-exported here,
as in the reference layout.

* :class:`OrthogonalExcitations`: repeated DMRG runs, each orthogonal to
  the ground state and to every excitation found before it.  A finite
  ground state is used as it is; an infinite one gives a segment
  (bc ``'segment'``: ``segment_enlarge`` unit cells) embedded in its
  infinite MPO environments, the fixed point of
  :class:`~tenpy_tpu_torch.networks.mpo.MPOTransferMatrix`, so that the
  excitation energies are taken against the infinite ground state.  The
  DMRG runs are the port's engines with ``orthogonal_to``; their
  projected two-site eigensolves go to the card's packed Lanczos by the
  engine's rule (:meth:`~tenpy_tpu_torch.algorithms.dmrg.DMRGEngine.
  _use_device_lanczos`).
* :class:`TopologicalExcitations`: a domain wall between two ground
  states on a segment, the left half from one, the right half from the
  other, glued on the interface bond in a chosen charge sector, then
  relaxed by DMRG in the two states' environments.
* :class:`ExcitationInitialState`: the next excitation's start from the
  states found before it (a local operator, or random gates close to the
  identity); a segment is never canonicalized here.
* :class:`PlaneWaveExcitations`: the momentum-resolved quasiparticle
  excitations of a uniform MPS by :class:`~tenpy_tpu_torch.algorithms.
  plane_wave_excitation.PlaneWaveExcitationEngine`, on the simulation's
  ``device``.
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
           'TopologicalExcitations', 'PlaneWaveExcitations',
           'ExcitationInitialState']


class OrthogonalExcitations(GroundStateSearch):
    """Excited states by repeated orthogonalized ground-state searches.

    Each excitation is found by DMRG orthogonal to the ground state and
    to the excitations found before it.  An infinite ground state is cut
    to a segment of ``segment_enlarge`` unit cells in its infinite
    environments (:meth:`_extract_segment`), and the energies are those
    of the segment in them: only differences to the ground state's, taken
    in the same environments, mean anything.

    Options (beside :class:`GroundStateSearch`'s): ``N_excitations`` (1),
    ``ground_state_filename`` or the keyword ``ground_state_data``,
    ``ground_state_energy``, ``segment_enlarge`` (2),
    ``apply_local_op`` (``{'i': int, 'op':
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
        """The infinite ground state's segment of ``segment_enlarge`` unit
        cells with the fixed-point MPO environments of the infinite state
        (``self.init_env_data``); the model is cut to the segment
        (``self.model_inf`` keeps the infinite one).  The infinite state
        should be canonical: a ``norm_test`` above 1e-10 is logged."""
        from ..networks.mpo import MPOTransferMatrix
        psi0_inf = self.ground_state
        norm_err = float(np.max(psi0_inf.norm_test()))
        if norm_err > 1e-10:
            logger.warning("OrthogonalExcitations: the infinite ground "
                           "state's norm_test is %.2e", norm_err)
        enlarge = self.options.get('segment_enlarge', 2, int)
        env_data, Es, _ = MPOTransferMatrix.find_init_LP_RP(
            self.model.H_MPO, psi0_inf, calc_E=True)
        self.results['ground_state_energy_density'] = float(np.real(Es[0]))
        self.model_inf = self.model
        self.model = self.model.extract_segment(enlarge=enlarge)
        first, last = self.model.lat.segment_first_last
        self.ground_state = psi0_inf.extract_segment(first, last)
        self.init_env_data = env_data
        self.orthogonal_to = [self.ground_state]

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
            if E0 is None and self.init_env_data:
                # the segment's energy holds the constants of the infinite
                # environments, which cancel in E - E0
                from ..networks.mpo import MPOEnvironment
                env = MPOEnvironment(self.ground_state, self.model.H_MPO,
                                     self.ground_state,
                                     **dict(self.init_env_data))
                E0 = float(np.real(env.full_contraction(1)))
            elif E0 is None:
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
            if psi.bc != 'segment':     # a segment keeps its embedding
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
        psi.perturb(randomize, close_1=close_1,
                    canonicalize=psi.bc != 'segment')
        return psi


class TopologicalExcitations(OrthogonalExcitations):
    """Domain walls between two ground states of one model.

    A segment whose left part comes from the ground state ``alpha`` and
    whose right part from ``beta`` (two degenerate symmetry-broken or
    topologically distinct states) is glued on the bond
    ``segment_boundary`` by the zero-site problem ``LP_alpha -- RP_beta``
    in a gluing charge sector (:meth:`_glue`); DMRG then relaxes the wall
    inside the fixed alpha and beta environments.  The energies are taken
    against the uniform alpha state on the same segment in the same left
    environment.

    Options (beside :class:`OrthogonalExcitations`'):
    ``ground_state_filename_left`` and ``_right`` (or the keywords
    ``gs_data_alpha`` and ``gs_data_beta``), ``segment_enlarge`` (infinite
    states, 2), ``segment_first`` and ``segment_last`` (finite states),
    ``segment_boundary`` (the site right of the interface; default the
    middle), ``join_method`` (``'average charge'`` or ``'most probable
    charge'``), ``switch_charge_sector`` (added to the gluing charge),
    ``lanczos_params`` (of the interface problem).
    """

    def __init__(self, options, *, gs_data_alpha=None, gs_data_beta=None,
                 **kwargs):
        super().__init__(options, **kwargs)
        self._gs_data_alpha = gs_data_alpha
        self._gs_data_beta = gs_data_beta

    def _load_pair(self):
        """The two ground states, given or read from their files."""
        def load(data, key):
            if data is None:
                fn = self.options.get(key, None)
                if fn is None:
                    raise ValueError(f"TopologicalExcitations needs {key}")
                data = tio.load(fn)
            return data if isinstance(data, MPS) else data['psi']
        return (load(self._gs_data_alpha, 'ground_state_filename_left'),
                load(self._gs_data_beta, 'ground_state_filename_right'))

    def init_state(self):
        psi_a, psi_b = self._load_pair()
        if psi_a.L != psi_b.L or psi_a.bc != psi_b.bc:
            raise ValueError("left/right ground states are incompatible")
        for psi in (psi_a, psi_b):
            if psi.bc != 'segment' and \
                    float(np.max(psi.norm_test())) > 1e-10:
                psi.canonical_form()
        self.ground_state = self._glue(psi_a, psi_b)
        # the glued state is the unrelaxed wall: the first DMRG run relaxes
        # it unprojected, later ones stay orthogonal to the walls found
        self.orthogonal_to = []
        self.psi = self.ground_state.copy()
        if self.options.get('save_psi', True, bool):
            self.results['psi'] = self.psi

    def _initial_guess(self):
        if not self.excitations:
            return self.ground_state.copy()
        return super()._initial_guess()

    def _glue(self, psi_a, psi_b):
        """The glued segment MPS; sets ``self.init_env_data`` (alpha's
        left and beta's right environment), cuts the model to the segment
        and sets the option ``ground_state_energy`` to the energy of the
        uniform alpha segment."""
        from ..networks.mpo import MPOEnvironment, MPOTransferMatrix
        from ..algorithms.mps_common import ZeroSiteH
        from ..linalg import krylov_based
        from ..linalg import np_conserved as npc
        H = self.model.H_MPO
        L = psi_a.L
        if psi_a.bc == 'infinite':
            enlarge = self.options.get('segment_enlarge', 2, int)
            first, last = 0, enlarge * L - 1
            boundary = self.options.get('segment_boundary',
                                        (enlarge // 2) * L, int)
            env_data_a, Es, _ = MPOTransferMatrix.find_init_LP_RP(
                H, psi_a, calc_E=True)
            env_data_b, _, _ = MPOTransferMatrix.find_init_LP_RP(
                H, psi_b, calc_E=True)
            self.results['ground_state_energy_density'] = \
                float(np.real(Es[0]))
            env_a = MPOEnvironment(psi_a, H, psi_a, **env_data_a)
            env_b = MPOEnvironment(psi_b, H, psi_b, **env_data_b)
            self.model_inf = self.model
            self.model = self.model.extract_segment(enlarge=enlarge)
        else:
            first = self.options.get('segment_first', 0, int)
            last = self.options.get('segment_last', None)
            last = L - 1 if last is None else int(last)
            boundary = self.options.get('segment_boundary',
                                        (last + 1 - first) // 2 + first, int)
            env_a = MPOEnvironment(psi_a, H, psi_a)
            env_b = MPOEnvironment(psi_b, H, psi_b)
            self.model_orig = self.model
            self.model = self.model.extract_segment(first, last)
        if not first < boundary <= last:
            raise ValueError("segment_boundary outside the segment")
        # LP left of `boundary` and RP right of `boundary - 1`: both on
        # the interface bond
        LP_mid = env_a.get_LP(boundary)
        RP_mid = env_b.get_RP(boundary - 1)
        self.init_env_data = {'init_LP': env_a.get_LP(first),
                              'init_RP': env_b.get_RP(last),
                              'age_LP': 0, 'age_RP': 0}
        seg_a = psi_a.extract_segment(first, boundary - 1)
        seg_b = psi_b.extract_segment(boundary, last)

        vL = LP_mid.get_leg('vR').conj()
        vR = RP_mid.get_leg('vL').conj()
        chinfo = vL.chinfo
        qtotal_glue = chinfo.make_valid()
        if chinfo.qnumber > 0:
            join_method = self.options.get('join_method', 'average charge',
                                           str)
            switch = self.options.get('switch_charge_sector', None)
            if join_method == 'average charge' and psi_a.bc == 'infinite':
                Qa = np.mean([psi_a.average_charge(i) for i in range(L)], 0)
                Qb = np.mean([psi_b.average_charge(i) for i in range(L)], 0)
            else:
                pa = seg_a.probability_per_charge(seg_a.L)
                pb = seg_b.probability_per_charge(0)
                Qa = np.asarray(max(pa, key=lambda qp: qp[1])[0], float)
                Qb = np.asarray(max(pb, key=lambda qp: qp[1])[0], float)
            glue = Qa - Qb
            if switch is not None:
                glue = glue + np.asarray(switch, float)
            qtotal_glue = chinfo.make_valid(np.around(glue))
            logger.info("gluing charge: %r (offset %r)", qtotal_glue,
                        Qa - Qb)
        # the zero-site interface problem in the gluing sector
        H0 = ZeroSiteH.from_LP_RP(LP_mid, RP_mid)
        th0 = npc.Array.from_func(np.ones, [vL, vR], dtype=H0.dtype,
                                  qtotal=qtotal_glue, labels=['vL', 'vR'])
        if float(npc.norm(th0)) == 0.:
            raise ValueError(f"gluing charge {qtotal_glue!r} not reachable "
                             "on the interface bond")
        _, th0, _ = krylov_based.LanczosGroundState(
            H0, th0, self.options.subconfig('lanczos_params')).run()
        U, s, Vh = npc.svd(th0, cutoff=1e-14, inner_labels=['vR', 'vL'])
        A_last = npc.tensordot(seg_a.get_B(seg_a.L - 1, 'A'), U,
                               axes=[['vR'], ['vL']])
        seg_a.set_B(seg_a.L - 1, A_last, form='A')
        seg_a.set_SR(seg_a.L - 1, s)
        B_first = npc.tensordot(Vh, seg_b.get_B(0, 'B'),
                                axes=[['vR'], ['vL']])
        seg_b.set_B(0, B_first, form='B')
        seg_b.set_SL(0, s)
        # the energy reference: the uniform alpha state on the segment in
        # alpha's environments (the wall's energy against that background)
        seg_a_full = psi_a.extract_segment(first, last)
        env_ref = MPOEnvironment(seg_a_full, self.model.H_MPO, seg_a_full,
                                 init_LP=env_a.get_LP(first),
                                 init_RP=env_a.get_RP(last), age_LP=0,
                                 age_RP=0)
        E_ref = float(np.real(env_ref.full_contraction(1)))
        self.options['ground_state_energy'] = E_ref
        logger.info("uniform-segment reference energy: %.14f", E_ref)
        sites = seg_a.sites + seg_b.sites
        tensors = [seg_a.get_B(i, 'A') for i in range(seg_a.L)] + \
            [seg_b.get_B(i, 'B') for i in range(seg_b.L)]
        Ss = [np.asarray(seg_a.get_SL(i)) for i in range(seg_a.L)] + \
            [np.asarray(seg_b.get_SL(i)) for i in range(seg_b.L)] + \
            [np.asarray(seg_b.get_SR(seg_b.L - 1))]
        forms = ['A'] * seg_a.L + ['B'] * seg_b.L
        return MPS(sites, tensors, Ss, bc='segment', form=forms,
                   norm=psi_a.norm)


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
