r"""Dynamical correlations and spectral functions from real-time evolution.

Port of ``tenpy_tpu/simulations/time_evolution.py``:
:class:`TimeDependentCorrelation` computes ``C_j(t) = e^{i E_0 t}
<psi_0| B_j e^{-iHt} A_{j0} |psi_0>`` for a ground state ``psi_0``: it
applies ``A`` (``operator_t0``) to a copy of the ground state, evolves it
by the engine (TEBD, TDVP, MPO evolution) and measures the overlaps with
``B`` (``operator_t``) against the ground state after every ``N_steps``
steps; :class:`TimeDependentCorrelationEvolveBraKet` evolves the ground
state too (any start state); :class:`SpectralSimulation` and
:class:`SpectralSimulationEvolveBraKet` add the Fourier transform to
``S(k, w)`` (``pp_spectral_function``) in the post-processing.

The ground state comes from ``ground_state_data`` (a keyword: a results
dict with ``psi`` and ``energy``, or an MPS) or ``ground_state_filename``
(a results file).  As in TeNPy, options of the ground-state run whose
names start with ``model`` (``model_class``, ``model_params``) are taken
from the file's ``simulation_parameters`` where the options lack them, so
that a YAML file without a model runs from the ground-state file alone
(``tenpy_tpu`` requires ``model_class`` in the options).
"""

from __future__ import annotations

import logging
import warnings

import numpy as np

from .simulation import Simulation, RealTimeEvolution
from ..networks.mps import MPS, MPSEnvironment
from ..tools import io as tio
from ..tools.misc import consistency_check, to_iterable

logger = logging.getLogger(__name__)

__all__ = ['RealTimeEvolution', 'TimeDependentCorrelation',
           'TimeDependentCorrelationEvolveBraKet', 'SpectralSimulation',
           'SpectralSimulationEvolveBraKet']


class TimeDependentCorrelation(RealTimeEvolution):
    r"""``C_j(t) = e^{i E_0 t} <psi_0| B_j e^{-iHt} A_{j0} |psi_0>`` for a
    ground state ``psi_0``.

    Options (besides those of :class:`RealTimeEvolution`):
    ``ground_state_filename``, ``gs_energy`` (default the file's
    ``energy``, else the MPO energy of the ground state), ``operator_t``
    (a name or list of names), ``operator_t0`` (``opname``, ``mps_idx`` or
    ``lat_idx`` (default the middle site), ``key_name``).  The results go
    to ``correlation_function_t_<B>_<A>``.
    """

    default_measurements = RealTimeEvolution.default_measurements + [
        ('simulation_method', 'm_correlation_function'),
    ]

    def __init__(self, options, *, ground_state_data=None,
                 ground_state_filename=None, **kwargs):
        super().__init__(options, **kwargs)
        resume_data = kwargs.get('resume_data', None)
        if resume_data is not None and 'psi_ground_state' in resume_data:
            self.psi_ground_state = resume_data['psi_ground_state']
            self.gs_energy = resume_data.get('gs_energy', None)
        if ground_state_filename is None:
            ground_state_filename = self.options.get('ground_state_filename',
                                                     None)
        if ground_state_data is None and ground_state_filename is not None:
            logger.info("loading ground state from %r", ground_state_filename)
            ground_state_data = tio.load(ground_state_filename)
        if ground_state_data is not None:
            self._init_from_gs_data(ground_state_data)
        self.gs_energy = self.options.get('gs_energy',
                                          getattr(self, 'gs_energy', None),
                                          'real')
        self.operator_t = self.options['operator_t']
        self.operator_t0_config = self.options.subconfig('operator_t0')
        self.operator_t0_name = self._get_operator_t0_name()
        self.operator_t0 = None

    def _init_from_gs_data(self, gs_data):
        if isinstance(gs_data, MPS):
            self.psi_ground_state = gs_data
            return
        for key, val in gs_data.get('simulation_parameters', {}).items():
            if isinstance(key, str) and key.startswith('model') and \
                    key not in self.options:
                self.options[key] = val
        if 'energy' in gs_data:
            self.options['gs_energy'] = gs_data['energy']
        if 'psi' not in gs_data:
            raise ValueError("ground-state data has no 'psi'")
        psi = gs_data['psi']
        if not isinstance(psi, MPS):
            raise TypeError("ground state must be an MPS")
        if not hasattr(self, 'psi_ground_state'):
            self.psi_ground_state = psi

    def init_state(self):
        if getattr(self, 'psi_ground_state', None) is None:
            warnings.warn(f"{self.__class__.__name__}: no ground-state data "
                          "supplied; building the initial state from config")
            super().init_state()
            self.psi_ground_state = self.psi.copy()
            self.psi = None
        if getattr(self, 'psi', None) is None:
            self.psi = self.psi_ground_state.copy()
            self.apply_operator_t0_to_psi()
        if self.options.get('save_psi', True, bool):
            self.results['psi'] = self.psi
            self.results['psi_ground_state'] = self.psi_ground_state

    def init_algorithm(self, **kwargs):
        super().init_algorithm(**kwargs)
        if self.gs_energy is None:
            self.gs_energy = float(np.real(
                self.model.H_MPO.expectation_value(self.psi_ground_state)))
        if not self.engine.psi.finite:
            raise NotImplementedError(
                "dynamical correlations need finite MPS boundary conditions")

    def get_resume_data(self):
        data = super().get_resume_data() \
            if hasattr(super(), 'get_resume_data') else {}
        data['psi_ground_state'] = self.psi_ground_state
        data['gs_energy'] = self.gs_energy
        return data

    # ------------------------------------------------------------ operators
    def _get_operator_t0_name(self):
        name = self.operator_t0_config.get('key_name', None)
        if name is None:
            opname = self.operator_t0_config['opname']
            if len(to_iterable(opname)) != 1:
                raise KeyError("key_name required for multiple operators")
            name = opname if isinstance(opname, str) else opname[0]
        return name

    def _get_operator_t0_list(self):
        ops = to_iterable(self.operator_t0_config['opname'])
        mps_idx = self.operator_t0_config.get('mps_idx', None)
        lat_idx = self.operator_t0_config.get('lat_idx', None)
        if mps_idx is not None and lat_idx is not None:
            raise KeyError("give either mps_idx or lat_idx, not both")
        if mps_idx is not None:
            idx = to_iterable(mps_idx)
        elif lat_idx is not None:
            idx = to_iterable(self.model.lat.lat2mps_idx(lat_idx))
        else:
            idx = to_iterable(self.model.lat.N_sites // 2)
        if len(ops) > len(idx):
            if len(idx) != 1:
                raise ValueError("ill-defined operator/index tiling")
            idx = list(idx) * len(ops)
        elif len(ops) < len(idx):
            if len(ops) != 1:
                raise ValueError("ill-defined operator/index tiling")
            ops = list(ops) * len(idx)
        return list(zip(ops, idx))

    def apply_operator_t0_to_psi(self):
        self.operator_t0 = ops = self._get_operator_t0_list()
        for op, i in ops:
            self.psi.apply_local_op(i, op)

    # ------------------------------------------------------------- measure
    def m_correlation_function(self, results, psi, model, simulation,
                               **kwargs):
        r"""``e^{i E_0 t} <psi_0| B_j e^{-iHt} A |psi_0>`` on every site
        ``j``, for each ``B`` of ``operator_t``."""
        for op in to_iterable(self.operator_t):
            env = MPSEnvironment(self.psi_ground_state, psi)
            phase = np.exp(1j * self.gs_energy * self.engine.evolved_time)
            key = f"correlation_function_t_{op}_{self.operator_t0_name}"
            results[key] = np.asarray(env.expectation_value(op)) * phase


class TimeDependentCorrelationEvolveBraKet(TimeDependentCorrelation):
    r"""``C_j(t) = <psi| e^{iHt} B_j e^{-iHt} A_{j0} |psi>``: bra and ket
    are both evolved (a second engine for the bra), so ``psi`` need not
    be an eigenstate."""

    def __init__(self, *args, **kwargs):
        self.engine_bra = None
        super().__init__(*args, **kwargs)

    def init_algorithm(self, **kwargs):
        Simulation.init_algorithm(self, **kwargs)
        AlgClass = self.engine.__class__
        params = self.options.subconfig('algorithm_params')
        kw = {'device': self.engine.device} \
            if hasattr(self.engine, 'device') else {}
        self.engine_bra = AlgClass(self.psi_ground_state, self.model, params,
                                   **kw)
        if self.gs_energy is None:
            self.gs_energy = 0.

    def run_algorithm(self):
        while np.real(self.engine.evolved_time) < self.final_time - 1e-10:
            self.engine_bra.run()
            self.engine.run()
            assert np.isclose(np.real(self.engine_bra.evolved_time),
                              np.real(self.engine.evolved_time)), \
                "bra evolved to a different time than ket"
            self.make_measurements()
            self.engine.checkpoint.emit(self.engine)

    def m_correlation_function(self, results, psi, model, simulation,
                               **kwargs):
        for op in to_iterable(self.operator_t):
            env = MPSEnvironment(self.engine_bra.psi, psi)
            key = f"correlation_function_t_{op}_{self.operator_t0_name}"
            results[key] = np.asarray(env.expectation_value(op))


class SpectralSimulation(TimeDependentCorrelation):
    """:class:`TimeDependentCorrelation` and, in the post-processing, the
    spectral function ``S(k, w)`` of each correlation
    (``spectral_function_<B>_<A>``).

    Options add ``spectral_function_params`` (keywords of
    :func:`~tenpy_tpu_torch.tools.spectral_function_tools.
    spectral_function`) and ``max_rel_prediction_time`` (3).
    """

    def run_post_processing(self):
        extra_kwargs = self.options.get('spectral_function_params', {})
        consistency_check(
            extra_kwargs.get('rel_prediction_time', 1), self.options,
            'max_rel_prediction_time', 3,
            "excessive linear prediction: max_rel_prediction_time exceeded")
        for key in list(self.results.get('measurements', {}).keys()):
            if 'correlation_function_t' in key:
                kw = {'results_key': key.replace('correlation_function_t',
                                                 'spectral_function'),
                      'correlation_key': key}
                kw.update(extra_kwargs)
                entry = ('tenpy_tpu_torch.simulations.post_processing',
                         'pp_spectral_function', kw)
                self.default_post_processing = \
                    list(self.default_post_processing) + [entry]
        return super().run_post_processing()


class SpectralSimulationEvolveBraKet(SpectralSimulation,
                                     TimeDependentCorrelationEvolveBraKet):
    """:class:`SpectralSimulation` with bra and ket evolved."""
