r"""Simulations from options: model, state, algorithm, measurements, output.

Port of ``tenpy_tpu/simulations/simulation.py``: :class:`Simulation` with
its phases (``init_model``, ``init_state``, ``init_algorithm``,
``init_measurements``, ``run_algorithm``, ``final_measurements``,
``run_post_processing``), saving with a backup file and checkpoints every
``save_every_x_seconds``, ``from_saved_checkpoint`` and ``resume_run``,
``estimate_RAM`` and the SIGINT handling (the first Ctrl-C saves at the
next checkpoint and stops); :class:`GroundStateSearch`; and the functions
a user calls: :func:`run_simulation`, :func:`init_simulation`,
:func:`resume_from_checkpoint`, :func:`init_simulation_from_checkpoint`,
:func:`run_seq_simulations`, :func:`estimate_simulation_RAM`,
:func:`output_filename_from_dict`.

``device`` (a keyword of the simulations and of these functions; default
``'cuda'``, which raises where PyTorch sees no card) goes to every engine
class that takes one: a ground-state search sends its DMRG eigensolves to
the card by the engine's rule.  :func:`run_simulation` and
:func:`run_seq_simulations` take it from the parameters too (a YAML key
``device: cpu`` or ``-o device=cpu`` on the command line), and it is not
written into ``simulation_parameters``.  :class:`RealTimeEvolution` runs
a time evolution (TEBD, TDVP, MPO evolution) to ``final_time``, measuring
after every ``N_steps`` steps; a TDVP engine sends its local evolutions
to the card by its own rule.  The dynamical correlations are in
:mod:`~tenpy_tpu_torch.simulations.time_evolution`.
"""

from __future__ import annotations

import inspect
import logging
import os
import signal
import time

import numpy as np
import torch

from ..algorithms.algorithm import Algorithm
from ..linalg import packed as pk
from ..models.model import Model
from ..networks.mps import InitialStateBuilder
from ..tools import io as tio
from ..tools.cache import CacheFile
from ..tools.events import EventHandler
from ..tools.misc import find_subclass, get_recursive, import_port_module, \
    set_recursive, setup_logging, update_recursive
from ..tools.params import asConfig

logger = logging.getLogger(__name__)

__all__ = ['Simulation', 'Skip', 'GroundStateSearch', 'RealTimeEvolution',
           'init_simulation',
           'run_simulation', 'init_simulation_from_checkpoint',
           'resume_from_checkpoint', 'run_seq_simulations',
           'estimate_simulation_RAM', 'output_filename_from_dict']

_MEAS = 'tenpy_tpu_torch.simulations.measurement'


class Skip(ValueError):
    """The output file exists and ``skip_if_output_exists`` is set."""


class Simulation:
    """A simulation: model, initial state, algorithm, measurements, output.

    Options: ``model_class``, ``model_params``, ``initial_state_params``
    (:class:`~tenpy_tpu_torch.networks.mps.InitialStateBuilder`),
    ``initial_state_builder_class``, ``algorithm_class``,
    ``algorithm_params``, ``connect_measurements`` (entries ``(module,
    function[, kwargs])``, the module ``'psi_method'`` or
    ``'simulation_method'`` for methods; ``tenpy.`` and ``tenpy_tpu.``
    modules resolve in this package), ``post_processing``,
    ``output_filename`` or ``output_filename_params``,
    ``overwrite_output``, ``skip_if_output_exists``,
    ``save_every_x_seconds``, ``save_psi``, ``cache_params``,
    ``log_params``, ``max_errors_before_abort``.

    ``device``: where the engines that take a device run (default
    ``'cuda'``; raises without a card).
    """

    default_algorithm = 'TwoSiteDMRGEngine'
    default_post_processing = []
    default_measurements = [
        (_MEAS, 'm_measurement_index'),
        (_MEAS, 'm_bond_dimension'),
        (_MEAS, 'm_entropy'),
    ]

    def __init__(self, options, *, device='cuda', setup_logging_options=True,
                 resume_data=None):
        self.device = pk.checked_device(device)
        self.options = asConfig(options, self.__class__.__name__)
        self.results = {
            'simulation_parameters': self.options.as_dict(),
            'version_info': self.get_version_info(),
            'finished_run': False,
        }
        self._resume_data = resume_data
        self.measurement_event = EventHandler(
            "results, psi, model, simulation")
        self.checkpoint_interval = self.options.get('save_every_x_seconds',
                                                    None)
        self._last_save = time.time()
        self._abort_requested = False
        self.cache = None
        self.engine = None
        self.model = None
        self.psi = None
        self.output_filename = self.options.get('output_filename', None)
        if self.output_filename is None and \
                'output_filename_params' in self.options:
            fn_params = self.options.subconfig('output_filename_params')
            self.output_filename = output_filename_from_dict(
                self.options, parts=fn_params.get('parts', {}),
                prefix=fn_params.get('prefix', 'result'),
                suffix=fn_params.get('suffix', '.pkl'))
        if setup_logging_options:
            setup_logging(self.options.subconfig('log_params'),
                          self.output_filename)
        self._check_output()

    # ------------------------------------------------------------- context
    def __enter__(self):
        cache_params = self.options.subconfig('cache_params')
        self.cache = CacheFile.open(**cache_params.as_dict())
        self._old_sigint = signal.getsignal(signal.SIGINT)
        try:
            signal.signal(signal.SIGINT, self.handle_abort_signal)
        except ValueError:
            pass  # not in the main thread
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            signal.signal(signal.SIGINT, self._old_sigint)
        except (ValueError, AttributeError, TypeError):
            pass
        if self.cache is not None:
            self.cache.close()
        if exc_type is None:
            self.options.warn_unused(recursive=True)

    def handle_abort_signal(self, signum, frame):
        """The first SIGINT: save at the next checkpoint and stop; the
        second: stop now."""
        if self._abort_requested:
            raise KeyboardInterrupt("second SIGINT: aborting now")
        logger.warning("SIGINT: will save and abort at the next checkpoint")
        self._abort_requested = True

    # -------------------------------------------------------------- phases
    def run(self):
        """The whole simulation; returns the results."""
        self.init_model()
        self.init_state()
        self.init_algorithm()
        self.init_measurements()
        self.run_algorithm()
        self.final_measurements()
        self.run_post_processing()
        self.results['finished_run'] = True
        self.save_results(self.prepare_results_for_save())
        return self.results

    def resume_run(self):
        """Continue from the resume data of a checkpoint."""
        self.init_model()
        if self._resume_data is None:
            raise ValueError("no resume data")
        self.psi = self._resume_data['psi']
        self.init_algorithm(resume_data=self._resume_data)
        self.init_measurements()
        self.run_algorithm()
        self.final_measurements()
        self.results['finished_run'] = True
        self.save_results(self.prepare_results_for_save())
        return self.results

    def init_model(self):
        """The model from ``model_class`` and ``model_params``."""
        name = self.options.get('model_class', None)
        if name is None:
            raise ValueError("missing option 'model_class'")
        ModelClass = find_subclass(Model, name)
        self.model = ModelClass(self.options.subconfig('model_params'))

    def init_state(self):
        """The initial MPS from ``initial_state_params``."""
        params = self.options.subconfig('initial_state_params')
        builder_class = self.options.get('initial_state_builder_class',
                                         InitialStateBuilder)
        if isinstance(builder_class, str):
            builder_class = find_subclass(InitialStateBuilder,
                                          builder_class)
        self.psi = builder_class(self.model.lat, params).run()

    def init_algorithm(self, resume_data=None):
        """The engine from ``algorithm_class`` and ``algorithm_params``,
        on ``self.device`` where the class takes a device."""
        AlgClass = find_subclass(Algorithm, self.options.get(
            'algorithm_class', self.default_algorithm))
        kwargs = {'cache': self.cache}
        if resume_data is not None:
            kwargs['resume_data'] = resume_data
        if 'device' in inspect.signature(AlgClass.__init__).parameters:
            kwargs['device'] = self.device
        self.engine = AlgClass(self.psi, self.model,
                               self.options.subconfig('algorithm_params'),
                               **kwargs)
        self.engine.checkpoint.connect(self.save_at_checkpoint)

    def init_measurements(self):
        """Connect the default measurements and ``connect_measurements``."""
        from . import measurement
        con = self.options.get('connect_measurements', None)
        entries = list(self.default_measurements) + \
            [tuple(e) for e in (con or [])]
        for entry in entries:
            module_name, func_name = entry[0], entry[1]
            kwargs = dict(entry[2]) if len(entry) > 2 else {}
            if module_name in ('psi_method', 'simulation_method'):
                func = getattr(measurement, module_name)
                kwargs['method'] = func_name
            else:
                func = getattr(import_port_module(module_name), func_name)
            self.measurement_event.connect(
                (lambda f, kw: lambda *a: f(*a, **kw))(func, kwargs))
        self.results.setdefault('measurements', {})

    def make_measurements(self):
        """Emit the measurement event; a failing measurement is logged and
        counted (``max_errors_before_abort``, 10), not raised."""
        results = {}
        max_errors = self.options.get('max_errors_before_abort', 10, int)
        errors = self.results.setdefault('errors_during_run', [])
        for listener in self.measurement_event._ordered():
            try:
                listener.callback(results, self.psi, self.model, self)
            except Exception as e:  # noqa: BLE001 - counted, see above
                logger.exception("measurement failed")
                errors.append(repr(e))
                if max_errors is not None and len(errors) > max_errors:
                    raise
        meas = self.results['measurements']
        for k, v in results.items():
            meas.setdefault(k, []).append(v)
        return results

    def run_algorithm(self):
        self.engine.run()

    def final_measurements(self):
        self.make_measurements()

    def run_post_processing(self):
        """``default_post_processing`` and ``post_processing`` entries
        ``(module, function[, kwargs])``: each function gets a
        :class:`~tenpy_tpu_torch.simulations.post_processing.DataLoader`
        on the results; its return value goes to
        ``results['post_processing'][kwargs.get('results_key', name)]``."""
        entries = list(self.default_post_processing) + \
            [tuple(e) for e in (self.options.get('post_processing', None)
                                or [])]
        if not entries:
            return
        from .post_processing import DataLoader
        loader = DataLoader(data=self.results)
        pp_results = self.results.setdefault('post_processing', {})
        for entry in entries:
            module_name, func_name = entry[0], entry[1]
            kwargs = dict(entry[2]) if len(entry) > 2 else {}
            func = getattr(import_port_module(module_name), func_name)
            key = kwargs.pop('results_key', func_name)
            try:
                pp_results[key] = func(loader, **kwargs)
            except Exception as e:  # noqa: BLE001 - as for measurements
                logger.exception("post-processing %s failed", func_name)
                self.results.setdefault('errors_during_run',
                                        []).append(repr(e))

    # -------------------------------------------------------------- saving
    def get_version_info(self):
        from .. import __version__
        return {'tenpy_tpu_torch': __version__, 'torch': torch.__version__,
                'simulation_class': self.__class__.__name__,
                'numpy': np.__version__}

    def _check_output(self):
        fn = self.output_filename
        if fn is None or not os.path.exists(fn):
            return
        if self.options.get('overwrite_output', False, bool):
            return
        if self.options.get('skip_if_output_exists', False, bool):
            raise Skip(f"output file exists: {fn}")
        base, ext = os.path.splitext(fn)
        k = 1
        while os.path.exists(f"{base}_{k}{ext}"):
            k += 1
        self.output_filename = f"{base}_{k}{ext}"
        logger.warning("output exists; writing to %s", self.output_filename)

    def get_backup_filename(self, fn):
        base, ext = os.path.splitext(fn)
        return base + '.backup' + ext

    def prepare_results_for_save(self):
        """The results with the options, ``psi`` (``save_psi``) and the
        engine's resume data."""
        results = dict(self.results)
        results['simulation_parameters'] = self.options.as_dict()
        if self.options.get('save_psi', True, bool) and self.psi is not None:
            results['psi'] = self.psi
        if self.engine is not None:
            results['resume_data'] = self.engine.get_resume_data()
        return results

    def save_results(self, results=None):
        """Write the results; an existing file is moved to a backup first
        and removed after the write."""
        if results is None:
            results = self.prepare_results_for_save()
        fn = self.output_filename
        if fn is None:
            return results
        backup = self.get_backup_filename(fn)
        if os.path.exists(fn):
            os.replace(fn, backup)
        tio.save(results, fn)
        if os.path.exists(backup):
            os.remove(backup)
        self._last_save = time.time()
        logger.info("saved results to %s", fn)
        return results

    def save_at_checkpoint(self, engine):
        """The engine's checkpoint: save every ``save_every_x_seconds``
        (the interval grows to 20 saves' time where saving is slow); after
        a SIGINT save and stop."""
        if self._abort_requested:
            self.save_results()
            raise KeyboardInterrupt("aborted at checkpoint (SIGINT)")
        interval = self.checkpoint_interval
        if interval is None or self.output_filename is None:
            return
        if time.time() - self._last_save > interval:
            t0 = time.time()
            self.save_results()
            save_time = time.time() - t0
            if save_time > 0.1 * interval:
                self.checkpoint_interval = max(interval, save_time * 20)
                logger.info("saving is slow: checkpoint interval -> %.1fs",
                            self.checkpoint_interval)

    @classmethod
    def from_saved_checkpoint(cls, filename=None, checkpoint_results=None,
                              *, device='cuda'):
        """A simulation that resumes the run saved in ``filename`` (or in
        ``checkpoint_results``)."""
        if checkpoint_results is None:
            checkpoint_results = tio.load(filename)
        resume_data = checkpoint_results.get('resume_data', None)
        if resume_data is None and 'psi' in checkpoint_results:
            resume_data = {'psi': checkpoint_results['psi']}
        sim = cls(checkpoint_results['simulation_parameters'],
                  device=device, resume_data=resume_data,
                  setup_logging_options=False)
        sim.results = checkpoint_results
        sim.results['finished_run'] = False
        return sim

    def estimate_RAM(self):
        """The engine's RAM estimate (MB), after building what it needs."""
        if self.model is None:
            self.init_model()
        if self.psi is None:
            self.init_state()
        if self.engine is None:
            self.init_algorithm()
        return self.engine.estimate_RAM()


class GroundStateSearch(Simulation):
    """A ground-state search (DMRG by default); ``results['energy']`` is
    the engine's energy, and the MPO energy is measured.

    The state the engine returns becomes ``self.psi``, as in TeNPy: a
    VUMPS engine returns a new MPS, so the measurements and the saved
    ``psi`` are of the converged state.  ``tenpy_tpu`` drops it and
    measures the initial state there."""

    default_algorithm = 'TwoSiteDMRGEngine'
    default_measurements = Simulation.default_measurements + [
        (_MEAS, 'm_energy_MPO'),
    ]

    def run_algorithm(self):
        E, psi = self.engine.run()
        self.results['energy'] = E
        self.psi = psi


class RealTimeEvolution(Simulation):
    """A real-time evolution: the engine's ``run`` (``N_steps`` steps of
    ``dt``), then the measurements, until ``final_time`` (option, 1.);
    ``evolved_time`` is measured."""

    default_algorithm = 'TEBDEngine'
    default_measurements = Simulation.default_measurements + [
        (_MEAS, 'm_evolved_time'),
    ]

    def __init__(self, options, **kwargs):
        super().__init__(options, **kwargs)
        self.final_time = self.options.get('final_time', 1., 'real')

    def run_algorithm(self):
        while self.engine.evolved_time < self.final_time - 1e-10:
            self.engine.run()
            self.make_measurements()
            self.engine.checkpoint.emit(self.engine)


# ==================================================================== API
def _sim_class(simulation_class):
    if isinstance(simulation_class, str):
        return find_subclass(Simulation, simulation_class)
    return simulation_class


def init_simulation(*, simulation_class='Simulation', device='cuda',
                    **simulation_params):
    """The simulation of ``simulation_class`` (not run)."""
    return _sim_class(simulation_class)(simulation_params, device=device)


def run_simulation(simulation_class='GroundStateSearch', device='cuda',
                   **simulation_params):
    """Run a simulation from its parameters; returns its results.

    ``device`` (a keyword, or a key of the parameters, which it is taken
    from) is where the engines run: ``'cuda'`` (the default; raises
    without a card) or ``'cpu'``.  ``ground_state_data`` (a dynamical
    correlation's ground state) goes to the simulation, not into its
    options."""
    kwargs = {}
    if 'ground_state_data' in simulation_params:
        kwargs['ground_state_data'] = simulation_params.pop(
            'ground_state_data')
    sim = _sim_class(simulation_class)(simulation_params, device=device,
                                       **kwargs)
    with sim:
        return sim.run()


def init_simulation_from_checkpoint(*, filename=None,
                                    checkpoint_results=None,
                                    update_sim_params=None, device='cuda'):
    """The simulation of a saved run, its options updated by
    ``update_sim_params`` (``{'dotted.key': value}``), ready to resume."""
    if checkpoint_results is None:
        checkpoint_results = tio.load(filename)
    if update_sim_params:
        update_recursive(checkpoint_results['simulation_parameters'],
                         update_sim_params)
    cls_name = checkpoint_results.get('version_info', {}).get(
        'simulation_class', 'Simulation')
    return find_subclass(Simulation, cls_name).from_saved_checkpoint(
        checkpoint_results=checkpoint_results, device=device)


def resume_from_checkpoint(*, filename=None, checkpoint_results=None,
                           update_sim_params=None, device='cuda'):
    """Resume a saved run (a checkpoint or a finished run's results);
    returns the results."""
    sim = init_simulation_from_checkpoint(
        filename=filename, checkpoint_results=checkpoint_results,
        update_sim_params=update_sim_params, device=device)
    with sim:
        return sim.resume_run()


def run_seq_simulations(sequential, simulation_class='GroundStateSearch',
                        device='cuda', **simulation_params):
    """Simulations in sequence, each starting from the last one's state.

    ``sequential = {'recursive_keys': [...], 'value_lists': [[...], ...]}``;
    without ``value_lists`` each of the ``recursive_keys`` points at a list
    in the parameters (``examples/yaml/sequential_chi_ramp.yml``).  Returns
    the list of results."""
    sequential = dict(sequential)
    keys = sequential['recursive_keys']
    value_lists = sequential.get('value_lists', None)
    if value_lists is None:
        value_lists = [get_recursive(simulation_params, key) for key in keys]
    SimClass = _sim_class(simulation_class)
    results = []
    resume_data = None
    for values in zip(*value_lists):
        params = dict(simulation_params)
        for key, val in zip(keys, values):
            set_recursive(params, key, val, insert_dicts=True)
        sim = SimClass(params, device=device, resume_data=resume_data)
        with sim:
            if resume_data is not None:
                sim.init_model()
                sim.psi = resume_data['psi']
                sim.init_algorithm()
                sim.init_measurements()
                sim.run_algorithm()
                sim.final_measurements()
                sim.results['finished_run'] = True
                res = sim.save_results()
            else:
                res = sim.run()
        resume_data = {'psi': sim.psi}
        results.append(res)
    return results


def estimate_simulation_RAM(**simulation_params):
    """The RAM estimate (MB) of a simulation's engine."""
    return init_simulation(**simulation_params).estimate_RAM()


def output_filename_from_dict(options, parts=None, prefix='result',
                              suffix='.pkl'):
    """A filename from parameter values: ``prefix``, then for each
    ``{dotted key: format}`` of ``parts`` the value formatted (a format
    without ``{}`` is a prefix of the value), joined by '_', then
    ``suffix``."""
    pieces = [prefix]
    for key, fmt in (parts or {}).items():
        val = get_recursive(options, key)
        pieces.append(fmt.format(val) if '{' in fmt else f"{fmt}{val}")
    return '_'.join(pieces) + suffix
