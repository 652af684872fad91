"""The port's simulation layer and command line against ``tenpy_tpu``'s.

The ground-state cases of ``tests/test_simulation.py`` (XXZ L=8:
``GroundStateSearch``, checkpoint and resume, sequential simulations, the
command line on a YAML file with an ``-o`` override) and the repo's two
DMRG YAML files (``examples/yaml/minimal_DMRG.yml`` and
``sequential_chi_ramp.yml``, cut to L=8 and small chi) run through the
port on the CPU (``device='cpu'``); every stage's energy, MPO energy and
``max_chi`` are held to ``tenpy_tpu``'s runs of the same configs in
``tests/benchmark_data/simulation_reference.npz`` (written by ``python
tests/torch_exchange.py --write-simulation``; no JAX runs here).  Then:
``python -m tenpy_tpu_torch`` in a subprocess on a YAML file that names
``tenpy_tpu.simulations.measurement``, which imports neither JAX nor
``tenpy_tpu`` (and refuses a results pickle that JAX wrote); the saved
results (``psi``, measurements, resume data); the port's ``ExactDiag``;
the entry points besides the run (the memory estimate and ``--RAM``,
``switch_engine``, the dense and sparse H) against JAX's; and ``device``:
the default ('cuda') raising without a card.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_exchange as tx
from tenpy_tpu_torch.networks import exchange
from tenpy_tpu_torch.networks.mps import MPS
from tenpy_tpu_torch.simulations import simulation as sim
from tenpy_tpu_torch.tools import io as tio

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, 'tests', 'benchmark_data',
                   'simulation_reference.npz')
E_TOL = 1e-10
H5_FILES = [os.path.join(ROOT, 'tests', 'export_import', 'data', f)
            for f in ('exported_from_0.1.0.dev0.h5',
                      'exported_from_ref_tenpy_1.1.0.h5')]


@pytest.fixture(scope='module')
def ref():
    flat = exchange.load_flat(REF)
    assert json.loads(str(flat['gs_params'])) == tx.SIM_GS_PARAMS
    assert json.loads(str(flat['yaml'])) == \
        {k: [fn, list(o)] for k, (fn, o) in tx.SIM_YAML.items()}
    return flat


@pytest.fixture(scope='module')
def gs_run(tmp_path_factory):
    """The port's ``gs`` case (its values and its output directory), which
    two tests read."""
    tmpdir = str(tmp_path_factory.mktemp('gs'))
    return tx.simulation_case('torch', 'gs', tmpdir), tmpdir


@pytest.mark.parametrize('case', ['gs', 'checkpoint', 'seq', 'cli',
                                  'minimal', 'sequential'])
def test_simulation_vs_jax(case, ref, tmp_path, request):
    """Each stage's energy and MPO energy within 1e-10 relative of JAX's,
    and its max_chi equal."""
    if case == 'gs':
        out = request.getfixturevalue('gs_run')[0]
    else:
        out = tx.simulation_case('torch', case, str(tmp_path))
    stages = sorted({k.rsplit('.', 1)[0] for k in out})
    assert stages == sorted({k.rsplit('.', 1)[0] for k in ref
                             if k.startswith(case + '.')})
    for st in stages:
        for key in ('energy', 'energy_MPO'):
            E, E_ref = float(out[f'{st}.{key}']), float(ref[f'{st}.{key}'])
            assert abs(E - E_ref) <= E_TOL * abs(E_ref), (st, key, E, E_ref)
        assert int(out[f'{st}.max_chi']) == int(ref[f'{st}.max_chi']), st


def test_ground_state_search(ref, gs_run):
    """``run_simulation`` of the XXZ chain (the ``gs`` case): the energy
    equals the port's ``ExactDiag`` (sector 0) and JAX's; the saved file
    holds the port's ``MPS`` on host tensors, the measurements and the
    resume data."""
    from tenpy_tpu_torch.algorithms.exact_diag import ExactDiag
    from tenpy_tpu_torch.models.xxz_chain import XXZChain
    data = tio.load(os.path.join(gs_run[1], 'gs.pkl'))
    ed = ExactDiag(XXZChain(dict(tx.SIM_GS_PARAMS['model_params'])),
                   charge_sector=[0])
    ed.full_diagonalization()
    E_ed, _ = ed.groundstate()
    assert abs(data['energy'] - E_ed) <= E_TOL * abs(E_ed)
    assert abs(E_ed - float(ref['ed.xxz.E'][0])) <= 1e-12 * abs(E_ed)
    assert data['finished_run'] and 'device' not in \
        data['simulation_parameters']
    assert isinstance(data['psi'], MPS)
    assert all(b.device.type == 'cpu' for B in data['psi']._B
               for b in B._data)
    assert data['resume_data']['psi'] is data['psi']
    for key in ('max_chi', 'entropy', 'energy_MPO', 'measurement_index'):
        assert key in data['measurements']
    assert data['version_info']['torch'] == torch.__version__


def test_exact_diag_vs_jax(ref):
    """The port's ``ExactDiag`` spectra against JAX's (1e-12): XXZ L=8 in
    sector 0 and the Ising chain L=8 without charges."""
    from tenpy_tpu_torch.algorithms.exact_diag import ExactDiag
    from tenpy_tpu_torch.models.tf_ising import TFIChain
    from tenpy_tpu_torch.models.xxz_chain import XXZChain
    for name, model, sector in tx.ED_CASES:
        M = XXZChain if name == 'xxz' else TFIChain
        ed = ExactDiag(M(dict(model)), charge_sector=sector)
        ed.full_diagonalization()
        E_ref = ref[f'ed.{name}.E']
        assert len(ed.E) == len(E_ref)
        np.testing.assert_allclose(np.sort(ed.E), E_ref, rtol=0,
                                   atol=1e-12 * np.max(np.abs(E_ref)))


@pytest.mark.parametrize('case', tx.ENTRY_CASES)
def test_entry_points_vs_jax(case, ref, tmp_path):
    """The memory estimate (``estimate_simulation_RAM``) equal to JAX's and
    ``console_main --RAM`` printing JAX's line; ``switch_engine`` from the
    two-site to the single-site engine continuing from the same state,
    both energies within 1e-10 relative of JAX's; the dense H (and the
    sparse one, equal to it) within 1e-12 of JAX's."""
    out = tx.entry_point_case('torch', case, str(tmp_path))
    assert sorted(out) == sorted(k for k in ref
                                 if k.startswith(case + '.'))
    if case == 'ram':
        assert float(out['ram.estimate']) == float(ref['ram.estimate'])
        assert str(out['ram.cli']) == str(ref['ram.cli']) == \
            f"estimated RAM: {float(out['ram.estimate']):.1f} MB"
    elif case == 'switch_engine':
        for key in ('switch_engine.E0', 'switch_engine.E1'):
            E, E_ref = float(out[key]), float(ref[key])
            assert abs(E - E_ref) <= E_TOL * abs(E_ref), (key, E, E_ref)
        assert int(out['switch_engine.chi']) == int(ref['switch_engine.chi'])
    else:
        np.testing.assert_allclose(out['numpy_H.H'], ref['numpy_H.H'],
                                   rtol=0, atol=1e-12)


def test_cli_subprocess_imports_no_jax(ref, tmp_path):
    """``python -m tenpy_tpu_torch`` on a YAML file whose measurement names
    ``tenpy_tpu.simulations.measurement`` (mapped onto the port) runs on
    the CPU, and the same process then loads both committed HDF5 files of
    ``tests/export_import/data`` (naming ``tenpy_tpu.*`` and ``tenpy.*``
    modules) and refuses a results pickle that JAX wrote (its classes are
    ``tenpy_tpu``'s), with neither ``jax`` nor ``tenpy_tpu`` imported;
    without ``-o device=cpu`` the command line raises for the missing
    card."""
    import yaml
    params = json.loads(json.dumps(tx.SIM_GS_PARAMS))
    params['model_params']['L'] = 6
    params['connect_measurements'] = [
        ['tenpy_tpu.simulations.measurement', 'm_onsite_expectation_value',
         {'opname': 'Sz'}]]
    params['log_params'] = tx.SIM_LOG
    fn_yaml = tmp_path / 'p.yml'
    fn_out = tmp_path / 'out.pkl'
    fn_yaml.write_text(yaml.safe_dump(params))
    fn_jax = tmp_path / 'jax_results.pkl'
    fn_jax.write_bytes(ref['jax_results_pkl'].tobytes())
    code = ("import sys, runpy\n"
            "sys.argv = ['tenpy_tpu_torch'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('tenpy_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "from tenpy_tpu_torch.tools import io\n"
            f"for f in {H5_FILES!r}:\n"
            "    assert type(io.load(f)['mps']).__module__ == "
            "'tenpy_tpu_torch.networks.mps'\n"
            "try:\n"
            f"    io.load({str(fn_jax)!r})\n"
            "    raise AssertionError('a JAX pickle loaded')\n"
            "except io.Hdf5ImportError as e:\n"
            "    assert 'tenpy_tpu.' in str(e) and '.h5' in str(e), e\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'tenpy_tpu', 'tenpy'))\n"
            "assert not bad, bad\n"
            "print('no jax')\n")
    res = subprocess.run(
        [sys.executable, '-c', code, str(fn_yaml), '-o', 'device=cpu',
         '-o', f'output_filename={fn_out}'], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith('no jax')
    data = tio.load(str(fn_out))
    assert data['finished_run']
    assert abs(np.sum(data['measurements']['<Sz>'][-1])) < 1e-12
    if torch.cuda.is_available():
        return
    from tenpy_tpu_torch import console_main
    with pytest.raises(RuntimeError, match='no CUDA device'):
        console_main([str(fn_yaml), '-o',
                      f'output_filename={tmp_path / "cuda.pkl"}'])


def test_simulation_defaults_to_the_card(tmp_path):
    """Without ``device`` the simulation functions take the card and raise
    where there is none (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    params = dict(json.loads(json.dumps(tx.SIM_GS_PARAMS)),
                  log_params=tx.SIM_LOG)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        sim.run_simulation(simulation_class='GroundStateSearch', **params)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        sim.run_seq_simulations({'recursive_keys': ['model_params.Jz'],
                                 'value_lists': [[0.5]]}, **params)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        sim.GroundStateSearch(params)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        sim.resume_from_checkpoint(checkpoint_results={
            'simulation_parameters': params, 'version_info': {
                'simulation_class': 'GroundStateSearch'}})


def test_find_subclass_and_module_names():
    """The packages' ``__init__`` load the models and engines, so that a
    simulation finds them by name; dotted names and module paths of
    ``tenpy`` and ``tenpy_tpu`` resolve in the port."""
    from tenpy_tpu_torch.algorithms.algorithm import Algorithm
    from tenpy_tpu_torch.algorithms.dmrg import TwoSiteDMRGEngine
    from tenpy_tpu_torch.models.model import Model
    from tenpy_tpu_torch.models.spins import SpinChain
    from tenpy_tpu_torch.simulations import measurement
    from tenpy_tpu_torch.tools.misc import find_subclass, \
        import_port_module
    assert find_subclass(Model, 'SpinChain') is SpinChain
    assert find_subclass(Algorithm, 'TwoSiteDMRGEngine') is \
        TwoSiteDMRGEngine
    for name in ('tenpy_tpu.models.spins.SpinChain',
                 'tenpy.models.spins.SpinChain',
                 'tenpy_tpu_torch.models.spins.SpinChain'):
        assert find_subclass(Model, name) is SpinChain
    for mod in ('tenpy.simulations.measurement',
                'tenpy_tpu.simulations.measurement'):
        assert import_port_module(mod) is measurement
    with pytest.raises(ValueError):
        find_subclass(Model, 'NoSuchModel')


@pytest.mark.parametrize('method', ['lat_product_state', 'mps_product_state',
                                    'randomized', 'desired_bond_dimension',
                                    'from_file'])
def test_initial_state_builder(method, tmp_path):
    """Every ``InitialStateBuilder`` method gives a valid state in the
    Sz = 0 sector from which ``GroundStateSearch`` reaches the exact
    energy; 'from_file' reads the MPS of the JAX-written HDF5 file
    (``tests/export_import/data``), so a state of either package starts a
    run of the other."""
    from tenpy_tpu_torch.algorithms.exact_diag import ExactDiag
    from tenpy_tpu_torch.models.xxz_chain import XXZChain
    model_params = {'L': 4, 'Jxx': 1., 'Jz': 1., 'bc_MPS': 'finite'}
    init = {'method': method, 'product_state': [['up'], ['down']]}
    if method == 'mps_product_state':
        init['product_state'] = ['up', 'down', 'up', 'down']
    elif method == 'randomized':
        init['randomize_params'] = {'seed': 5}
    elif method == 'desired_bond_dimension':
        init['chi'] = 4
    elif method == 'from_file':
        init = {'method': method, 'filename': H5_FILES[0],
                'data_key': 'mps'}
    model = XXZChain(dict(model_params))
    from tenpy_tpu_torch.networks.mps import InitialStateBuilder
    psi = InitialStateBuilder(model.lat, dict(init)).run()
    assert isinstance(psi, MPS) and psi.L == 4
    assert np.max(psi.norm_test()) < 1e-12
    assert abs(np.sum(psi.expectation_value('Sz'))) < 1e-12
    res = sim.run_simulation(
        simulation_class='GroundStateSearch', model_class='XXZChain',
        model_params=model_params, initial_state_params=init,
        algorithm_params={'trunc_params': {'chi_max': 8, 'svd_min': 1e-12},
                          'max_E_err': 1e-12, 'mixer': False},
        log_params=tx.SIM_LOG, device='cpu')
    ed = ExactDiag(XXZChain(dict(model_params)), charge_sector=[0])
    E_ed, _ = ed.groundstate()
    assert abs(res['energy'] - E_ed) <= E_TOL * abs(E_ed)


def test_measurements(tmp_path):
    """The measurement functions a user connects, under their reference
    and JAX module names and their short aliases: bond energies summing to
    the energy, <Sz>, a psi method, a simulation method; on an infinite
    chain the correlation length."""
    params = json.loads(json.dumps(tx.SIM_GS_PARAMS))
    params['model_params']['L'] = 6
    params['connect_measurements'] = [
        ['tenpy.simulations.measurement', 'm_bond_energies'],
        ['tenpy_tpu.simulations.measurement', 'onsite_expectation_value',
         {'opname': 'Sz', 'key': 'Sz'}],
        ['psi_method', 'entanglement_entropy', {'key': 'S'}],
        ['simulation_method', 'get_version_info'],
        ['tenpy_tpu_torch.simulations.measurement', 'm_evolved_time']]
    res = sim.run_simulation(simulation_class='GroundStateSearch',
                             log_params=tx.SIM_LOG, device='cpu', **params)
    meas = res['measurements']
    assert abs(np.sum(meas['bond_energies'][-1]) - res['energy']) < 1e-10
    assert abs(np.sum(meas['Sz'][-1])) < 1e-12
    np.testing.assert_allclose(meas['S'][-1], meas['entropy'][-1])
    assert meas['get_version_info'][-1]['torch'] == torch.__version__
    assert 'evolved_time' not in meas and not res['errors_during_run']
    inf = {'model_class': 'TFIChain',
           'model_params': {'L': 2, 'J': 1., 'g': 1.5, 'bc_MPS': 'infinite',
                            'conserve': None},
           'initial_state_params': {'method': 'lat_product_state',
                                    'product_state': [['up']]},
           'algorithm_params': {'trunc_params': {'chi_max': 8},
                                'max_E_err': 1e-8},
           'connect_measurements': [['tenpy.simulations.measurement',
                                     'correlation_length']]}
    res = sim.run_simulation(simulation_class='GroundStateSearch',
                             log_params=tx.SIM_LOG, device='cpu', **inf)
    xi = res['measurements']['correlation_length'][-1]
    assert np.isfinite(xi) and 0 < xi < 10 and not res['errors_during_run']
