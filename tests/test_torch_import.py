"""The PyTorch port imports neither JAX nor the JAX package."""
import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ['tenpy_tpu_torch', 'tenpy_tpu_torch.__main__',
           'tenpy_tpu_torch._build',
           'tenpy_tpu_torch.tools', 'tenpy_tpu_torch.linalg',
           'tenpy_tpu_torch.networks', 'tenpy_tpu_torch.models',
           'tenpy_tpu_torch.algorithms',
           'tenpy_tpu_torch.tools.misc', 'tenpy_tpu_torch.tools.params',
           'tenpy_tpu_torch.tools.math', 'tenpy_tpu_torch.tools.events',
           'tenpy_tpu_torch.tools.cache', 'tenpy_tpu_torch.tools.process',
           'tenpy_tpu_torch.tools.thread', 'tenpy_tpu_torch.tools.io',
           'tenpy_tpu_torch.tools.prediction',
           'tenpy_tpu_torch.tools.spectral_function_tools',
           'tenpy_tpu_torch.linalg.charges',
           'tenpy_tpu_torch.linalg.np_conserved',
           'tenpy_tpu_torch.linalg.svd_robust',
           'tenpy_tpu_torch.linalg.jacobi_svd',
           'tenpy_tpu_torch.native',
           'tenpy_tpu_torch.linalg.sparse',
           'tenpy_tpu_torch.linalg.krylov_based',
           'tenpy_tpu_torch.linalg.random_matrix',
           'tenpy_tpu_torch.linalg.truncation',
           'tenpy_tpu_torch.linalg.padding',
           'tenpy_tpu_torch.linalg.grouped_gemm',
           'tenpy_tpu_torch.linalg.packed',
           'tenpy_tpu_torch.linalg.packed_split',
           'tenpy_tpu_torch.networks.site',
           'tenpy_tpu_torch.networks.charge_gauge',
           'tenpy_tpu_torch.networks.terms',
           'tenpy_tpu_torch.networks.mps',
           'tenpy_tpu_torch.networks.uniform_mps',
           'tenpy_tpu_torch.networks.purification_mps',
           'tenpy_tpu_torch.networks.momentum_mps',
           'tenpy_tpu_torch.networks.mpo',
           'tenpy_tpu_torch.networks.mpo_env_builder',
           'tenpy_tpu_torch.networks.exchange',
           'tenpy_tpu_torch.models.lattice',
           'tenpy_tpu_torch.models.model',
           'tenpy_tpu_torch.models.hubbard',
           'tenpy_tpu_torch.models.hofstadter',
           'tenpy_tpu_torch.models.spins',
           'tenpy_tpu_torch.models.tf_ising',
           'tenpy_tpu_torch.models.xxz_chain',
           'tenpy_tpu_torch.models.haldane',
           'tenpy_tpu_torch.models.fermions_spinless',
           'tenpy_tpu_torch.models.spins_nnn',
           'tenpy_tpu_torch.models.tj_model',
           'tenpy_tpu_torch.models.clock',
           'tenpy_tpu_torch.models.pxp',
           'tenpy_tpu_torch.models.aklt',
           'tenpy_tpu_torch.models.toric_code',
           'tenpy_tpu_torch.models.mixed_xk',
           'tenpy_tpu_torch.models.molecular',
           'tenpy_tpu_torch.algorithms.algorithm',
           'tenpy_tpu_torch.algorithms.mps_common',
           'tenpy_tpu_torch.algorithms.dmrg',
           'tenpy_tpu_torch.algorithms.packed_dmrg',
           'tenpy_tpu_torch.algorithms.tebd',
           'tenpy_tpu_torch.algorithms.packed_tebd',
           'tenpy_tpu_torch.algorithms.tdvp',
           'tenpy_tpu_torch.algorithms.mpo_evolution',
           'tenpy_tpu_torch.algorithms.exact_diag',
           'tenpy_tpu_torch.algorithms.vumps',
           'tenpy_tpu_torch.algorithms.disentangler',
           'tenpy_tpu_torch.algorithms.purification',
           'tenpy_tpu_torch.algorithms.plane_wave_excitation',
           'tenpy_tpu_torch.simulations',
           'tenpy_tpu_torch.simulations.measurement',
           'tenpy_tpu_torch.simulations.post_processing',
           'tenpy_tpu_torch.simulations.simulation',
           'tenpy_tpu_torch.simulations.time_evolution',
           'tenpy_tpu_torch.simulations.ground_state_search',
           'chip_smoke', 'profile_torch_sweep']


def test_port_imports_no_jax():
    """Every module of the port (the list covers every file of the
    package), the chip smoke and the profiler import neither JAX nor
    tenpy_tpu."""
    pkg = os.path.join(ROOT, 'tenpy_tpu_torch')
    on_disk = {os.path.relpath(os.path.join(d, f), ROOT)[:-3]
               .replace(os.sep, '.').removesuffix('.__init__')
               for d, _, files in os.walk(pkg) for f in files
               if f.endswith('.py')}
    assert on_disk <= set(MODULES), sorted(on_disk - set(MODULES))
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'tenpy_tpu' or "
            "m.startswith('tenpy_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == 'ok'


def test_segment_names_exported():
    """The segment simulations are exported (a parameter file's
    ``simulation_class`` finds them by name) and the segment methods
    exist on the lattice, model, MPO and MPS."""
    from tenpy_tpu_torch.models.lattice import Lattice
    from tenpy_tpu_torch.models.model import (Model, MPOModel,
                                              NearestNeighborModel)
    from tenpy_tpu_torch.networks.mpo import MPO
    from tenpy_tpu_torch.networks.mps import MPS
    from tenpy_tpu_torch.simulations import ground_state_search as gss
    from tenpy_tpu_torch.simulations.simulation import Simulation
    from tenpy_tpu_torch.tools.misc import find_subclass
    for name in ('OrthogonalExcitations', 'TopologicalExcitations',
                 'ExcitationInitialState'):
        assert name in gss.__all__
    assert find_subclass(Simulation, 'TopologicalExcitations') is \
        gss.TopologicalExcitations
    for cls in (Lattice, Model, MPOModel, NearestNeighborModel, MPO, MPS):
        assert callable(getattr(cls, 'extract_segment'))
    for meth in ('probability_per_charge', 'average_charge',
                 'charge_variance', 'get_total_charge'):
        assert callable(getattr(MPS, meth))


def test_new_models_found_by_name():
    """The momentum-space, dipolar and molecular models and XXZChain2 are
    found by their ``model_class`` name, as a parameter file names them."""
    import tenpy_tpu_torch.models  # noqa: F401  (loads every model)
    from tenpy_tpu_torch.models.model import Model
    from tenpy_tpu_torch.tools.misc import find_subclass
    for name in ('HubbardMixedXKSquare', 'SpinlessMixedXKSquare',
                 'MixedXKModel', 'DipolarSpinChain',
                 'DipolarBoseHubbardChain', 'MolecularModel', 'XXZChain2'):
        assert find_subclass(Model, name).__name__ == name
