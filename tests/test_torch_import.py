"""The PyTorch port imports neither JAX nor the JAX package."""
import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ['tenpy_tpu_torch', 'tenpy_tpu_torch._build',
           'tenpy_tpu_torch.linalg.charges',
           'tenpy_tpu_torch.linalg.host_array',
           'tenpy_tpu_torch.linalg.padding',
           'tenpy_tpu_torch.linalg.grouped_gemm',
           'tenpy_tpu_torch.linalg.packed',
           'tenpy_tpu_torch.linalg.packed_split',
           'tenpy_tpu_torch.algorithms.mps_common',
           'tenpy_tpu_torch.algorithms.packed_dmrg',
           'tenpy_tpu_torch.networks.exchange']


def test_port_imports_no_jax():
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
