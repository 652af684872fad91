"""The port's time-evolution simulations and command line against
``tenpy_tpu``'s.

``RealTimeEvolution`` from the repo's ``minimal_TDVP.yml``,
``minimal_TEBD.yml`` and ``minimal_ExpMPOEvolution.yml`` at
``model_params.L=8`` and ``SpectralSimulation`` from
``minimal_SpectralSimulation.yml`` run through the command line
(``console_main`` in this process, ``device=cpu``); the spectral run takes
its model and ground state from a results file holding JAX's ground state
of ``minimal_DMRG.yml`` at L=8.  Held to JAX's runs of the same files
(``tests/benchmark_data/time_evolution_reference.npz``; no JAX runs here):
``<Sz>`` and the evolved time at every measurement, the final state
(dense vector), ``max_chi``, the file's ``<Sp_i Sm_j>`` correlation, the
correlation ``C(t)`` and ``S(k, w)`` (JAX's from its
``spectral_function`` on its own ``C``: its post-processing does not read
the file's ``linear_predict``), all within 1e-10.  The three cases of
``tests/test_spectral_simulation.py:51-131`` (``TimeDependentCorrelation``,
``SpectralSimulation``, ``TimeDependentCorrelationEvolveBraKet`` on the
Ising chain L=6) held to JAX's and to exact evolution.  Then ``python -m
tenpy_tpu_torch`` in a subprocess, and the default device raising
without a card.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_exchange as tx
import tenpy_tpu_torch
from tenpy_tpu_torch.algorithms.exact_diag import ExactDiag
from tenpy_tpu_torch.models.tf_ising import TFIChain
from tenpy_tpu_torch.networks import exchange

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, 'tests', 'benchmark_data',
                   'time_evolution_reference.npz')
YAML = os.path.join(ROOT, 'examples', 'yaml')


@pytest.fixture(scope='module')
def ref():
    return exchange.load_flat(REF)


def _sub(ref, case):
    return {k: v for k, v in ref.items() if k.startswith(case + '.')}


def fidelity(a, b):
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


def close(a, b, tol=1e-10):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.max(np.abs(a - b)) <= tol * max(1., np.max(np.abs(b))), \
        np.max(np.abs(a - b))


@pytest.mark.parametrize('name', tx.TE_YAMLS)
def test_real_time_evolution_yaml_vs_jax(name, ref, tmp_path):
    """Each of the three RealTimeEvolution files: measurements, final state
    and bond dimensions as JAX's."""
    case = f'yaml_{name}'
    out = tx.te_case('torch', case, str(tmp_path))
    close(out[f'{case}.time'], ref[f'{case}.time'], 1e-14)
    close(out[f'{case}.Sz'], ref[f'{case}.Sz'])
    assert list(out[f'{case}.max_chi']) == list(ref[f'{case}.max_chi'])
    assert 1. - fidelity(out[f'{case}.v'], ref[f'{case}.v']) < 1e-10
    if name == 'TEBD':
        close(out[f'{case}.SpSm'], ref[f'{case}.SpSm'])


def test_spectral_simulation_yaml_vs_jax(ref, tmp_path):
    """``minimal_SpectralSimulation.yml`` from a ground-state file alone (no
    model in the file's options): C(t) and S(k, w) as JAX's, up to the norm
    of ``Sz|psi_0>`` (1/2), which the port keeps (as TeNPy) and
    ``tenpy_tpu`` drops."""
    case = 'yaml_Spectral'
    out = tx.te_case('torch', case, str(tmp_path), inputs=_sub(ref, case))
    close(out[f'{case}.time'], ref[f'{case}.time'], 1e-14)
    norm = 0.5                  # |Sz_c psi_0|: Sz^2 = 1/4 on spin 1/2
    close(out[f'{case}.C'] / norm, ref[f'{case}.C'])
    for k in ('k', 'w'):
        close(out[f'{case}.S.{k}'], ref[f'{case}.S.{k}'])
    close(out[f'{case}.S.spectral_function'] / norm,
          ref[f'{case}.S.spectral_function'])
    assert np.isfinite(out[f'{case}.S.spectral_function']).all()


def exact_correlation(vec, E0, op_name, i0, times, L=6):
    """``e^{i E0 t} <psi| op_j e^{-iHt} op_{i0} |psi>`` by the port's
    ``ExactDiag`` in its pipe basis (the ground state's own)."""
    m = TFIChain(dict(tx.TE_SPEC_TFI))
    ed = ExactDiag(m)
    ed.full_diagonalization()
    H = ed.full_H.to_numpy()
    w, v = np.linalg.eigh(H)
    perm = ed._pipe_order()
    site = m.lat.mps_sites()[0]
    op = site.get_op(op_name).to_numpy()

    def full_op(i):
        mats = [np.eye(2)] * L
        mats[i] = op
        return functools.reduce(np.kron, mats)[np.ix_(perm, perm)]

    phi0 = full_op(i0) @ vec
    res = []
    for t in times:
        phi_t = v @ (np.exp(-1j * w * t) * (v.conj().T @ phi0))
        res.append([np.exp(1j * E0 * t) * np.vdot(vec, full_op(j) @ phi_t)
                    for j in range(L)])
    return np.array(res)


@pytest.mark.parametrize('case', ['tdc', 'spectral', 'braket'])
def test_correlations_vs_jax_and_exact(case, ref, tmp_path):
    """The cases of tests/test_spectral_simulation.py: C(t) within 1e-10 of
    JAX's; the single-sided and bra-ket correlations within JAX's test
    tolerances of exact evolution and of each other; S(k, w) as JAX's,
    one momentum per site."""
    out = tx.te_case('torch', case, str(tmp_path), inputs=_sub(ref, case))
    close(out[f'{case}.C'], ref[f'{case}.C'])
    close(out[f'{case}.time'], ref[f'{case}.time'], 1e-14)
    vec, E0 = ref[f'{case}.gs_vec'], float(ref[f'{case}.gs_vec_E'])
    if case == 'spectral':
        S = out['spectral.S.spectral_function']
        close(S, ref['spectral.S.spectral_function'])
        assert S.shape[1] == 6 and np.sum(np.abs(S)) > 0
        return
    exact = exact_correlation(vec, E0, 'Sigmaz', 3, out[f'{case}.time'])
    tol = 1e-5 if case == 'tdc' else 1e-5 + 1e-6
    assert np.max(np.abs(out[f'{case}.C'] - exact)) < tol


def test_cli_subprocess(tmp_path):
    """``python -m tenpy_tpu_torch minimal_TDVP.yml -o device=cpu -o
    model_params.L=8`` (cut to one measurement) in a subprocess writes its
    results."""
    fn = os.path.join(str(tmp_path), 'tdvp.pkl')
    res = subprocess.run(
        [sys.executable, '-m', 'tenpy_tpu_torch',
         os.path.join(YAML, 'minimal_TDVP.yml'), '-o', 'device=cpu', '-o',
         'model_params.L=8', '-o', 'final_time=0.1', '-o',
         f'output_filename={fn}', '-o',
         "log_params={'to_stdout': None, 'to_file': None}"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    from tenpy_tpu_torch.tools import io
    data = io.load(fn)
    assert data['finished_run']
    assert abs(data['measurements']['evolved_time'][-1] - 0.1) < 1e-12
    assert len(data['measurements']['<Sz>'][-1]) == 8


@pytest.mark.parametrize('name', ['TDVP', 'TEBD', 'ExpMPOEvolution'])
def test_cli_default_device_raises(name):
    """Without ``-o device=cpu`` each file asks for the card and raises
    here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tenpy_tpu_torch.console_main(
            [os.path.join(YAML, f'minimal_{name}.yml'), '-o',
             'model_params.L=8', '-o', 'output_filename=None'])
