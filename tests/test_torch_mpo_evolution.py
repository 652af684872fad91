"""The port's MPO time evolution, MPO application and compression against
``tenpy_tpu``'s.

The W_I and W_II tensors of ``make_U_I`` / ``make_U_II`` (XXZ chain L=6)
equal JAX's; the cases of ``tests/test_mpo_evolution.py:11-31``
(``ExpMPOEvolution`` with W_I and W_II at orders 1 and 2, zip-up) and of
``tests/test_compression.py:4`` (variational MPO application, SVD- and
QR-based) run through the port on the CPU; ``MPO.apply`` by 'SVD',
'zip_up' and 'variational' with truncation, and ``MPO.variance``, on the
Ising chain's ground state (JAX's, as a dense vector, made an MPS by
``ExactDiag.full_to_mps`` in the port).  States are held to JAX's (dense
vectors, 1e-10) and to exact evolution as in the JAX tests.  JAX's values
come from ``tests/benchmark_data/time_evolution_reference.npz``.
"""
import os

import numpy as np
import pytest
import torch

import torch_exchange as tx
from tenpy_tpu_torch.algorithms.exact_diag import ExactDiag
from tenpy_tpu_torch.models.xxz_chain import XXZChain
from tenpy_tpu_torch.networks import exchange

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, 'tests', 'benchmark_data',
                   'time_evolution_reference.npz')


@pytest.fixture(scope='module')
def ref():
    return exchange.load_flat(REF)


def fidelity(a, b):
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


def test_make_U_vs_jax(ref, tmp_path):
    """Every W_I and W_II tensor (real and imaginary time) equal to JAX's
    (1e-14)."""
    out = tx.te_case('torch', 'make_U', str(tmp_path))
    keys = [k for k in ref if k.startswith('make_U.')]
    assert sorted(keys) == sorted(out)
    for k in keys:
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-14,
                                   err_msg=k)


@pytest.mark.parametrize('approximation, order, tol', [
    ('I', 1, 5e-2), ('II', 1, 5e-3), ('II', 2, 1e-4)])
def test_expmpo_evolution(approximation, order, tol, ref, tmp_path):
    """The state within 1e-10 of JAX's, within the JAX test's tolerance of
    exact evolution."""
    case = f'expmpo_{approximation}_{order}'
    out = tx.te_case('torch', case, str(tmp_path))
    v = out[f'{case}.v']
    assert 1. - fidelity(v, ref[f'{case}.v']) < 1e-10
    assert abs(np.linalg.norm(v) - np.linalg.norm(ref[f'{case}.v'])) < 1e-10
    ed = ExactDiag(XXZChain(dict(tx.TE_XXZ)))
    exact = ed.exp_H(0.3).to_numpy() @ out[f'{case}.v0']
    assert 1. - fidelity(exact, v) < tol


def test_qr_based_variational_apply_mpo(ref, tmp_path):
    """The QR-based variational application agrees with the SVD-based one
    (1e-10), and both with JAX's."""
    out = tx.te_case('torch', 'qr_variational', str(tmp_path),
                     inputs={k: v for k, v in ref.items()
                             if k.startswith('qr_variational.psi_vec')})
    a, b = out['qr_variational.a'], out['qr_variational.b']
    assert 1. - fidelity(a, b) < 1e-10
    for key in ('a', 'b'):
        assert 1. - fidelity(out[f'qr_variational.{key}'],
                             ref[f'qr_variational.{key}']) < 1e-10
    for key in ('Ea', 'Eb'):
        assert abs(float(out[f'qr_variational.{key}'])
                   - float(ref[f'qr_variational.{key}'])) < 1e-10
    assert abs(float(out['qr_variational.Ea'])
               - float(out['qr_variational.Eb'])) < 1e-10


def test_mpo_apply_and_variance(ref, tmp_path):
    """``MPO.apply`` by each compression method, truncated to chi=12: the
    state within 1e-10 of JAX's and the truncation error within 1e-10;
    ``variance`` within 1e-10 of JAX's."""
    out = tx.te_case('torch', 'apply', str(tmp_path),
                     inputs={k: v for k, v in ref.items()
                             if k.startswith('apply.psi_vec')})
    for meth in tx.TE_APPLY_METHODS:
        v, v_ref = out[f'apply.{meth}.v'], ref[f'apply.{meth}.v']
        assert 1. - fidelity(v, v_ref) < 1e-10, meth
        assert abs(np.linalg.norm(v) - np.linalg.norm(v_ref)) < 1e-10, meth
        assert abs(float(out[f'apply.{meth}.eps'])
                   - float(ref[f'apply.{meth}.eps'])) < 1e-10, meth
    assert abs(float(out['apply.variance'])
               - float(ref['apply.variance'])) < 1e-10
