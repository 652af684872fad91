"""The port's host TEBD engines against ``tenpy_tpu``'s and exact
evolution.

The cases of ``tests/test_tebd.py:69-148`` run through the port's
``TEBDEngine``, ``QRBasedTEBDEngine`` and ``RandomUnitaryEvolution`` on
the CPU: the imaginary-time ground state of the Ising chain L=8 (parity)
and of the infinite chain (L=2), real time at orders 1, 2 and 4 and the
QR-based engine on the XXZ chain L=6, and random unitaries from one seed
in both packages.  Final states are held to ``tenpy_tpu``'s (dense
vectors, 1e-10), energies to JAX's (1e-10) and to the exact answers as in
the JAX tests.  JAX's values come from
``tests/benchmark_data/time_evolution_reference.npz``.
"""
import os

import numpy as np
import pytest
import scipy.integrate
import torch

import torch_exchange as tx
from tenpy_tpu_torch.algorithms import tebd
from tenpy_tpu_torch.algorithms.exact_diag import ExactDiag
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


def test_tebd_imaginary_gs(ref, tmp_path):
    """The Ising chain's ground state by imaginary time: the energy within
    1e-10 of JAX's run and 1e-5 of exact diagonalization, the state within
    1e-10 of JAX's."""
    out = tx.te_case('torch', 'tebd_imag', str(tmp_path))
    E = float(out['tebd_imag.E'])
    assert abs(E - float(ref['tebd_imag.E'])) < 1e-10
    np.testing.assert_allclose(out['tebd_imag.E_bonds'],
                               ref['tebd_imag.E_bonds'], rtol=0, atol=1e-10)
    assert 1. - fidelity(out['tebd_imag.v'], ref['tebd_imag.v']) < 1e-10
    ed = ExactDiag.from_H_mpo(tx.bond_model(tx._TE('torch'), 'tfi',
                                            8).H_MPO)
    E_exact, _ = ed.groundstate()
    assert abs(E - E_exact) < 1e-5


@pytest.mark.parametrize('order', [1, 2, 4])
def test_tebd_real_time(order, ref, tmp_path):
    """Real time at order 1, 2, 4: the state within 1e-10 of JAX's and
    within the JAX test's tolerance of exact evolution."""
    case = f'tebd_real_{order}'
    out = tx.te_case('torch', case, str(tmp_path))
    v = out[f'{case}.v']
    assert 1. - fidelity(v, ref[f'{case}.v']) < 1e-10
    assert abs(np.linalg.norm(v) - 1.) < 1e-10
    ed = ExactDiag.from_H_mpo(tx.bond_model(tx._TE('torch'), 'xxz',
                                            6).H_MPO)
    exact = ed.exp_H(0.4).to_numpy() @ out[f'{case}.v0']
    assert 1. - fidelity(exact, v) < {1: 1e-2, 2: 1e-4, 4: 1e-6}[order]


def test_itebd_gs(ref, tmp_path):
    """The infinite Ising chain by imaginary time: bond energies within
    1e-10 of JAX's, the mean within 1e-5 of the exact energy density."""
    out = tx.te_case('torch', 'itebd', str(tmp_path))
    E = out['itebd.E_bonds']
    np.testing.assert_allclose(E, ref['itebd.E_bonds'], rtol=0, atol=1e-10)
    g = 1.5
    e_exact = -scipy.integrate.quad(
        lambda k: np.sqrt(1. + g ** 2 - 2. * g * np.cos(k)) / np.pi, 0,
        np.pi)[0]
    assert abs(np.mean(E) - e_exact) < 1e-5


def test_qr_based_tebd(ref, tmp_path):
    """The QR-based engine: within 1e-10 of JAX's state, 1e-4 of exact."""
    out = tx.te_case('torch', 'tebd_qr', str(tmp_path))
    v = out['tebd_qr.v']
    assert 1. - fidelity(v, ref['tebd_qr.v']) < 1e-10
    ed = ExactDiag.from_H_mpo(tx.bond_model(tx._TE('torch'), 'xxz',
                                            6).H_MPO)
    exact = ed.exp_H(0.2).to_numpy() @ out['tebd_qr.v0']
    assert 1. - fidelity(exact, v) < 1e-4


def test_random_unitary_evolution(ref, tmp_path):
    """Random unitaries from one numpy seed: the same gates as JAX's, so
    the same state (1e-10); normalized, total Sz conserved."""
    out = tx.te_case('torch', 'random_unitary', str(tmp_path))
    v = out['random_unitary.v']
    assert 1. - fidelity(v, ref['random_unitary.v']) < 1e-10
    assert list(out['random_unitary.chi']) == \
        list(ref['random_unitary.chi'])
    assert max(out['random_unitary.chi']) > 1
    assert abs(np.linalg.norm(v) - 1.) < 1e-10
    from tenpy_tpu_torch.networks.mps import MPS
    from tenpy_tpu_torch.networks.site import SpinHalfSite
    psi = MPS.from_product_state([SpinHalfSite('Sz')] * 6,
                                 ['up', 'down'] * 3)
    tebd.RandomUnitaryEvolution(psi, {'N_steps': 2, 'seed': 1,
                                      'trunc_params': {'chi_max': 8}}).run()
    assert abs(psi.overlap(psi) - 1.) < 1e-10
    assert abs(psi.expectation_value('Sz').sum()) < 1e-10


def test_trotter_static_methods():
    """The engine's static Trotter tables are the module's functions."""
    eng = tebd.TEBDEngine
    for order in (1, 2, 4, '4_opt'):
        assert eng.suzuki_trotter_time_steps(order) == \
            tebd.suzuki_trotter_time_steps(order)
        assert eng.suzuki_trotter_decomposition(order, 3) == \
            tebd.suzuki_trotter_decomposition(order, 3)
