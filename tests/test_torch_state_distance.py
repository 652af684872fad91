"""How far the port's written-back states are from ``tenpy_tpu``'s, and
whether the correlation length's Arnoldi is converged.

* The distance ``|1 - |<psi_port|psi_JAX>||`` between the state that
  ``DeviceSweepEngine.run()`` writes back and the one ``tenpy_tpu``'s engine
  writes back from the same start (``tests/benchmark_data/
  written_back_states.npz``, written by ``python tests/torch_exchange.py
  --write-states``): per unit cell (the dominant eigenvalue of the mixed
  transfer matrix) for the ionic Hubbard chain of
  ``tests/test_torch_write_back.py``, and the full overlap for the finite
  Hofstadter case of ``tests/test_torch_hofstadter.py``.
* The correlation length of one committed state (the chi=256 Hubbard
  cylinder of the exchange file) by both packages, with the 20-step Arnoldi
  of ``correlation_length`` and with a converged one.
"""
import os

import numpy as np
import pytest
import torch

from tenpy_tpu.models.hubbard import FermiHubbardModel as JModel
from tenpy_tpu.networks import mps as jmps
from tenpy_tpu_torch.algorithms.packed_dmrg import DeviceSweepEngine
from tenpy_tpu_torch.models.hubbard import FermiHubbardChain, \
    FermiHubbardModel
from tenpy_tpu_torch.networks import exchange
from tenpy_tpu_torch.networks.mps import MPS, TransferMatrix

import torch_exchange as tx

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    'benchmark_data')
STATES = os.path.join(DATA, 'written_back_states.npz')
CHI256 = os.path.join(DATA, 'hubbard_cyl_chi256_exchange.npz')
CYLINDER = {'lattice': 'Square', 'Lx': 2, 'Ly': 4, 'bc_y': 'cylinder',
            'bc_MPS': 'infinite', 't': 1., 'U': 8., 'mu': 0.}


def _distances(bra, ket):
    """``|1 - |eta||`` of the mixed transfer matrix acting to the right and
    to the left (they agree to the eigensolver's accuracy for a non-normal
    operator: measured 6.4e-10 apart)."""
    d = [abs(1. - abs(TransferMatrix(bra, ket, transpose=t).eigenvectors(
        which='LM')[0][0])) for t in (False, True)]
    assert abs(d[0] - d[1]) <= 1e-8
    return d


@pytest.fixture(scope='module')
def ionic():
    """The port's write-back of the ionic chain, JAX's, and the port's
    engine."""
    states = exchange.load_flat(STATES)
    ref = exchange.load_flat(os.path.join(
        DATA, 'hubbard_write_back_reference.npz'))
    assert float(states['ionic.tm_E']) == float(ref['ionic.tm_E'])
    params, init, options = tx.WRITE_BACK_CASES['ionic']
    m = FermiHubbardChain(dict(params))
    psi = MPS.from_product_state(m.lat.mps_sites(), init, bc='infinite')
    eng = DeviceSweepEngine(psi, m, dict(options), 'cpu')
    eng.run()
    jpsi = tx.load_state(states, 'ionic.psi', m.lat.mps_sites())
    return psi, jpsi, eng, m


def test_ionic_written_back_state_distance(ionic):
    """The ionic chain at chi=8 (6 sweeps, cut inside a degenerate
    multiplet): the states are ``tenpy_tpu``'s to the truncation scale.
    Measured on one thread: ``3.75e-7`` per unit cell against a truncation
    error of ``3.94e-7`` per update in the last sweep (the port keeps the
    other member of the cut multiplet), while the TM energies agree to
    ``3.9e-12``: the distance is the weight of the cut multiplet, not a
    fault."""
    psi, jpsi, eng, m = ionic
    assert abs(psi.overlap(psi) - 1.) <= 1e-12
    assert abs(jpsi.overlap(jpsi) - 1.) <= 1e-12
    d = _distances(psi, jpsi)
    assert abs(1. - abs(psi.overlap(jpsi))) == d[0]
    assert max(d) <= 2. * eng.sweep_stats['max_err'][-1], d
    assert abs(m.H_MPO.expectation_value(psi)
               - m.H_MPO.expectation_value(jpsi)) <= 1e-10


def test_hofstadter_finite_written_back_state_distance():
    """The finite Hofstadter case (complex, chi=16 >= 2**3: exact): the
    port's written-back state is JAX's up to a global phase, ``|1 - |<.|.>||
    = 1.1e-16`` measured."""
    states = exchange.load_flat(STATES)
    m, psi = tx.hofstadter_model('finite', 'tenpy_tpu_torch')
    E, _ = DeviceSweepEngine(psi, m, dict(tx.HOFSTADTER_CASES['finite'][2]),
                             'cpu').run()
    assert abs(E - float(states['hofstadter_finite.E'])) <= 1e-10
    jpsi = tx.load_state(states, 'hofstadter_finite.psi', m.lat.mps_sites())
    assert psi.dtype == jpsi.dtype == torch.complex128
    assert abs(1. - abs(psi.overlap(jpsi))) <= 1e-12
    assert abs(psi.overlap(psi) - 1.) <= 1e-12


def test_correlation_length_arnoldi_converged():
    """The correlation length's Arnoldi (both packages: it stops once the
    dominant eigenpair has converged) leaves the subleading eigenvalue
    unconverged.  On the committed chi=256 cylinder state both packages
    give 3.158894 by default, equal to roundoff, and 3.181588 with 30 and
    45 forced steps (7.2e-3 apart): so the correlation lengths of two
    written-back states differ where their stopping steps do (the ionic
    states below: 1.6% by default, 2.2e-5 converged)."""
    m = FermiHubbardModel(dict(CYLINDER))
    psi = exchange.load_mps(CHI256, m.lat.mps_sites())
    jpsi = tx.mps_to_jax(psi, JModel(dict(CYLINDER)).lat.mps_sites())
    default = psi.correlation_length()
    assert abs(default - jpsi.correlation_length()) <= 1e-12 * default
    xi = psi.correlation_length(N_min=30, N_max=30)
    etas, _ = jmps.TransferMatrix(jpsi, jpsi).eigenvectors(
        num_ev=3, which='LM', N_min=30, N_max=30)
    assert abs(xi + psi.L / np.log(np.abs(etas[1]))) <= 1e-12 * xi
    assert abs(xi - psi.correlation_length(N_min=45, N_max=45)) <= 1e-12 * xi
    assert abs(default - xi) > 5e-3 * xi


def test_ionic_correlation_length_converged(ionic):
    """By default the correlation lengths of the port's and JAX's ionic
    write-backs are 1.6% apart (0.35317 and 0.35904, measured); converged,
    they agree to 2.2e-5 (their state distance is 3.75e-7 per cell and the
    subleading eigenvalue, 3.7e-3, sits at the truncation scale)."""
    psi, jpsi = ionic[:2]
    default = [p.correlation_length() for p in (psi, jpsi)]
    xi = [p.correlation_length(N_min=30, N_max=30) for p in (psi, jpsi)]
    assert abs(default[0] - default[1]) > 1e-2 * default[1]
    assert abs(xi[0] - xi[1]) <= 1e-4 * xi[1]
