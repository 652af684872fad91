"""The write-back: ``DeviceSweepEngine.run()`` ends in the caller's MPS.

* (g) Finite: a Hubbard chain (L=6) in the exact regime (chi = 4**3) from
  a product state.  ``run()`` returns ``(E, psi)`` with ``psi`` the
  caller's MPS; its energy by ``MPO.expectation_value`` (the full
  contraction) equals E within 1e-10, and (f) its entropies, ``Ntot``/``Sz``
  and energy equal ``tenpy_tpu``'s measurements of the same tensors.
* (h) Infinite, the port of ``tests/test_packed_dmrg.py:267``: a
  single-stage 8x chi growth (1 -> 8) on the ionic Hubbard chain of
  ``tests/torch_exchange.py`` (``WRITE_BACK_CASES``).  The seam drift
  before the re-gauge (``norm_test``, read by wrapping
  ``MPS.canonical_form``) stays below 1e-5, ``norm_test`` after it below
  1e-12; the TM energy is within 5e-8 of ``tenpy_tpu``'s for the same run
  (``tests/benchmark_data/hubbard_write_back_reference.npz``, written by
  ``python tests/torch_exchange.py --write-write-back``), and the caller
  gets back its charge frame and its ``Site`` objects.
* (i) ``device_ramp`` writes back once, at its last stage.
"""
import json
import os

import numpy as np
import pytest
import torch

from tenpy_tpu.models.hubbard import FermiHubbardChain as JChain
import tenpy_tpu_torch.networks.mps as mpsmod
from tenpy_tpu_torch.algorithms.packed_dmrg import DeviceSweepEngine, \
    device_ramp
from tenpy_tpu_torch.models.hubbard import FermiHubbardChain
from tenpy_tpu_torch.networks.mpo import MPOEnvironment
from tenpy_tpu_torch.networks.mps import MPS

import torch_exchange as tx

torch.set_num_threads(1)

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   'benchmark_data', 'hubbard_write_back_reference.npz')
CHAIN = {'L': 6, 'bc_MPS': 'finite', 't': 1., 'U': 4., 'mu': 0.}


def _check_caller_frame(psi, sites):
    """``psi`` holds the caller's ``Site`` objects, and every tensor's
    physical leg is its site's leg (not a rescaled or shifted copy)."""
    assert all(a is b for a, b in zip(psi.sites, sites))
    for i, site in enumerate(sites):
        p = psi.get_B(i, None).get_leg('p')
        assert np.array_equal(p.charges, site.leg.charges)
        assert np.array_equal(p.slices, site.leg.slices)
        assert p.qconj == site.leg.qconj
    assert psi.chinfo.names == sites[0].leg.chinfo.names


@pytest.fixture(scope='module')
def finite_run():
    m = FermiHubbardChain(dict(CHAIN))
    sites = m.lat.mps_sites()
    psi = MPS.from_product_state(sites, ['up', 'down'] * 3)
    eng = DeviceSweepEngine(psi, m, {
        'chi_max': 64, 'svd_min': 1e-12, 'lanczos_K': 10, 'n_sweeps': 4,
        'multiple': 16, 'backend': 'svd'}, 'cpu')
    E, psi_out = eng.run()
    return m, sites, psi, E, psi_out


def test_finite_write_back(finite_run):
    m, sites, psi, E, psi_out = finite_run
    assert psi_out is psi
    psi.test_sanity()
    _check_caller_frame(psi, sites)
    assert psi.chi[:2] == [4, 16] and max(psi.chi) <= 64   # no cut
    for i in range(psi.L - 1):
        psi.get_B(i, None).get_leg('vR').test_contractible(
            psi.get_B(i + 1, None).get_leg('vL'))
    # finite bc is not re-gauged (as in tenpy_tpu): each bond keeps the S of
    # its own update, which later updates move by their Lanczos residual
    # (measured 1.6e-9)
    assert np.max(psi.norm_test()) <= 1e-8
    full = MPOEnvironment(psi, m.H_MPO, psi).full_contraction(0)
    assert abs(full.imag) <= 1e-14
    assert abs(full.real - E) <= 1e-10 * abs(E)
    assert abs(m.H_MPO.expectation_value(psi) - E) <= 1e-10 * abs(E)


def test_finite_measurements_vs_jax(finite_run):
    m, _, psi, E, _ = finite_run
    jm = JChain(dict(CHAIN))
    jpsi = tx.mps_to_jax(psi, jm.lat.mps_sites())
    assert np.abs(psi.entanglement_entropy()
                  - jpsi.entanglement_entropy()).max() <= 1e-12
    a = psi.expectation_value(['Ntot', 'Sz'])
    assert np.abs(a - np.asarray(jpsi.expectation_value(['Ntot', 'Sz']))) \
        .max() <= 1e-12
    assert abs(np.sum(psi.expectation_value('Ntot')) - 6.) <= 1e-10
    jE = float(jm.H_MPO.expectation_value(jpsi))
    assert abs(m.H_MPO.expectation_value(psi) - jE) <= 1e-12 * abs(jE)


@pytest.fixture(scope='module')
def ref():
    from tenpy_tpu_torch.networks import exchange
    return exchange.load_flat(REF)


def test_infinite_write_back_health(ref):
    params, init, options = tx.WRITE_BACK_CASES['ionic']
    assert json.loads(str(ref['ionic.options'])) == options
    m = FermiHubbardChain(dict(params))
    sites = m.lat.mps_sites()
    psi = MPS.from_product_state(sites, init, bc='infinite')
    eng = DeviceSweepEngine(psi, m, dict(options), 'cpu')
    with tx.CanonicalFormProbe(mpsmod) as probe:
        E, psi_out = eng.run()
    assert psi_out is psi
    assert len(probe.before) == 1
    drift = probe.before[0]
    assert drift < 1e-5, f"seam drift {drift:.2e} above truncation scale"
    assert eng.write_back_stats['norm_test_before'] == drift
    assert max(psi.chi) == 8                # grown 8x from the product state
    _check_caller_frame(psi, sites)
    # the charge frame: the tensors' qtotal and the bond charges equal
    # tenpy_tpu's.  chi=8 cuts a (N=2, 2Sz=-2..2) multiplet, and which of
    # its Sz=+-1 members survives is decided by roundoff (the port kept
    # 2Sz=-2, tenpy_tpu +2): compare the bond charges up to the sign of Sz
    frame = tx.charge_frame(psi)
    assert np.array_equal(frame['qtotal'], ref['ionic.qtotal'])
    for i in range(psi.L):
        q, q_ref = frame[f'vL_q.{i}'], ref[f'ionic.vL_q.{i}']
        assert sorted(map(tuple, np.abs(q))) == \
            sorted(map(tuple, np.abs(q_ref)))
    got, _ = tx.measure_written_back(psi, m.H_MPO)
    assert got['norm_test_after'] <= 1e-12
    assert abs(got['tm_E'] - ref['ionic.tm_E']) <= 5e-8
    # the sweeps themselves, and what a user reads off the state.  The
    # roundoff choice in the cut multiplet (above) moves these at the
    # truncation scale: measured 3.6e-12 (TM energy), 2.4e-8 (Schmidt
    # values, entropies), 8.9e-10 (Ntot), 4.7e-9 (|Sz|; its sign flips).
    # The correlation length (0.35 sites: the subleading TM eigenvalue is
    # 3e-3, at the truncation scale) moves by 1.6%; it is compared on a
    # fixed state in test_torch_canonical.py
    assert np.abs(np.asarray(eng.sweep_stats['E'])
                  - ref['ionic.sweep_E']).max() <= 1e-8
    for k, tol in [('entropy', 1e-7), ('Ntot', 1e-8)]:
        assert np.abs(got[k] - ref[f'ionic.{k}']).max() <= tol, k
    assert np.abs(np.abs(got['Sz']) - np.abs(ref['ionic.Sz'])).max() <= 1e-8
    assert abs(np.sum(got['Sz'])) <= 1e-12
    for i in range(psi.L):
        assert np.abs(got[f'S.{i}'] - ref[f'ionic.S.{i}']).max() <= 1e-7


def test_device_ramp_writes_back_once_at_last_stage(monkeypatch):
    params, init, options = tx.WRITE_BACK_CASES['ionic']
    m = FermiHubbardChain(dict(params))
    sites = m.lat.mps_sites()
    psi = MPS.from_product_state(sites, init, bc='infinite')
    calls = []
    orig = DeviceSweepEngine.write_back

    def counted(self):
        calls.append((self, max(self.psi.chi)))
        return orig(self)

    monkeypatch.setattr(DeviceSweepEngine, 'write_back', counted)
    opts = {k: v for k, v in options.items()
            if k not in ('chi_max', 'n_sweeps')}
    eng = device_ramp(psi, m, dict(opts, chi_list=[[4, 1], [8, 2]]),
                      device='cpu')
    assert [s['chi'] for s in eng.stages] == [4, 8]
    assert len(calls) == 1 and calls[0][0] is eng
    assert calls[0][1] == 1        # psi was the product state until then
    assert eng.psi is psi and max(psi.chi) == 8
    _check_caller_frame(psi, sites)
    assert np.max(psi.norm_test()) <= 1e-12
    e_sweep = (eng.sweep_stats['E'][-1] - eng.sweep_stats['E'][-2]) / 4
    assert abs(m.H_MPO.expectation_value(psi) - e_sweep) <= 1e-6
