"""The whole slice on an infinite U(1)xU(1) Hubbard cylinder (iDMRG).

Fermi-Hubbard U=8 on the Ly=2, Lx=2 cylinder (the chi=256 chip workload's
model, narrower), from a Neel product state, through the uniform charge
gauge and ``uniform_capacity_layout``.  tenpy_tpu's engine and the port's
run 3 sweeps (mixer on, then settle) with ``backend='svd'`` and the same
options.

There is no Schmidt gap at this chi: after the second sweep the cut falls
inside near-degenerate multiplets, and which member survives is decided by
roundoff.  So the first update's E0 is held to 1e-12 relative and the first
two sweeps' update energies to 1e-10 (f64, summation order only), while the
third sweep is held to its truncation error; the Schmidt values of every
bond still agree to 1e-8 (measured: 3.5e-9).
"""
import numpy as np
import pytest
import torch

from tenpy_tpu.models.hubbard import FermiHubbardModel
from tenpy_tpu.networks.mps import MPS
from tenpy_tpu_torch.algorithms.packed_dmrg import DeviceSweepEngine
from tenpy_tpu_torch.networks import exchange

import torch_exchange as tx

torch.set_num_threads(1)

OPTS = {'chi_max': 24, 'svd_min': 1e-10, 'lanczos_K': 10, 'n_sweeps': 3,
        'multiple': 16, 'backend': 'svd', 'cap_factor': 4., 'n_hops': 2}


@pytest.fixture(scope='module')
def hubbard_case():
    m = FermiHubbardModel({'lattice': 'Square', 'Lx': 2, 'Ly': 2,
                           'bc_y': 'cylinder', 'bc_MPS': 'infinite',
                           't': 1., 'U': 8., 'mu': 0.})
    psi = MPS.from_product_state(m.lat.mps_sites(),
                                 ['up', 'down', 'down', 'up'], bc='infinite')
    ref, jeng = tx.jax_reference(psi, m, OPTS, 3)
    state = exchange.ExchangeState(tx.export_flat(psi, m, OPTS))
    eng = DeviceSweepEngine(state, OPTS, 'cpu')
    eng.run()
    return ref, jeng, eng


def test_idmrg_uses_uniform_layout(hubbard_case):
    _, jeng, eng = hubbard_case
    assert eng.state.gauge is not None
    assert len({id(b) for b in eng.bond}) == 1
    assert np.array_equal(eng.bond[0].slices, jeng.bond[0].slices)
    assert np.array_equal(eng.bond[0].charges, jeng.bond[0].charges)


def test_idmrg_sweeps_vs_jax(hubbard_case):
    ref, jeng, eng = hubbard_case
    st = eng.sweep_stats
    assert st['mode'] == ['f64'] * 3
    E0, E0_ref = np.asarray(st['update_E0']), ref['update_E0']
    assert abs(E0[0, 0] - E0_ref[0, 0]) <= 1e-12 * abs(E0_ref[0, 0])
    assert np.abs(E0[:2] - E0_ref[:2]).max() <= 1e-10
    assert np.abs(np.asarray(st['E'][:2]) - ref['sweep_E'][:2]).max() <= 1e-10
    # the early exit compares energy changes with 1e-14 |E|, at f64
    # roundoff: beyond the first sweep the step count may differ by one or two
    assert st['lanczos_iters'][0] == [int(x) for x in ref['lanczos_iters'][0]]
    assert abs(st['E'][2] - ref['sweep_E'][2]) <= st['max_err'][2]
    assert abs(st['max_err'][2] - ref['sweep_max_err'][2]) \
        <= 1e-6 * st['max_err'][2]
    for pS, jS in zip(eng.Sp, jeng.Sp):
        pS, jS = np.sort(pS.numpy())[::-1], np.sort(np.asarray(jS))[::-1]
        assert np.abs(pS - jS).max() <= 1e-8
