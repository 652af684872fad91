"""The port's ``device_ramp`` and engine setup against ``tenpy_tpu``.

``tenpy_tpu``'s ramp compiles one XLA program per site update and stage
(about a minute each case on the CPU), so its results are committed in
``tests/benchmark_data/hubbard_ramp_reference.npz``; ``tests/torch_exchange.py``
writes them (``--write-ramps``, see its docstring).  The port runs the same
cases on the CPU:

* a finite Hubbard chain (L=4) in the exact regime (stages at chi 16 = 4**2,
  the full middle bond, and 32): every sweep energy within 1e-10 of JAX's,
  Schmidt values within 1e-8;
* a small infinite ramp (Ly=2 cylinder, chi 2 -> 4): the cuts fall inside
  near-degenerate multiplets from the second stage on, and which member
  survives is decided by roundoff, so the sweep energies are held to 1e-6
  relative (measured 3.2e-7) and the first stage's to 1e-10.

Last, the engine's own setup on the committed chi=256 state (B and S of the
exchange file, the port's model): the packed W equal to the file's, the
environments within 1e-10 of their largest entry (measured 8.6e-13; the
file's come from ``tenpy_tpu``'s Arnoldi route, the port's from its GMRES
builder), and the same charge gauge.
"""
import json
import os

import numpy as np
import torch

from tenpy_tpu_torch.algorithms.packed_dmrg import DeviceSweepEngine, \
    device_ramp
from tenpy_tpu_torch.linalg import packed as pk
from tenpy_tpu_torch.models.hubbard import FermiHubbardModel
from tenpy_tpu_torch.networks import exchange

import torch_exchange as tx

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    'benchmark_data')
REF = exchange.load_flat(os.path.join(DATA, 'hubbard_ramp_reference.npz'))


def _ramp(case):
    assert json.loads(str(REF[f'{case}.options'])) == tx.RAMP_CASES[case][2]
    m, psi = tx.ramp_model(case, 'tenpy_tpu_torch')
    eng = device_ramp(psi, m, dict(tx.RAMP_CASES[case][2]), device='cpu')
    return eng, np.asarray(eng.sweep_stats['E']), REF[f'{case}.sweep_E']


def _schmidt(S):
    S = S.numpy()
    return np.sort(S[S > 0])[::-1]


def test_device_ramp_exact_regime_vs_jax():
    eng, E, E_ref = _ramp('finite')
    assert [s['chi'] for s in eng.stages] == [16, 32]
    assert len(E) == len(E_ref)
    assert np.abs(E - E_ref).max() <= 1e-10
    for i, S in enumerate(eng.Sp):
        ref = REF[f'finite.S.{i}']
        p = _schmidt(S)
        assert len(p) == len(ref) and np.abs(p - ref).max() <= 1e-8


def test_device_ramp_infinite_vs_jax():
    eng, E, E_ref = _ramp('infinite')
    assert [s['chi'] for s in eng.stages] == [2, 4]
    assert len(E) == len(E_ref)
    assert abs(E[0] - E_ref[0]) <= 1e-10 * abs(E_ref[0])
    assert (np.abs(E - E_ref) / np.abs(E_ref)).max() <= 1e-6
    assert all(int((S > 0).sum()) == 4 for S in eng.Sp)


def test_engine_setup_chi256_vs_exchange_file():
    flat = exchange.load_flat(os.path.join(
        DATA, 'hubbard_cyl_chi256_exchange.npz'))
    st = exchange.ExchangeState(flat)
    m = FermiHubbardModel({'lattice': 'Square', 'Lx': 2, 'Ly': 4,
                           'bc_y': 'cylinder', 'bc_MPS': 'infinite',
                           't': 1., 'U': 8., 'mu': 0.})
    psi = exchange.load_mps(flat, m.lat.mps_sites())
    eng = DeviceSweepEngine(psi, m, json.loads(str(st.reference['options'])),
                            'cpu')
    assert np.array_equal(eng.gauge['k'], st.gauge['k'])
    assert all(np.array_equal(a, b) for a, b in zip(eng.gauge['o'],
                                                   st.gauge['o']))
    for i in range(eng.L):
        tx.assert_packed_close(eng.Wp[i], pk.pack(st.W[i], pad=False,
                                                  device='cpu'), rtol=0.)
    tx.assert_packed_close(eng.LPp[0], eng._pack_env(st.LP0, 0, 'L'),
                           rtol=1e-10)
    for i in range(eng.L):
        tx.assert_packed_close(eng.RPp[i],
                               eng._pack_env(st.RP[i], (i + 1) % eng.L, 'R'),
                               rtol=1e-10)
    # the engine left the caller's MPS in its own charge frame
    assert psi.get_B(0, None).qtotal == (8, 0)
