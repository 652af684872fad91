"""The whole slice: the port's DeviceSweepEngine against tenpy_tpu's.

Both engines start from the same state, a finite Fermi-Hubbard chain (L=6)
ramped by tenpy_tpu's host DMRG: ``tests/torch_exchange.py`` carries its B
and S over in the exchange format, and the port builds its own model, MPO
and environments from them.  Both use ``backend='svd'`` and the same
options, and both keep the same subspace (the exact regime: chi = 4**3),
so the sweep energies agree to 1e-10 and the Schmidt values to 1e-8 (f64;
LAPACK SVDs in both).
"""
import numpy as np
import pytest
import torch

from tenpy_tpu.algorithms import dmrg
from tenpy_tpu.models.hubbard import FermiHubbardChain as JChain
from tenpy_tpu.networks.mps import MPS as JMPS
from tenpy_tpu_torch.algorithms.packed_dmrg import DeviceSweepEngine
from tenpy_tpu_torch.models.hubbard import FermiHubbardChain
from tenpy_tpu_torch.networks import exchange

import torch_exchange as tx

torch.set_num_threads(1)

CHAIN = {'L': 6, 'bc_MPS': 'finite', 't': 1., 'U': 4., 'mu': 0.}


def _schmidt(S):
    S = np.asarray(S)
    return np.sort(S[S > 0])[::-1]


@pytest.fixture(scope='module')
def finite_case():
    """Hubbard chain, L=6, chi=64 = 4^3 (exact), 3 sweeps."""
    m = JChain(dict(CHAIN))
    psi = JMPS.from_product_state(m.lat.mps_sites(), ['up', 'down'] * 3)
    dmrg.TwoSiteDMRGEngine(psi, m, {
        'trunc_params': {'chi_max': 64, 'svd_min': 1e-12}, 'max_sweeps': 3,
        'mixer': True}).run()
    opts = {'chi_max': 64, 'svd_min': 1e-12, 'lanczos_K': 10, 'n_sweeps': 3,
            'multiple': 16, 'backend': 'svd', 'mixer': False}
    ref, jeng = tx.jax_reference(psi, m, opts, 3)
    flat = tx.export_flat(psi, m, opts)
    pm = FermiHubbardChain(dict(CHAIN))
    eng = DeviceSweepEngine(exchange.load_mps(flat, pm.lat.mps_sites()), pm,
                            opts, 'cpu')
    eng.run()
    return ref, jeng, eng, flat


def test_finite_sweeps_vs_jax(finite_case):
    ref, jeng, eng, _ = finite_case
    st = eng.sweep_stats
    assert st['mode'] == ['f64'] * 3
    assert np.abs(np.asarray(st['E']) - ref['sweep_E']).max() <= 1e-10
    assert np.abs(np.asarray(st['update_E0']) - ref['update_E0']).max() \
        <= 1e-10
    assert st['lanczos_iters'] == [list(x) for x in ref['lanczos_iters']]
    assert st['flops_exec'] == list(ref['flops_exec'])
    for pS, jS in zip(eng.Sp, jeng.Sp):
        p, j = _schmidt(pS.numpy()), _schmidt(jS)
        assert len(p) == len(j) and np.abs(p - j).max() <= 1e-8


def test_exchange_file_roundtrip(finite_case, tmp_path):
    """The .npz round trip keeps every array, and the engine's own
    export_state writes and reads back in the same format."""
    _, _, eng, flat = finite_case
    path = tmp_path / 'state.npz'
    exchange.save_flat(path, flat)
    back = exchange.load_flat(path)
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        assert np.array_equal(back[k], flat[k])
    st = exchange.ExchangeState(back)
    assert (st.bc, st.L, st.chi) == ('finite', 6, list(flat['meta.chi']))

    out = eng.export_state()
    exchange.save_flat(tmp_path / 'out.npz', out)
    got = exchange.load(tmp_path / 'out.npz')
    assert got.forms == ['A'] + ['B'] * (eng.L - 1)
    for i, S in enumerate(got.S):
        assert np.array_equal(np.sort(S)[::-1], _schmidt(eng.Sp[i].numpy()))
        assert abs(np.sum(S ** 2) - 1.) < 1e-12
    for i, B in enumerate(got.B):
        assert B.get_leg('vL').ind_len == len(got.S[i])
        assert B.get_leg('vR').ind_len == len(got.S[i + 1])
