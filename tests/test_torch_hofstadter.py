"""The Hofstadter model on the port's complex128 device path, against
``tenpy_tpu``.

* ``FermionSite`` and the Hofstadter MPO (both gauges, finite and infinite)
  equal ``tenpy_tpu``'s bit for bit; the MPO is complex128.
* Finite, the port of ``tests/test_packed_dmrg.py:204``: Lx=3, Ly=2 at
  chi=16 >= 2**3 (exact) from the product state.  The energy of the run
  and the full contraction of the written-back state equal ``tenpy_tpu``'s
  engine and its host DMRG to 1e-10.  (On a Ly=2 cylinder the two y bonds
  of a column carry opposite phases, so this case's physics is real; the
  infinite case below is the genuinely complex one.)
* Infinite: the Lx=3, Ly=3 cylinder at 1/3 filling (Q=3 on L=9 sites), so
  the engine takes the charge-unit rescale (k=3) of the uniform gauge.  At
  chi=16 the first sweep's updates are exact (1e-10 relative) and the
  sweep energies agree to 1e-10 relative (measured 1e-14); the written-back
  state is complex128 with a nonzero imaginary part, canonical
  (``norm_test`` < 1e-12), in the caller's charge frame, with N = 3 per
  cell to 1e-12; its TM energy agrees with ``tenpy_tpu``'s to 1e-9
  relative, entropies and ``N`` to 1e-6 (two states whose energies agree
  to 1e-14 differ at 1e-8, as energies are second order in the state:
  measured 1e-8), the correlation length to 2e-3 relative (both take 20
  Arnoldi steps for the subleading eigenvalue: measured 2.7e-5, while
  two ``tenpy_tpu`` runs of this case, compiled and op by op, differ by
  6.8e-4).
* The complex packed matvec and Lanczos on that run's operands against
  ``tenpy_tpu``'s split-channel ones: matvec 1e-12, energy 1e-10, ground
  vector up to its phase 1e-10.
* The exchange format: the engine's complex state saves and loads, S stays
  float64, and the rescaled charge gauge (k=3) is undone on load.

The JAX values come from ``tests/benchmark_data/hofstadter_reference.npz``
(``python tests/torch_exchange.py --write-hofstadter``); the JAX engine
does not run here.
"""
import json
import os

import numpy as np
import pytest
import torch

from tenpy_tpu.algorithms.mps_common import _lanczos_K_2site_packed_impl \
    as j_lanczos
from tenpy_tpu.linalg import packed as jpk
from tenpy_tpu.models.hofstadter import HofstadterFermions as JHof
from tenpy_tpu.networks.site import FermionSite as JFermionSite
from tenpy_tpu_torch.algorithms.mps_common import \
    _lanczos_K_2site_packed_impl, _matvec_2site_packed
from tenpy_tpu_torch.algorithms.packed_dmrg import DeviceSweepEngine
from tenpy_tpu_torch.linalg import packed as pk
from tenpy_tpu_torch.linalg import packed_split as ps
from tenpy_tpu_torch.models.hofstadter import HofstadterFermions
from tenpy_tpu_torch.networks import exchange
from tenpy_tpu_torch.networks.site import FermionSite

import torch_exchange as tx

torch.set_num_threads(1)

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   'benchmark_data', 'hofstadter_reference.npz')


@pytest.fixture(scope='module')
def ref():
    flat = exchange.load_flat(REF)
    for case in ('finite', 'infinite'):
        params, _, options = tx.HOFSTADTER_CASES[case]
        assert json.loads(str(flat[f'{case}.options'])) == options
        assert json.loads(str(flat[f'{case}.model'])) == json.loads(
            json.dumps(params))
    return flat


def _array_equal(p, j):
    assert p.qtotal == tuple(j.qtotal)
    assert p.get_leg_labels() == tuple(j.get_leg_labels())
    for lp, lj in zip(p.legs, j.legs):
        assert np.array_equal(lp.slices, lj.slices)
        assert np.array_equal(lp.charges, lj.charges)
        assert lp.qconj == lj.qconj
    assert np.array_equal(p._qdata, j._qdata)
    for x, y in zip(p._data, j._data):
        assert np.array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize('conserve', ['N', 'parity', None])
def test_fermion_site_vs_jax(conserve):
    site, jsite = FermionSite(conserve), JFermionSite(conserve)
    assert site.opnames == jsite.opnames
    assert site.need_JW_string == jsite.need_JW_string
    assert site.hc_ops == jsite.hc_ops
    assert site.state_labels == jsite.state_labels
    for name in sorted(jsite.opnames) + ['Cd JW']:
        _array_equal(site.get_op(name), jsite.get_op(name))
    assert site.get_hc_op_name('Cd JW') == jsite.get_hc_op_name('Cd JW')


@pytest.mark.parametrize('params', [
    tx.HOFSTADTER_MODEL,
    dict(tx.HOFSTADTER_CASES['finite'][0], gauge='landau_y', v=0.3)])
def test_hofstadter_mpo_vs_jax(params):
    H, jH = HofstadterFermions(dict(params)).H_MPO, \
        JHof(dict(params)).H_MPO
    assert H.dtype == torch.complex128
    assert (H.L, H.bc, H.max_range) == (jH.L, jH.bc, jH.max_range)
    assert H.IdL == jH.IdL and H.IdR == jH.IdR
    for i in range(H.L):
        assert H.get_W(i).dtype == getattr(torch, str(jH.get_W(i).dtype))
        _array_equal(H.get_W(i), jH.get_W(i))
    assert max(float(b.imag.abs().max()) for i in range(H.L)
               for b in H.get_W(i)._data if b.is_complex()) > 0.5


def _run(case):
    m, psi = tx.hofstadter_model(case, 'tenpy_tpu_torch')
    sites = list(psi.sites)
    eng = DeviceSweepEngine(psi, m, dict(tx.HOFSTADTER_CASES[case][2]),
                            'cpu')
    E, psi_out = eng.run()
    assert psi_out is psi
    return m, sites, eng, E


def test_finite_sweep_vs_jax(ref):
    m, sites, eng, E = _run('finite')
    psi = eng.psi
    assert psi.dtype == torch.complex128
    psi.test_sanity()
    assert eng.Bp[1].dtype == eng.Wp[1].dtype == torch.complex128
    assert max(psi.chi) <= 16 and psi.chi[2] == 8    # the full middle bond
    for E_ref in (float(ref['finite.sweep_E'][-1]),
                  float(ref['finite.E_host'])):
        assert abs(E - E_ref) <= 1e-10 * abs(E_ref)
    got = tx.measure_hofstadter(psi, m.H_MPO)
    assert abs(got['E'] - float(ref['finite.E'])) <= 1e-10 * abs(got['E'])
    assert abs(got['E'] - E) <= 1e-10 * abs(E)
    assert abs(np.sum(got['N']) - 3.) <= 1e-12


@pytest.fixture(scope='module')
def infinite_run():
    return _run('infinite')


def test_infinite_rescale_vs_jax(ref, infinite_run):
    m, sites, eng, E = infinite_run
    st = eng.sweep_stats
    # Q=3 on L=9 sites: the uniform gauge rescales the charge unit by 3
    assert eng.gauge is not None and list(eng.gauge['k']) == [3]
    assert np.array_equal(ref['infinite.gauge_k'], [3])
    upd = np.asarray(st['update_E0'][0])
    assert np.abs(upd - ref['infinite.update_E0']).max() <= \
        1e-10 * np.abs(ref['infinite.update_E0']).max()
    assert np.abs(np.asarray(st['E']) - ref['infinite.sweep_E']).max() <= \
        1e-10 * np.abs(ref['infinite.sweep_E']).max()
    psi = eng.psi
    assert psi.dtype == torch.complex128
    assert max(float(b.imag.abs().max()) for B in psi._B
               for b in B._data) > 0.1
    assert all(S.dtype == np.float64 for S in psi._S)
    assert all(a is b for a, b in zip(psi.sites, sites))
    for i, site in enumerate(sites):
        p = psi.get_B(i, None).get_leg('p')
        assert np.array_equal(p.charges, site.leg.charges)
    assert eng.write_back_stats['norm_test_after'] < 1e-12
    got = tx.measure_hofstadter(psi, m.H_MPO)
    assert got['norm_test'] < 1e-12
    assert abs(np.sum(got['N']) - 3.) <= 1e-12
    tm_ref = float(ref['infinite.tm_E'])
    assert abs(got['tm_E'] - tm_ref) <= 1e-9 * abs(tm_ref)
    assert np.abs(got['entropy'] - ref['infinite.entropy']).max() <= 1e-6
    assert np.abs(got['N'] - ref['infinite.N']).max() <= 1e-6
    xi_ref = float(ref['infinite.xi'])
    assert abs(got['xi'] - xi_ref) <= 2e-3 * xi_ref


def _to_jax(p):
    """A port PackedArray (CPU) as ``tenpy_tpu``'s, in the same layout."""
    return jpk.pack(tx.to_jax(pk.unpack(p)), pad=False)


def test_complex_lanczos_vs_jax(infinite_run):
    _, _, eng, _ = infinite_run
    LP, RP = eng.LPp[0], eng.RPp[1]
    W0 = eng.Wp[0].replace_labels(['p', 'p*'], ['p0', 'p0*'])
    W1 = eng.Wp[1].replace_labels(['p', 'p*'], ['p1', 'p1*'])
    C = ps.scale_bond(eng.Bp[0], eng.Sp[0],
                      ps.scale_bond_plan(eng.Bp[0], 'vL'))
    th = pk.tensordot(C.replace_labels(['p'], ['p0']),
                      eng.Bp[1].replace_labels(['p'], ['p1']),
                      axes=(['vR'], ['vL']))
    ops = (LP, RP, W0, W1, th)
    assert all(x.dtype == torch.complex128 for x in ops)
    jops = [_to_jax(x) for x in ops]
    assert jops[-1].iscomplex
    hw = _matvec_2site_packed(*ops)
    jhw = j_lanczos.__globals__['_matvec_2site_packed'](*jops)
    legs = hw.legs
    want = np.asarray(jpk.unpack(jhw).to_ndarray())
    got = pk.unpack(hw, orig_legs=legs).to_ndarray()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    E0, th_gs, n, _ = _lanczos_K_2site_packed_impl(*ops, 20, 1e-15, 2)
    jE0, jth, jn, _ = j_lanczos(*jops, 20, 1e-15, 2)
    assert abs(E0 - float(jE0)) <= 1e-10 * abs(float(jE0))
    assert th_gs.dtype == torch.complex128
    ov = np.vdot(np.asarray(jpk.unpack(jth).to_ndarray()).ravel(),
                 pk.unpack(th_gs, orig_legs=th_gs.legs).to_ndarray().ravel())
    assert abs(abs(ov) - 1.) <= 1e-10
    with pytest.raises(NotImplementedError, match='reortho'):
        _lanczos_K_2site_packed_impl(*ops, 20, 1e-15, 2, True)


def test_exchange_complex_rescaled(infinite_run, tmp_path):
    m, sites, eng, _ = infinite_run
    flat = eng.export_state()
    path = tmp_path / 'hof.npz'
    exchange.save_flat(path, flat)
    st = exchange.load(path)
    assert list(st.gauge['k']) == [3]
    assert all(B.dtype == torch.complex128 for B in st.B)
    assert all(S.dtype == np.float64 for S in st.S)
    Bs, _, _ = eng._host_state()
    for B, Bl in zip(Bs, st.B):
        assert np.array_equal(B._qdata, Bl._qdata)
        assert all(torch.equal(x, y) for x, y in zip(B._data, Bl._data))
    psi = exchange.load_mps(path, sites)
    assert psi.dtype == torch.complex128
    for i, site in enumerate(sites):
        p = psi.get_B(i, None).get_leg('p')
        assert np.array_equal(p.charges, site.leg.charges)
    # the write-back's state before its re-gauge, in the same frame
    assert sum(B.qtotal[0] for B in psi._B) == 3
    assert abs(float(np.max(psi.norm_test()))
               - eng.write_back_stats['norm_test_before']) <= 1e-12
    psi.canonical_form()
    assert abs(float(m.H_MPO.expectation_value(psi))
               - float(m.H_MPO.expectation_value(eng.psi))) <= 1e-12
