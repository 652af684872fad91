"""The port's MPS, charge gauge and MPO environments against ``tenpy_tpu``.

* ``MPS.from_product_state`` and the charge gauge functions: equal.
* Environments of a chi=16 iMPS of the Ly=2 Hubbard cylinder that
  ``tenpy_tpu``'s host iDMRG produced (committed with ``tenpy_tpu``'s own
  environments and transfer-matrix energies; ``tests/torch_exchange.py``
  writes it, see its docstring), and of a finite chain in memory.

On this state ``tenpy_tpu``'s ``find_init_LP_RP`` takes its Arnoldi route:
its channel-wise builder leaves the site charge in R, so on a cell of
nonzero total charge its bond charges drift and it raises.  The port's
builder keeps the charge in Q and applies; both compute the same converged
fixed point, the port to its GMRES residual (1e-11).  Measured: LP/RP within
4.5e-12 of their largest entry, the energies within 7e-16; held to 1e-10.
Finite-bc environments are plain contractions and agree to 1e-13.

Where ``tenpy_tpu``'s builder applies (a cell of zero total charge: the
same cylinder with N not conserved) the port's builder is held to it
directly: the stable A/B forms equal in charges and within 1e-13, LP/RP
and the energies within 1e-10.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

from tenpy_tpu.algorithms import dmrg, packed_dmrg as jpd
from tenpy_tpu.models.hubbard import FermiHubbardChain as JChain, \
    FermiHubbardModel as JHubbard
from tenpy_tpu.networks.mpo_env_builder import MPOEnvironmentBuilder as \
    JBuilder
from tenpy_tpu.networks.mps import MPS as JMPS
from tenpy_tpu_torch.models.hubbard import FermiHubbardChain, \
    FermiHubbardModel
from tenpy_tpu_torch.networks import charge_gauge, exchange
from tenpy_tpu_torch.networks.mpo import MPOEnvironment, MPOTransferMatrix
from tenpy_tpu_torch.networks.mpo_env_builder import MPOEnvironmentBuilder
from tenpy_tpu_torch.networks.mps import MPS

import torch_exchange as tx

torch.set_num_threads(1)

SMALL = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     'benchmark_data', 'hubbard_cyl_ly2_chi16_exchange.npz')
CHAIN = {'L': 6, 'bc_MPS': 'finite', 't': 1., 'U': 4., 'mu': 0.}
ENV_TOL = 1e-10
NO_N = dict(tx.SMALL_MODEL, cons_N=None)


def _dense_close(p, j, tol):
    """Port Array ``p`` equals ``j`` (a tenpy_tpu or port Array) densely,
    within ``tol`` of the largest entry."""
    pd_, jd = p.to_numpy(), np.asarray(j.to_numpy())
    assert p.get_leg_labels() == tuple(j.get_leg_labels())
    assert pd_.shape == jd.shape
    assert np.abs(pd_ - jd).max() <= tol * np.abs(jd).max()


def _legs_equal(p, j):
    for lp, lj in zip(p.legs, j.legs):
        assert np.array_equal(lp.slices, lj.slices)
        assert np.array_equal(lp.charges, lj.charges)
        assert lp.qconj == lj.qconj
    assert p.qtotal == tuple(j.qtotal)


@pytest.mark.parametrize('bc', ['finite', 'infinite'])
def test_from_product_state_vs_jax(bc):
    if bc == 'finite':
        m, jm = FermiHubbardChain(dict(CHAIN)), JChain(dict(CHAIN))
        init = ['up', 'down', 'full', 'empty', np.array([0., .6, .8, 0.]),
                'down']
    else:
        m, jm = FermiHubbardModel(dict(tx.SMALL_MODEL)), \
            JHubbard(dict(tx.SMALL_MODEL))
        init = ['up', 'down', 'down', 'up']
    # a local vector across two charge sectors: both drop the same weight
    with pytest.warns(UserWarning, match='dropped weight') if bc == 'finite' \
            else contextlib.nullcontext():
        psi = MPS.from_product_state(m.lat.mps_sites(), init, bc=bc)
    with pytest.warns(UserWarning, match='dropped weight') if bc == 'finite' \
            else contextlib.nullcontext():
        jpsi = JMPS.from_product_state(jm.lat.mps_sites(), init, bc=bc)
    assert (psi.L, psi.bc, psi.form, psi.chi) == \
        (jpsi.L, jpsi.bc, jpsi.form, jpsi.chi)
    for i in range(psi.L):
        _legs_equal(psi.get_B(i, None), jpsi.get_B(i, None))
        _dense_close(psi.get_B(i, None), jpsi.get_B(i, None), 0.)
        assert np.array_equal(psi.get_SL(i), jpsi.get_SL(i))


@pytest.mark.parametrize('init', [['up', 'down', 'down', 'up'],
                                  ['up', 'empty', 'down', 'up']])
def test_charge_gauge_vs_jax(init):
    """Neel (k = 1) and a cell of charge (3, 1) over L = 4 (k = 4)."""
    m, jm = FermiHubbardModel(dict(tx.SMALL_MODEL)), \
        JHubbard(dict(tx.SMALL_MODEL))
    psi = MPS.from_product_state(m.lat.mps_sites(), init, bc='infinite')
    jpsi = JMPS.from_product_state(jm.lat.mps_sites(), init, bc='infinite')
    info = charge_gauge.uniformize_charge_gauge(psi, rescale=True)
    jinfo = jpd.uniformize_charge_gauge(jpsi, rescale=True)
    assert np.array_equal(info['k'], jinfo['k'])
    assert all(np.array_equal(a, b) for a, b in zip(info['o'], jinfo['o']))
    for i in range(psi.L):
        _legs_equal(psi.get_B(i, None), jpsi.get_B(i, None))
        assert np.array_equal(psi.sites[i].leg.charges,
                              jpsi.sites[i].leg.charges)
    H = charge_gauge.scale_mpo_charges(m.H_MPO, info['k'])
    jH = jpd.scale_mpo_charges(jm.H_MPO, jinfo['k'])
    for i in range(H.L):
        _legs_equal(H.get_W(i), jH.get_W(i))
    # the inverse restores the original bookkeeping
    charge_gauge.apply_bond_charge_shift(psi, [-o for o in info['o']])
    charge_gauge.scale_psi_charges(psi, info['k'], div=True)
    orig = MPS.from_product_state(m.lat.mps_sites(), init, bc='infinite')
    for i in range(psi.L):
        _legs_equal(psi.get_B(i, None), orig.get_B(i, None))
    if init[1] == 'empty':
        assert np.any(info['k'] != 1)


def test_infinite_environments_vs_jax():
    flat = exchange.load_flat(SMALL)
    st = exchange.ExchangeState(flat)
    m = FermiHubbardModel(dict(tx.SMALL_MODEL))
    psi = exchange.load_mps(flat, m.lat.mps_sites())
    gauge = charge_gauge.uniformize_charge_gauge(psi, rescale=True)
    assert all(np.array_equal(a, b) for a, b in zip(gauge['o'],
                                                   st.gauge['o']))
    init, Es, E0 = MPOTransferMatrix.find_init_LP_RP(m.H_MPO, psi,
                                                     calc_E=True)
    ref_Es = st.reference['tm_Es']
    assert np.abs(np.asarray(Es) - ref_Es).max() <= ENV_TOL * abs(ref_Es[0])
    assert abs(E0.real - float(st.reference['tm_E0'])) <= \
        ENV_TOL * abs(ref_Es[0])
    env = MPOEnvironment(psi, m.H_MPO, psi, **init)
    _dense_close(env.get_LP(0).transpose(['vR*', 'wR', 'vR']), st.LP0,
                 ENV_TOL)
    for i in range(psi.L):
        _dense_close(env.get_RP(i).transpose(['wL', 'vL', 'vL*']), st.RP[i],
                     ENV_TOL)


def test_finite_environments_vs_jax():
    jm = JChain(dict(CHAIN))
    jpsi = JMPS.from_product_state(jm.lat.mps_sites(), ['up', 'down'] * 3)
    dmrg.TwoSiteDMRGEngine(jpsi, jm, {
        'trunc_params': {'chi_max': 16, 'svd_min': 1e-12}, 'max_sweeps': 2,
        'mixer': True}).run()
    flat = tx.export_flat(jpsi, jm)
    st = exchange.ExchangeState(flat)
    m = FermiHubbardChain(dict(CHAIN))
    psi = exchange.load_mps(flat, m.lat.mps_sites())
    env = MPOEnvironment(psi, m.H_MPO, psi)
    _dense_close(env.get_LP(0).transpose(['vR*', 'wR', 'vR']), st.LP0, 1e-13)
    for i in range(psi.L):
        _dense_close(env.get_RP(i).transpose(['wL', 'vL', 'vL*']), st.RP[i],
                     1e-13)



@pytest.fixture(scope='module')
def no_n_state():
    """A chi=8 iMPS of the Ly=2 cylinder with only Sz conserved, from
    ``tenpy_tpu``'s host iDMRG, and the port's copy of it."""
    jm = JHubbard(dict(NO_N))
    jpsi = JMPS.from_product_state(jm.lat.mps_sites(),
                                   ['up', 'down', 'down', 'up'],
                                   bc='infinite')
    dmrg.TwoSiteDMRGEngine(jpsi, jm, {
        'trunc_params': {'chi_max': 8, 'svd_min': 1e-12}, 'max_sweeps': 2,
        'mixer': True}).run()
    m = FermiHubbardModel(dict(NO_N))
    L = jpsi.L
    psi = MPS(m.lat.mps_sites(),
              [tx.to_host(jpsi.get_B(i, None)) for i in range(L)],
              [np.asarray(jpsi.get_SL(i)) for i in range(L)]
              + [np.asarray(jpsi.get_SR(L - 1))],
              bc='infinite', form=list(jpsi.form))
    return m, psi, jm, jpsi


@pytest.mark.parametrize('gauge', ['uniform', 'site_charges'])
def test_env_builder_vs_jax_builder(no_n_state, gauge):
    """The port's ``MPOEnvironmentBuilder`` against ``tenpy_tpu``'s on a
    cell of zero total charge, where both apply.

    ``uniform``: the engine's path, every site's qtotal 0 after the charge
    gauge; the stable forms are equal in charges.  ``site_charges``: the
    Neel sites keep qtotal +-1; the port leaves it in Q, ``tenpy_tpu`` in
    R, so the forms agree densely and only their inner legs' charges and
    qtotals differ.  Measured: forms within 5e-16, LP/RP within 3.1e-15,
    energies within 5e-16; held to 1e-13 and 1e-12."""
    m, psi, jm, jpsi = no_n_state
    psi, jpsi = psi.copy(), jpsi.copy()
    if gauge == 'uniform':
        info = charge_gauge.uniformize_charge_gauge(psi)
        jinfo = jpd.uniformize_charge_gauge(jpsi)
        assert any(np.any(o != 0) for o in info['o'])
        assert all(np.array_equal(a, b)
                   for a, b in zip(info['o'], jinfo['o']))
    builder = MPOEnvironmentBuilder(m.H_MPO, psi)
    jbuilder = JBuilder(jm.H_MPO, jpsi)
    for form in ('A', 'B'):
        for i, (T, jT) in enumerate(zip(builder._stable_forms(form),
                                        jbuilder._stable_forms(form))):
            _dense_close(T, jT, 1e-13)
            if gauge == 'uniform':
                _legs_equal(T, jT)
            else:
                assert T.qtotal == tuple(psi.get_B(i, None).qtotal)
                assert tuple(jT.qtotal) == (0,)
    init, Es, E0 = builder.init_LP_RP_iterative(calc_E=True)
    jinit, jEs, jE0 = jbuilder.init_LP_RP_iterative(calc_E=True)
    for key in ('init_LP', 'init_RP'):
        _legs_equal(init[key], jinit[key])
        _dense_close(init[key], jinit[key], 1e-12)
    assert np.abs(np.asarray(Es) - np.asarray(jEs)).max() <= \
        1e-12 * abs(jEs[0])
    assert abs(E0 - complex(jE0)) <= 1e-12 * abs(jEs[0])
