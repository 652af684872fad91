"""The port's sites, lattices and Hubbard MPOs against ``tenpy_tpu``'s.

The MPO must match exactly: the order of its virtual states (the MPOGraph
state order and the site's charge sort) decides the packed structure, and a
Jordan-Wigner sign error would show only in the W blocks, not in their
charges.  Charges, qdata, IdL and IdR are held equal and the blocks to
1e-15 (they are sums of products of 0, +-1, t, U and mu).
"""
import numpy as np
import pytest
import torch

from tenpy_tpu.models import hubbard as jhub
from tenpy_tpu.networks.site import SpinHalfFermionSite as JSite
from tenpy_tpu_torch.models import hubbard
from tenpy_tpu_torch.networks.site import SpinHalfFermionSite

torch.set_num_threads(1)

MODELS = {
    'cylinder': ('FermiHubbardModel',
                 {'lattice': 'Square', 'Lx': 2, 'Ly': 4, 'bc_y': 'cylinder',
                  'bc_MPS': 'infinite', 't': 1., 'U': 8., 'mu': 0.}),
    'chain': ('FermiHubbardChain',
              {'L': 6, 'bc_MPS': 'finite', 't': 1.3, 'U': 4., 'mu': 0.7,
               'V': 0.5}),
}


def _legs_equal(p, j):
    assert np.array_equal(p.slices, j.slices)
    assert np.array_equal(p.charges, j.charges)
    assert p.qconj == j.qconj


def _array_equal(p, j, tol):
    assert p.qtotal == tuple(j.qtotal)
    assert p.get_leg_labels() == tuple(j.get_leg_labels())
    for lp, lj in zip(p.legs, j.legs):
        _legs_equal(lp, lj)
    assert np.array_equal(p._qdata, j._qdata)
    for x, y in zip(p._data, j._data):
        assert np.abs(x.numpy() - np.asarray(y)).max() <= tol


@pytest.fixture(scope='module', params=sorted(MODELS))
def models(request):
    name, params = MODELS[request.param]
    return (getattr(hubbard, name)(dict(params)),
            getattr(jhub, name)(dict(params)))


@pytest.mark.parametrize('cons', [('N', 'Sz'), ('N', None), ('parity', 'Sz'),
                                  (None, None)])
def test_site_operators_vs_jax(cons):
    site, jsite = SpinHalfFermionSite(*cons), JSite(*cons)
    _legs_equal(site.leg, jsite.leg)
    assert site.opnames == jsite.opnames
    assert site.need_JW_string == jsite.need_JW_string
    assert site.hc_ops == jsite.hc_ops
    assert site.state_labels == jsite.state_labels
    assert np.array_equal(site.perm, jsite.perm)
    for name in sorted(jsite.opnames):
        _array_equal(site.get_op(name), jsite.get_op(name), 0.)
    _array_equal(site.get_op('Cdu JW'), jsite.get_op('Cdu JW'), 0.)
    assert site.get_hc_op_name('Cdu JW') == jsite.get_hc_op_name('Cdu JW')


def test_lattice_vs_jax(models):
    m, jm = models
    lat, jlat = m.lat, jm.lat
    assert np.array_equal(lat.order, jlat.order)
    assert lat.N_sites == jlat.N_sites and lat.bc_MPS == jlat.bc_MPS
    assert np.array_equal(lat.bc, jlat.bc)
    for s, js in zip(lat.mps_sites(), jlat.mps_sites()):
        _legs_equal(s.leg, js.leg)
    for (u1, u2, dx), (ju1, ju2, jdx) in zip(lat.pairs['nearest_neighbors'],
                                            jlat.pairs['nearest_neighbors']):
        assert (u1, u2) == (ju1, ju2) and np.array_equal(dx, jdx)
        for x, y in zip(lat.possible_couplings(u1, u2, dx),
                        jlat.possible_couplings(u1, u2, dx)):
            assert np.array_equal(x, y)


def test_hubbard_mpo_vs_jax(models):
    m, jm = models
    H, jH = m.H_MPO, jm.H_MPO
    assert (H.L, H.bc, H.max_range) == (jH.L, jH.bc, jH.max_range)
    assert H.IdL == jH.IdL and H.IdR == jH.IdR
    for i in range(H.L):
        _array_equal(H.get_W(i), jH.get_W(i), 1e-15)
    if hasattr(jm, 'H_bond'):
        for h, jh in zip(m.H_bond, jm.H_bond):
            assert (h is None) == (jh is None)
            if h is not None:
                _array_equal(h, jh, 1e-15)
