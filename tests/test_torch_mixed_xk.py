"""The port's momentum-space cylinders, molecular model and
``mixer_env_reseed`` against ``tenpy_tpu``'s.

Every case runs through the port here and is compared with
``tenpy_tpu``'s values on the same case, stored in
``tests/benchmark_data/xk_reference.npz`` (written by ``python
tests/torch_exchange.py --write-xk-models``; no JAX runs here):

* the W tensors, virtual and physical leg charges of the x-k models
  (``SpinlessMixedXKSquare``, ``HubbardMixedXKSquare``, with and without
  ky, finite and infinite, the Ly=4 cylinder of the chip smoke's phase 17a)
  and of ``MolecularModel`` on seeded integrals: 1e-14;
* the full spectra of the Lx=2, Ly=3 spinless and Lx=1, Ly=2 Hubbard
  cylinders in the x-k basis equal to their real-space forms and to JAX's:
  1e-12; the molecular spectrum equal to the dense second-quantized
  Hamiltonian's (1e-9) and to JAX's;
* ``dmrg.run`` on the 3x3 spinless x-k cylinder at chi 64 and the
  ``real_to_mixed_*`` measurements (on the port's state and on JAX's
  state carried into the port): 1e-8;
* the Ly=2 infinite spinless x-k cylinder by iDMRG at chi 32 with
  ``mixer_env_reseed='tm'``: every sweep's energy against JAX's where JAX's
  estimate is sound, the final energy to 1e-10;
* the packed Lanczos route (forced, plain kernel) against the host
  Lanczos on a complex state of the Ly=4 spinless cylinder (N and ky mod
  4): 1e-12.
"""
import functools
import itertools

import numpy as np
import pytest
import torch

import torch_exchange as tx
from tenpy_tpu_torch.algorithms import dmrg
from tenpy_tpu_torch.linalg import np_conserved as npc
from tenpy_tpu_torch.linalg.krylov_based import LanczosGroundState
from tenpy_tpu_torch.models.mixed_xk import (MixedXKLattice,
                                              SpinlessMixedXKSquare)
from tenpy_tpu_torch.networks import exchange
from tenpy_tpu_torch.networks.mps import MPS

torch.set_num_threads(1)

TOL_ED = 1e-12
TOL_MEAS = 1e-8


@pytest.fixture(scope='module')
def ref():
    return exchange.load_flat(tx.XK_REF)


@pytest.mark.parametrize('case', list(tx.XK_MODEL_CASES))
def test_model_W(case, ref):
    """The MPO (W, virtual charges, IdL/IdR) and physical legs of each
    x-k model and of the molecular model."""
    tx.check_flat(tx.case_model_flat('torch', tx.XK_MODEL_CASES, case), ref,
               f'model.{case}')


def test_lattice_maps():
    """``MixedXKLattice``'s index maps and ky charges (tests/
    test_mixed_xk.py:27)."""
    m = SpinlessMixedXKSquare({'Lx': 2, 'Ly': 3, 'bc_MPS': 'finite'})
    lat = m.lat
    assert isinstance(lat, MixedXKLattice)
    assert lat.get_u(2, 0) == 2 and lat.get_k(2) == 2 and lat.get_l(2) == 0
    assert lat.unit_cell[0].leg.chinfo.mod == (1, 3)
    for i, site in enumerate(lat.mps_sites()):
        assert list(site.leg.to_qflat()[1]) == [1, lat.get_k(i % 3)]


@pytest.mark.parametrize('case', list(tx.XK_ED_CASES))
def test_spectrum_vs_real_space(case, ref):
    """The x-k model's full spectrum is its real-space form's and JAX's."""
    out = tx.xk_ed_case('torch', case)
    xk, real = out[f'xk_ed.{case}.xk'], out[f'xk_ed.{case}.real']
    assert np.abs(xk - real).max() <= TOL_ED
    for key in (f'xk_ed.{case}.xk', f'xk_ed.{case}.real'):
        assert np.abs(out[key] - ref[key]).max() <= TOL_ED


def test_molecular_spectrum(ref):
    """tests/test_molecular.py: the molecular MPO's spectrum against the
    dense Hamiltonian built from the same integrals (1e-9) and JAX's."""
    w_mpo = tx.molecular_ed('torch')
    assert np.abs(w_mpo - ref['molecular.ed']).max() <= TOL_ED * max(
        1., np.abs(w_mpo).max())
    params = tx.molecular_params()
    h1, h2, const = (params['one_body_tensor'], params['two_body_tensor'],
                     params['constant'])
    m = tx.make_case_model('torch', tx.XK_MODEL_CASES, 'molecular')
    site = m.lat.mps_sites()[0]
    norb, d = h1.shape[0], site.dim
    JW = site.get_op('JW').to_numpy()

    def op(name, i):
        mats = [JW if x < i else site.get_op(name).to_numpy() if x == i
                else np.eye(d) for x in range(norb)]
        return functools.reduce(np.kron, mats)

    cd = {0: 'Cdu', 1: 'Cdd'}
    c = {0: 'Cu', 1: 'Cd'}
    H = np.eye(d ** norb) * const
    for sp in (0, 1):
        for i, j in itertools.product(range(norb), repeat=2):
            H += h1[i, j] * (op(cd[sp], i) @ op(c[sp], j))
    for sp, tp in itertools.product((0, 1), repeat=2):
        for i, j, k, l in itertools.product(range(norb), repeat=4):
            H += 0.5 * h2[i, j, k, l] * (op(cd[sp], i) @ op(cd[tp], k)
                                         @ op(c[tp], l) @ op(c[sp], j))
    assert np.abs(w_mpo - np.linalg.eigvalsh(H)).max() < 1e-9


@pytest.fixture(scope='module')
def xk_3x3():
    return tx.xk_3x3_dmrg('torch')


def test_xk_3x3_dmrg(xk_3x3, ref):
    """tests/test_mixed_xk.py:84: ``dmrg.run`` on the 3x3 spinless x-k
    cylinder at chi 64 from the (N=3, ky=0) product state: JAX's energy and
    the ED value to 1e-8; the mixer grew the state and left diagonal
    Schmidt values."""
    E, psi, _ = xk_3x3
    assert abs(E - float(ref['xk_3x3.E'])) <= TOL_MEAS
    assert abs(E - (-5.515124996414)) <= TOL_MEAS
    assert max(psi.chi) > 1
    assert not any(isinstance(s, npc.Array) for s in psi._S)
    assert np.max(psi.norm_test()) < 1e-7


def test_real_to_mixed_measurements(xk_3x3, ref):
    """The ``real_to_mixed_*`` TermLists (their sites and strengths
    exactly as JAX's) and their values on the port's state and on JAX's
    state carried into the port (``exchange.load_mps`` with the Z_3 ky
    charge), against JAX's values: 1e-8."""
    _, psi, m = xk_3x3
    out = tx.xk_measurements(m, psi)
    psi_jax = tx.load_state(ref, 'xk_3x3.psi', m.lat.mps_sites())
    assert psi_jax.chinfo.mod == (1, 3)
    out_jax = tx.xk_measurements(m, psi_jax)
    for key in out:
        expect = ref['xk_3x3.' + key]
        if key.endswith('.sites'):
            assert np.array_equal(out[key], expect), key
        elif key.endswith('.strength'):
            assert np.abs(out[key] - expect).max() <= 1e-15, key
        elif key.endswith('.terms'):
            continue    # terms off the ground state's sectors differ
        else:
            assert abs(complex(out[key]) - complex(expect)) <= TOL_MEAS, key
            assert abs(complex(out_jax[key]) - complex(expect)) <= 1e-12, \
                key


def test_xk_idmrg_tm_reseed(ref):
    """The Ly=2 infinite spinless x-k cylinder by iDMRG (chi 32), the
    mixer off after three sweeps and the environments re-seeded from the
    transfer-matrix fixed point (``mixer_env_reseed='tm'``; the port
    brings the state to its canonical form first, ``tenpy_tpu`` does
    not).

    The sweeps with the mixer agree with JAX's to 1e-10, and so does the
    final (transfer-matrix) energy.  The sweep right after the re-seed
    compares environments of different ages and is no estimate (about +14
    in both packages); after it ``tenpy_tpu``'s sweep estimate stays
    3.0e-3 below its own final energy (its re-seeded environments' ages),
    while the port's is the final energy to 1e-10."""
    out = tx.xk_idmrg('torch')
    E, E_jax = out['idmrg.E'], ref['xk.idmrg.E']
    assert len(E) == len(E_jax) == tx.XK_IDMRG_OPTIONS['max_sweeps']
    n_mix = tx.XK_IDMRG_OPTIONS['mixer_params']['disable_after']
    assert np.all(np.abs(E[:n_mix] - E_jax[:n_mix])
                  <= 1e-10 * np.abs(E_jax[:n_mix]))
    E_run = float(out['idmrg.E_run'])
    assert abs(E_run - float(ref['xk.idmrg.E_run'])) <= 1e-10 * abs(E_run)
    assert np.all(np.abs(E[n_mix + 1:] - E_run) <= 1e-10 * abs(E_run))
    assert np.array_equal(out['idmrg.chi'], ref['xk.idmrg.chi'])


def test_tm_reseed_option():
    """With ``mixer_env_reseed='tm'`` the environments restart from the
    transfer-matrix fixed point when the mixer goes off, recorded in
    ``env_reseed_stats``; by default they restart from trivial
    boundaries."""
    m = SpinlessMixedXKSquare(dict(tx.XK_IDMRG))
    stats = {}
    for reseed in ('tm', 'trivial'):
        psi = MPS.from_product_state(m.lat.mps_sites(), ['full', 'empty'],
                                     bc='infinite')
        opts = {'trunc_params': {'chi_max': 4, 'svd_min': 1e-12},
                'max_sweeps': 2, 'min_sweeps': 2, 'mixer': True,
                'mixer_params': {'disable_after': 1}, 'N_sweeps_check': 1,
                'mixer_env_reseed': reseed}
        eng = dmrg.TwoSiteDMRGEngine(psi, m, opts, device='cpu')
        eng.run()
        stats[reseed] = eng.env_reseed_stats
    assert [s['kind'] for s in stats['tm']] == ['tm']
    assert [s['kind'] for s in stats['trivial']] == ['trivial']


def test_packed_route_vs_host_on_complex_z4_state():
    """On a complex state of the Ly=4 spinless x-k cylinder (charges N
    and ky mod 4), one two-site eigensolve by the packed Lanczos on the
    plain kernel (forced by ``device_K``) and by the host
    ``LanczosGroundState`` from the same guess: energies to 1e-12 and the
    same vector."""
    m = SpinlessMixedXKSquare({'Lx': 1, 'Ly': 4, 't': 1., 'V': 1.,
                               'bc_MPS': 'infinite'})
    assert m.lat.unit_cell[0].leg.chinfo.mod == (1, 4)
    psi = MPS.from_product_state(m.lat.mps_sites(),
                                 ['full', 'full', 'empty', 'empty'],
                                 bc='infinite')
    grow = dmrg.TwoSiteDMRGEngine(psi, m, {
        'trunc_params': {'chi_max': 8, 'svd_min': 1e-12}, 'mixer': True},
        device='cpu')
    grow.mixer_activate()
    grow.sweep()            # the mixer fills ky sectors: chi > 1
    grow.mixer_deactivate()
    assert max(psi.chi) > 1
    psi = psi.astype(np.complex128)
    rng = np.random.default_rng(3)
    for B in psi._B:            # a phase per block: a complex state
        B._data = [b * np.exp(2j * np.pi * rng.uniform()) for b in B._data]
    eng = dmrg.TwoSiteDMRGEngine(psi, m, {
        'trunc_params': {'chi_max': 12, 'svd_min': 1e-12},
        'lanczos_params': {'device_K': 40, 'P_tol': 1e-14, 'N_min': 40}},
        device='cpu')
    eng.i0, eng.move_right = 1, True
    theta = eng.prepare_update_local()
    assert eng._use_device_lanczos() and theta.dtype == torch.complex128
    assert eng.eff_H.N > 20
    E_dev, th_dev, N_dev, _ = eng._diag_device_lanczos(theta)
    E_host, th_host, _ = LanczosGroundState(
        eng.eff_H, theta, {'N_min': 40, 'N_max': 40, 'P_tol': 1e-14}).run()
    assert abs(E_dev - E_host) <= 1e-12 * abs(E_host)
    ov = abs(complex(npc.inner(th_dev.conj(), th_host, axes='range')))
    assert abs(1. - ov) <= 1e-10
