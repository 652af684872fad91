"""Dipole conservation, the new lattices and the H_bond/H_MPO conversions
of the port against ``tenpy_tpu``'s.

Every case runs through the port here and is compared with
``tenpy_tpu``'s values on the same case, stored in
``tests/benchmark_data/xk_reference.npz`` (written by ``python
tests/torch_exchange.py --write-xk-models``; no JAX runs here):

* ``DipolarChargeInfo`` (shifts, equality, the checks of its moduli) and
  its HDF5 round trip, the ``ChargeInfo``/``LegCharge`` charge mappings and
  ``Array.add_charge``/``drop_charge``/``change_charge``: exactly;
* the dipolar sites and the position-shifted ``mps_sites``: exactly;
* ``IrregularLattice`` and ``HelicalLattice``: orders, index maps and
  couplings, exactly; the helical MPO (1e-14), its energy equal to the
  regular lattice's on the same state, and its iDMRG against JAX's;
* the W tensors and leg charges of ``DipolarSpinChain``,
  ``DipolarBoseHubbardChain`` and ``XXZChain2``: 1e-14;
* ``calc_H_bond_from_MPO``, ``from_MPOModel`` and
  ``calc_H_MPO_from_bond`` and their round trips: 1e-14;
* finite dipolar DMRG (the S=1 chain at L=8, the Bose-Hubbard chain at
  L=6 against ED in its charge sector): 1e-10; the infinite dipolar model
  raises in both packages.
"""

import numpy as np
import pytest
import torch

import torch_exchange as tx
from tenpy_tpu_torch.algorithms.exact_diag import ExactDiag
from tenpy_tpu_torch.linalg.charges import ChargeInfo, DipolarChargeInfo
from tenpy_tpu_torch.models.model import MPOModel, NearestNeighborModel
from tenpy_tpu_torch.networks import exchange
from tenpy_tpu_torch.networks.mps import MPS

torch.set_num_threads(1)

TOL_W = tx.TOL_W     # W tensors, operators, bond Hamiltonians
TOL_E = 1e-10       # energies (relative)


@pytest.fixture(scope='module')
def ref():
    return exchange.load_flat(tx.XK_REF)


def test_charge_mappings(ref):
    """``DipolarChargeInfo`` and every charge mapping of legs, charge
    infos and arrays, against JAX's on the same inputs."""
    tx.check_flat(tx.dipole_charges_case('torch'), ref, 'charges')


def test_dipolar_chargeinfo_hdf5(tmp_path):
    """A ``DipolarChargeInfo`` and a leg of it through the HDF5 format."""
    pytest.importorskip('h5py')
    from tenpy_tpu_torch.tools import io
    from tenpy_tpu_torch.linalg.charges import LegCharge
    ci = DipolarChargeInfo([4, 2], ['q', 'p'], [0], [1])
    leg = LegCharge.from_qflat(ci, [[1, 0], [3, 1]])
    io.save({'ci': ci, 'leg': leg, 'plain': ChargeInfo([4, 2])},
            str(tmp_path / 'ci.h5'))
    back = io.load(str(tmp_path / 'ci.h5'))
    assert type(back['ci']) is DipolarChargeInfo and back['ci'] == ci
    assert back['ci'].names == ci.names and hash(back['ci']) == hash(ci)
    assert back['leg'] == leg and back['leg'].chinfo == ci
    assert type(back['plain']) is ChargeInfo and back['plain'] != ci


def test_dipolar_sites(ref):
    """The dipolar spin and boson sites, and the charges of a dipolar
    chain's sites shifted to their positions (the dipole charge is the
    position times 2 Sz)."""
    out = tx.dipole_sites_case('torch')
    tx.check_flat(out, ref, 'dsites')
    for i in range(6):
        q = out[f'dsites.mps.{i}']
        assert np.array_equal(q[:, 1], i * q[:, 0])


def test_lattices(ref):
    """``IrregularLattice`` and ``HelicalLattice`` (its unit cell
    enlarged too)."""
    tx.check_flat(tx.dipole_lattices_case('torch'), ref, 'lattices')


@pytest.mark.parametrize('case', list(tx.DIPOLE_MODEL_CASES))
def test_model_W(case, ref):
    """The MPO (W, virtual charges, IdL/IdR), bond Hamiltonians and
    physical legs of each model."""
    tx.check_flat(tx.case_model_flat('torch', tx.DIPOLE_MODEL_CASES, case),
               ref, f'model.{case}')


def test_dipolar_mpo_charges():
    """The dipolar chain's MPO carries nonzero dipole charges on its
    virtual legs."""
    m = tx.make_case_model('torch', tx.DIPOLE_MODEL_CASES, 'dipolar_spin')
    assert np.any(m.H_MPO.get_W(2).get_leg('wL').to_qflat()[:, 1] != 0)


@pytest.mark.parametrize('case', list(tx.CONVERSION_CASES))
def test_conversions(case, ref):
    """``calc_H_bond_from_MPO``, ``from_MPOModel`` and
    ``calc_H_MPO_from_bond`` against JAX's; and the round trips: the bond
    terms from the MPO equal the model's own ``H_bond``, and the MPO from
    the bond terms has the model's dense Hamiltonian (finite) or gives
    back the same bond terms (infinite)."""
    out = tx.conversion_case('torch', case)
    tx.check_flat(out, ref, f'conv.{case}')
    m = tx.make_case_model('torch', tx.CONVERSION_CASES, case)
    pre = f'conv.{case}'
    for i, h in enumerate(m.H_bond):
        if h is None:
            continue
        own = h.transpose(['p0', 'p0*', 'p1', 'p1*']).to_numpy()
        assert np.abs(out[f'{pre}.from_mpo.{i}'] - own).max() <= TOL_W
        assert np.abs(out[f'{pre}.nn.{i}'] - own).max() <= TOL_W
        if m.lat.bc_MPS != 'finite':
            assert np.abs(out[f'{pre}.back.{i}'] - own).max() <= TOL_W
    if m.lat.bc_MPS == 'finite':
        from tenpy_tpu_torch.algorithms.exact_diag import \
            get_numpy_Hamiltonian
        dense = get_numpy_Hamiltonian(m)
        assert np.abs(out[f'{pre}.dense'] - dense).max() <= TOL_W * max(
            1., np.abs(dense).max())


def test_from_MPOModel_is_nearest_neighbor():
    """``from_MPOModel`` gives a ``NearestNeighborModel`` on the same
    lattice, whose bond energies are the MPO's energy."""
    m = tx.make_case_model('torch', tx.CONVERSION_CASES, 'xxz')
    nn = NearestNeighborModel.from_MPOModel(MPOModel(m.lat, m.H_MPO))
    assert nn.lat is m.lat
    psi = MPS.from_product_state(m.lat.mps_sites(), ['up', 'down'] * 3)
    E_bonds = float(np.sum(nn.bond_energies(psi)))
    assert abs(E_bonds - float(np.real(m.H_MPO.expectation_value(psi)))) \
        <= 1e-13


@pytest.mark.parametrize('which', ['dipole', 'Sz'])
def test_dipolar_spin_dmrg(which, ref):
    """tests/test_dipole.py:51: ``dmrg.run`` on the finite dipolar S=1
    chain (L=8) with the dipole moment conserved or only Sz: JAX's energy
    to 1e-10, and both conservation laws give the same ground energy; the
    dipolar state's tensors carry both charges."""
    E, psi = tx.dipole_dmrg('torch', which)
    E_jax = float(ref[f'dipole_dmrg.{which}.E'])
    assert abs(E - E_jax) <= TOL_E * abs(E_jax)
    other = 'Sz' if which == 'dipole' else 'dipole'
    assert abs(E - float(ref[f'dipole_dmrg.{other}.E'])) <= TOL_E * abs(E)
    assert psi.get_B(4, None).chinfo.qnumber == (2 if which == 'dipole'
                                                 else 1)


def test_dipolar_boson_dmrg_vs_ed(ref):
    """tests/test_dipole.py:79: the finite dipolar Bose-Hubbard chain
    (L=6): JAX's energy to 1e-10 and the ground energy of the start
    state's (N, dipole) sector by ED to 1e-10."""
    E, psi = tx.dipole_dmrg('torch', 'boson')
    E_jax = float(ref['dipole_dmrg.boson.E'])
    assert abs(E - E_jax) <= TOL_E * abs(E_jax)
    m = tx._pkg('torch', 'models.hubbard').DipolarBoseHubbardChain(
        dict(tx.DIPOLE_BOSON))
    start = MPS.from_product_state(m.lat.mps_sites(), tx.DIPOLE_BOSON_INIT)
    sector = start.get_total_charge(only_physical_legs=True)
    assert np.array_equal(psi.get_total_charge(only_physical_legs=True),
                          sector)
    ed = ExactDiag(m, charge_sector=sector)
    ed.build_full_H_from_mpo()
    ed.full_diagonalization()
    E_ed = float(np.min(np.asarray(ed.E)))
    assert abs(E - E_ed) <= TOL_E * abs(E_ed)


def test_dipolar_state_exchange(ref):
    """JAX's dipolar ground state carried into the port
    (``exchange.load_mps``): the charge info's kind and indices come
    across, its energy is JAX's, and loading it on sites of another
    charge info or of other positions raises."""
    m = tx._pkg('torch', 'models.spins').DipolarSpinChain(
        dict(tx.DIPOLE_SPIN, conserve='dipole'))
    psi = tx.load_state(ref, 'dipole_dmrg.dipole.psi', m.lat.mps_sites())
    assert type(psi.chinfo) is DipolarChargeInfo
    E = float(np.real(m.H_MPO.expectation_value(psi)))
    assert abs(E - float(ref['dipole_dmrg.dipole.E'])) <= TOL_E * abs(E)
    m_sz = tx._pkg('torch', 'models.spins').DipolarSpinChain(
        dict(tx.DIPOLE_SPIN, conserve='Sz'))
    with pytest.raises(ValueError):
        tx.load_state(ref, 'dipole_dmrg.dipole.psi', m_sz.lat.mps_sites())
    shifted = m.lat.mps_sites()[1:] + m.lat.mps_sites()[:1]
    with pytest.raises(ValueError):
        tx.load_state(ref, 'dipole_dmrg.dipole.psi', shifted)


def test_dipole_infinite_raises(ref):
    """An infinite MPO with dipole conservation raises
    ``NotImplementedError`` in both packages."""
    assert bool(ref['dipole.infinite_raises'])
    assert tx.dipole_infinite_raises('torch')


def test_helical_mpo_parity():
    """tests/test_helical.py:18: the helical TFI model's energy density
    equals the regular tilted lattice's on the same (3-periodic) state."""
    m_h, m_r = tx.helical_models('torch')
    psi3 = MPS.from_desired_bond_dimension(m_h.lat.mps_sites(), 4,
                                           bc='infinite')
    psi3.canonical_form()
    psi9 = psi3.copy().enlarge_mps_unit_cell(3)
    E_h = complex(m_h.H_MPO.expectation_value(psi3))
    E_r = complex(m_r.H_MPO.expectation_value(psi9))
    assert abs(E_h - E_r) < 1e-12


def test_helical_mpo_and_idmrg(ref):
    """The helical MPO (1e-14) and iDMRG on the helix (chi 16, the mixer
    on): the energy of every sweep JAX's to 1e-10."""
    out = tx.helical_case('torch')
    tx.check_flat({k: v for k, v in out.items()
                   if k.startswith('helical.mpo.')}, ref, 'helical.mpo')
    assert np.array_equal(out['helical.chi'], ref['helical.chi'])
    E, E_jax = out['helical.sweep_E'], ref['helical.sweep_E']
    assert len(E) == len(E_jax) == tx.HELICAL_SWEEPS
    assert np.all(np.abs(E - E_jax) <= TOL_E * np.abs(E_jax))


def test_card_route_keeps_the_guess_blocks():
    """The card route of ``dmrg.run`` returns its Ritz vector with every
    block of its guess, a zero one too, as the host Lanczos does: a stored
    zero block adds a sector to the density-matrix mixer's split, and made
    the two routes' first sweeps on the L=64 dipolar chain part."""
    from tenpy_tpu_torch.algorithms.dmrg import _keep_blocks_of
    from tenpy_tpu_torch.linalg import np_conserved as npc
    from tenpy_tpu_torch.linalg.charges import LegCharge
    rng = np.random.default_rng(0)
    ch = ChargeInfo([1, 1])
    legs = [LegCharge.from_qflat(ch, rng.integers(-1, 2, size=(n, 2)), qc)
            for n, qc in ((4, 1), (3, 1), (5, -1))]
    guess = npc.Array.from_func(lambda s: rng.standard_normal(s), legs,
                                qtotal=[0, 0], labels=['vL', 'p', 'vR'])
    assert guess.stored_blocks >= 3
    theta = guess.transpose(['vR', 'vL', 'p'])
    keep = np.arange(theta.stored_blocks) % 3 != 0
    theta._set_blocks(theta._qdata[keep],
                      [b for b, k in zip(theta._data, keep) if k])
    res = _keep_blocks_of(theta, guess)
    assert res.get_leg_labels() == ('vR', 'vL', 'p')
    assert res.stored_blocks == guess.stored_blocks
    res.test_sanity()
    dense, ref = res.to_numpy(), theta.to_numpy()
    assert np.array_equal(dense, ref)
    assert _keep_blocks_of(res, guess) is res
