"""The port's model layer against ``tenpy_tpu``'s.

Every case runs through the port here and is compared with ``tenpy_tpu``'s
values on the same case, stored in
``tests/benchmark_data/models_reference.npz`` (written by ``python
tests/torch_exchange.py --write-models``; no JAX runs here):

* the new sites (``SpinHalfHoleSite``, ``BosonSite``, ``ClockSite``,
  ``GroupedSite``, ``spin_half_species``, ``set_common_charges``,
  ``kron``): charges, state labels and operators, exactly;
* the new lattices and orders (``Ladder``, ``NLegLadder``, ``Triangular``,
  ``Honeycomb`` with its next-nearest neighbours, ``Kagome``,
  ``TrivialLattice``, ``MultiSpeciesLattice``, the toric code's
  ``DualSquare``; 'snake', 'Fstyle', 'folded', grouped, shifted periodic
  bc): orders, pairs, ``possible_couplings`` and
  ``possible_multi_couplings``, exactly;
* ``TermList``, ``MultiCouplingTerms`` and ``ExponentiallyDecayingTerms``
  through ``MPOGraph``, and every model of the zoo on the cases of
  tests/test_models.py, test_models_2d.py and test_terms.py: W tensors
  and bond Hamiltonians to 1e-14;
* the full spectra of the finite cases (``MODELS_VS_ED`` of
  tests/test_models.py and the Haldane, Triangular, Kagome and toric-code
  patches of tests/test_models_2d.py) and ``dmrg.run`` on the finite 2x2
  Haldane patch, to 1e-10;
* ``entanglement_spectrum`` (plain and by charge) on JAX's DMRG state;
* ``device_ramp`` of the Haldane cylinder (config #5's Haldane half,
  complex128) on the CPU through the plain kernel to chi=16: every sweep's
  energy and every update of each stage's first sweep to 1e-10.
"""
import json

import numpy as np
import pytest
import torch

import torch_exchange as tx
from tenpy_tpu_torch.algorithms.exact_diag import ExactDiag
from tenpy_tpu_torch.networks import exchange

torch.set_num_threads(1)

TOL_W = 1e-14       # W tensors, operators, bond Hamiltonians
TOL_E = 1e-10       # spectra and energies (relative)
# tenpy_tpu's FermionSite sets charge_to_JW_parity before Site.__init__,
# which resets it to None; the port's FermionSite keeps TeNPy's [1], and
# grouped or common-charge sites built from it inherit that
JW_PARITY_DEPARTURE = {f'sites.{name}.JW_parity' for name in
                       ('grouped_fermions', 'species_up', 'species_down',
                        'common_fermion')}


@pytest.fixture(scope='module')
def ref():
    return exchange.load_flat(tx.MODELS_REF)


def _check(out, ref, prefix, tol=TOL_W):
    """Every value of ``ref`` under ``prefix`` against the port's:
    strings and integers exactly, floats to ``tol`` relative to the
    largest entry (at least 1)."""
    keys = sorted(k for k in ref if k.startswith(prefix + '.'))
    assert keys and sorted(out) == keys
    for k in keys:
        a, b = np.asarray(out[k]), ref[k]
        if k in JW_PARITY_DEPARTURE:
            assert (json.loads(str(a)), json.loads(str(b))) == ([1], None), k
        elif b.dtype.kind in 'US':
            assert str(a) == str(b), k
        elif b.dtype.kind in 'biu':
            assert a.shape == b.shape and np.array_equal(a, b), k
        else:
            assert a.shape == b.shape, k
            scale = max(1., float(np.abs(b).max(initial=0.)))
            assert np.abs(a - b).max(initial=0.) <= tol * scale, k


def test_sites(ref):
    _check(tx.sites_case('torch'), ref, 'sites')


def test_lattices(ref):
    _check(tx.lattices_case('torch'), ref, 'lattices')


def test_terms(ref):
    _check(tx.terms_case('torch'), ref, 'terms')


@pytest.mark.parametrize('case', list(tx.MODEL_CASES))
def test_model_W(case, ref):
    """The MPO (W, virtual charges, IdL/IdR) and, for a
    ``NearestNeighborModel``, ``H_bond`` of each model case."""
    _check(tx.model_case('torch', case), ref, f'model.{case}')


@pytest.mark.parametrize('case', ['dsl_finite', 'dsl_infinite',
                                  'dsl_fermions', 'dsl_flux'])
def test_coupling_dsl(case, ref):
    """Exponentially decaying couplings, single terms, a multi-coupling
    term, local terms by lattice index and external-flux phases."""
    _check(tx.dsl_case('torch', case), ref, f'dsl.{case}')


@pytest.mark.parametrize('case', tx.MODEL_ED_CASES)
def test_spectrum_vs_jax(case, ref):
    """The full spectrum of each finite case, from its MPO."""
    out = tx.ed_case('torch', case)[f'ed.{case}']
    expect = ref[f'ed.{case}']
    assert out.shape == expect.shape
    assert np.abs(out - expect).max() <= TOL_E * max(1., np.abs(expect).max())


def test_haldane_dmrg_vs_jax_and_ed(ref):
    """``dmrg.run`` on the finite 2x2 Haldane patch (the options of
    tests/test_models_2d.py:74): JAX's energy to 1e-10 and the ground
    energy of its charge sector by ED to 1e-8 (DMRG's own accuracy, as
    the JAX test holds it)."""
    E, psi = tx.haldane_dmrg('torch')
    E_jax = float(ref['dmrg.E'])
    assert abs(E - E_jax) <= TOL_E * abs(E_jax)
    m = tx.make_model('torch', 'haldane')
    ed = ExactDiag(m, charge_sector=psi.get_total_charge(
        only_physical_legs=True))
    ed.build_full_H_from_mpo()
    ed.full_diagonalization()
    assert abs(E - float(np.min(np.asarray(ed.E)))) <= 1e-8 * abs(E)


def test_entanglement_spectrum(ref):
    """``entanglement_spectrum`` of JAX's Haldane DMRG state loaded into
    the port, plain and resolved by the charge of each sector, against
    JAX's on its own state."""
    out = tx.spectrum_case('torch', ref)
    for prefix in ('spectrum', 'spectrum_q'):
        _check({k: v for k, v in out.items() if k.startswith(prefix + '.')},
               ref, prefix)


def test_haldane_cylinder_ramp_vs_jax(ref):
    """``device_ramp`` of the complex Haldane cylinder (Lx=1, Ly=3, half
    filling, the model of examples/chern_insulators/haldane.py) on the CPU
    through the plain kernel, stages chi 8 and 16: the charge-unit
    rescale, every sweep's energy and every update of each stage's first
    sweep against tenpy_tpu's run of the same protocol to 1e-10, and the
    written-back cell's charge (3 on 6 sites)."""
    out = tx.haldane_ramp('torch', 'chi16')
    p = 'ramp.chi16.'
    for k in ('options', 'model'):
        assert str(out[p + k]) == str(ref[p + k])
    for k in ('stage_chi', 'stage_first', 'gauge_k'):
        assert np.array_equal(out[p + k], ref[p + k]), k
    for k in ('sweep_E', 'stage_update_E0'):
        a, b = out[p + k], ref[p + k]
        assert a.shape == b.shape
        assert np.all(np.abs(a - b) <= TOL_E * np.abs(b)), k
    assert abs(float(np.sum(out[p + 'N'])) - 3.) <= 1e-10
