"""The port's device TEBD engine and what it runs on, against ``tenpy_tpu``.

* The Suzuki-Trotter tables and the bond gates (``calc_U_bond``, the port
  of ``TEBDEngine._calc_U_bond``) of the three spin models, real and
  imaginary time, against ``tenpy_tpu``'s, called directly (cheap).
* The spin sites and models: legs, operators, ``H_bond`` and ``H_MPO``.
* ``DeviceTEBDEngine`` on ``device='cpu'``, the port of
  ``tests/test_packed_tebd.py``: real time on the S=1 chain (finite L=8
  and infinite L=2, from ``tenpy_tpu``'s host-DMRG states) and imaginary
  time on the transverse-field Ising chain with parity, held to
  ``tenpy_tpu``'s ``DeviceTEBDEngine`` on the same states.  The JAX values
  come from ``tests/benchmark_data/tebd_reference.npz``, written by
  ``python tests/torch_exchange.py --write-tebd``; no JAX engine runs here.
  The cut at chi_max=32 of the real-time cases falls between multiplets,
  so every quantity is held at 1e-10.
* ``MPS.overlap`` and ``MPSEnvironment.full_contraction`` against
  ``tenpy_tpu``'s on committed states.
"""
import numpy as np
import pytest
import torch

from tenpy_tpu.algorithms.tebd import TEBDEngine
from tenpy_tpu.models import spins as jspins, tf_ising as jtfi, \
    xxz_chain as jxxz
from tenpy_tpu.networks import mps as jmps, site as jsite
from tenpy_tpu_torch.algorithms import tebd
from tenpy_tpu_torch.algorithms.packed_tebd import DeviceTEBDEngine
from tenpy_tpu_torch.models import spins, tf_ising, xxz_chain
from tenpy_tpu_torch.networks import exchange, site
from tenpy_tpu_torch.networks.mps import MPS, MPSEnvironment

import torch_exchange as tx
from test_torch_model import _array_equal, _legs_equal

torch.set_num_threads(1)

REF = tx.os.path.join(tx.os.path.dirname(tx.os.path.abspath(__file__)),
                      'benchmark_data', 'tebd_reference.npz')
MODELS = {
    'spin1_finite': ('SpinChain', tx.spin1_params('finite', 8)),
    'spin1_infinite': ('SpinChain', tx.spin1_params('infinite', 2)),
    'tfi_parity': ('TFIChain', tx.TFI_PARAMS),
    'xxz_sorted': ('XXZChain', {'L': 2, 'Jxx': 1., 'Jz': 1.5, 'hz': 0.,
                                'bc_MPS': 'infinite', 'sort_charge': True}),
    'xxz_unsorted': ('XXZChain', {'L': 4, 'Jxx': 1., 'Jz': 1.0, 'hz': 0.3,
                                  'bc_MPS': 'finite', 'sort_charge': False}),
}
MODULES = {'SpinChain': (spins, jspins), 'TFIChain': (tf_ising, jtfi),
           'XXZChain': (xxz_chain, jxxz)}


def _models(key):
    name, params = MODELS[key]
    mod, jmod = MODULES[name]
    return (getattr(mod, name)(dict(params)),
            getattr(jmod, name)(dict(params)))


@pytest.fixture(scope='module')
def ref():
    return exchange.load_flat(REF)


@pytest.mark.parametrize('order', [1, 2, 4, '4_opt'])
@pytest.mark.parametrize('N_steps', [1, 3])
def test_suzuki_trotter_tables_vs_jax(order, N_steps):
    assert tebd.suzuki_trotter_time_steps(order) == \
        TEBDEngine.suzuki_trotter_time_steps(order)
    assert tebd.suzuki_trotter_decomposition(order, N_steps) == \
        TEBDEngine.suzuki_trotter_decomposition(order, N_steps)


@pytest.mark.parametrize('cls,kw', [
    ('SpinHalfSite', {'conserve': 'Sz'}),
    ('SpinHalfSite', {'conserve': 'parity'}),
    ('SpinHalfSite', {'conserve': 'None', 'sort_charge': False}),
    ('SpinSite', {'S': 1., 'conserve': 'Sz'}),
    ('SpinSite', {'S': 1.5, 'conserve': 'parity'}),
    ('SpinSite', {'S': 0.5, 'conserve': 'None'})])
def test_spin_sites_vs_jax(cls, kw):
    s, js = getattr(site, cls)(**kw), getattr(jsite, cls)(**kw)
    _legs_equal(s.leg, js.leg)
    assert s.opnames == js.opnames
    assert s.hc_ops == js.hc_ops
    assert s.state_labels == js.state_labels
    assert np.array_equal(s.perm, js.perm)
    for name in sorted(js.opnames):
        _array_equal(s.get_op(name), js.get_op(name), 0.)


@pytest.mark.parametrize('key', sorted(MODELS))
def test_spin_models_vs_jax(key):
    """``H_MPO`` and ``H_bond`` equal ``tenpy_tpu``'s: the same charges and
    blocks, which are sums of products of the couplings and the spin
    matrix elements (held to 1e-15)."""
    m, jm = _models(key)
    H, jH = m.H_MPO, jm.H_MPO
    assert (H.L, H.bc, H.max_range) == (jH.L, jH.bc, jH.max_range)
    assert H.IdL == jH.IdL and H.IdR == jH.IdR
    for i in range(H.L):
        _array_equal(H.get_W(i), jH.get_W(i), 1e-15)
    assert len(m.H_bond) == len(jm.H_bond)
    for h, jh in zip(m.H_bond, jm.H_bond):
        assert (h is None) == (jh is None)
        if h is not None:
            _array_equal(h, jh, 1e-15)


@pytest.mark.parametrize('type_evo', ['real', 'imag'])
@pytest.mark.parametrize('key', ['spin1_infinite', 'tfi_parity',
                                 'xxz_sorted'])
def test_calc_U_bond_vs_jax(key, type_evo):
    """Every bond gate of every substep of order 4 equals ``tenpy_tpu``'s
    within 1e-13 (the eigenvectors of the two eigensolvers differ by a
    phase per vector and a rotation in degenerate subspaces, which the
    gate does not see)."""
    m, jm = _models(key)
    for frac in tebd.suzuki_trotter_time_steps(4):
        for h, jh in zip(m.H_bond, jm.H_bond):
            if h is None:
                continue
            U = tebd.calc_U_bond(h, frac * 0.05, type_evo)
            jU = tx.to_host(TEBDEngine._calc_U_bond(None, jh, frac * 0.05,
                                                    type_evo, None))
            assert U.get_leg_labels() == jU.get_leg_labels()
            assert U.dtype == (torch.complex128 if type_evo == 'real'
                               else torch.float64) == jU.dtype
            for lp, lj in zip(U.legs, jU.legs):
                _legs_equal(lp, lj)
            assert (U.to_ndarray() - jU.to_ndarray()).abs().max() <= 1e-13


@pytest.fixture(scope='module', params=sorted(tx.TEBD_REAL_CASES))
def real_run(request, ref):
    case = request.param
    bc, L = tx.TEBD_REAL_CASES[case]
    m = spins.SpinChain(tx.spin1_params(bc, L))
    psi = tx.load_state(ref, f'{case}.psi0', m.lat.mps_sites())
    eng = DeviceTEBDEngine(psi, m, dict(tx.TEBD_REAL_OPTIONS), device='cpu')
    err = eng.run()
    S_dev = [np.sort(s.numpy()[s.numpy() > 0])[::-1] for s in eng.Sp]
    return case, m, psi, eng, err, S_dev


def test_real_time_vs_jax(real_run, ref):
    """The engine's state after 3 order-2 steps equals ``tenpy_tpu``'s:
    evolved time exactly, truncation error, Schmidt values on every bond
    (of the device state, before the write-back's re-gauge), and ``Sz``
    and the bond energies of the written-back state against those of JAX's
    written-back state after ``canonical_form()``, all within 1e-10."""
    case, m, psi, eng, err, S_dev = real_run
    assert eng.evolved_time == float(ref[f'{case}.evolved_time'])
    assert abs(err.eps - float(ref[f'{case}.trunc_err'])) <= 1e-10
    assert err.eps > 1e-9           # the cut is real
    assert eng.Bp[0].dtype == torch.complex128 and psi.dtype.is_complex
    for i, S in enumerate(S_dev):
        S_ref = ref[f'{case}.S.{i}']
        assert S.shape == S_ref.shape
        assert np.abs(S - S_ref).max() <= 1e-10
    assert np.abs(psi.expectation_value('Sz') - ref[f'{case}.Sz']).max() \
        <= 1e-10
    assert np.abs(tx.bond_energies(psi, m) - ref[f'{case}.E_bond']).max() \
        <= 1e-10


def test_real_time_write_back(real_run, ref):
    """The written-back state is the caller's MPS, complex, canonical
    (``norm_test`` below 1e-12 after the re-gauge that the truncation
    made necessary); for finite bc it is the state JAX wrote back:
    ``|1 - |<psi_port|psi_JAX>||`` below 1e-10."""
    case, m, psi, eng, err, _ = real_run
    st = eng.write_back_stats
    assert eng.psi is psi
    assert abs(st['norm_test_before'] - float(ref[f'{case}.norm_test'])) \
        <= 1e-12
    assert st['norm_test_before'] > 1e-12 and 'canonical_form_s' in st
    assert st['norm_test_after'] <= 1e-12
    assert np.max(psi.norm_test()) <= 1e-12
    psi.test_sanity()
    if psi.bc == 'finite':
        jpsi = tx.load_state(ref, f'{case}.psi', m.lat.mps_sites())
        jpsi.canonical_form()
        assert abs(1. - abs(psi.overlap(jpsi))) <= 1e-10
        assert abs(psi.overlap(psi) - 1.) <= 1e-12
    else:
        # the overlap per unit cell with itself: the dominant eigenvalue
        # of the canonical transfer matrix
        assert abs(psi.overlap(psi) - 1.) <= 1e-12


def test_imag_time_vs_jax(ref):
    """Imaginary time on the TFI chain with parity, dt 0.1 then 0.01 (20
    order-2 steps each, chi_max=16), each stage followed by
    ``canonical_form()`` as in ``tests/test_packed_tebd.py:57``: the bond
    energies and Schmidt values after each stage within 1e-10 of
    ``tenpy_tpu``'s."""
    m = tf_ising.TFIChain(dict(tx.TFI_PARAMS))
    L = tx.TFI_PARAMS['L']
    psi = MPS.from_product_state(m.lat.mps_sites(), ['up'] * L, bc='finite')
    for k, dt in enumerate(tx.TEBD_IMAG_DTS):
        eng = DeviceTEBDEngine(psi, m, dict(tx.TEBD_IMAG_OPTIONS, dt=dt),
                               device='cpu')
        err = eng.run()
        assert eng.Bp[0].dtype == torch.float64
        assert eng.write_back_stats['norm_test_after'] <= 1e-12
        psi.canonical_form()
        assert abs(eng.evolved_time - float(ref[f'imag.{k}.evolved_time'])) \
            == 0.
        assert abs(err.eps - float(ref[f'imag.{k}.trunc_err'])) <= 1e-10
        assert np.abs(tx.bond_energies(psi, m) - ref[f'imag.{k}.E_bond']) \
            .max() <= 1e-10
        for i, S in enumerate(tx.sorted_S(psi)):
            S_ref = ref[f'imag.{k}.S.{i}']
            n = min(len(S), len(S_ref))
            assert np.abs(S[:n] - S_ref[:n]).max() <= 1e-10
            assert np.all(S[n:] <= 1e-10) and np.all(S_ref[n:] <= 1e-10)
    assert psi.dtype == torch.float64


def test_device_tebd_defaults_to_the_card(ref):
    """Without ``device`` the engine puts its state on the card, and it
    raises where there is none (no fallback to the CPU)."""
    m = xxz_chain.XXZChain(dict(MODELS['xxz_sorted'][1]))
    psi = MPS.from_product_state(m.lat.mps_sites(), ['up', 'down'],
                                 bc='infinite')
    if torch.cuda.is_available():
        assert DeviceTEBDEngine(psi, m, {}).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            DeviceTEBDEngine(psi, m, {})


@pytest.mark.parametrize('order', [1, 4, '4_opt'])
def test_other_orders_conserve_norm_and_Sz(order):
    """Orders 1, 4 and 4_opt on the infinite XXZ chain from the Neel state:
    real time keeps the state normalized and canonical, and Sz per cell at
    0 (charge conservation) to 1e-12."""
    m = xxz_chain.XXZChain(dict(MODELS['xxz_sorted'][1]))
    psi = MPS.from_product_state(m.lat.mps_sites(), ['up', 'down'],
                                 bc='infinite')
    eng = DeviceTEBDEngine(psi, m, {'N_steps': 2, 'dt': 0.05,
                                    'order': order, 'chi_max': 16,
                                    'multiple': 8}, device='cpu')
    eng.run()
    assert abs(eng.evolved_time - 0.1) <= 1e-15
    assert max(psi.chi) > 1
    assert np.max(psi.norm_test()) <= 1e-12
    assert abs(np.sum(psi.expectation_value('Sz'))) <= 1e-12
    for S in tx.sorted_S(psi):
        assert abs(np.sum(S ** 2) - 1.) <= 1e-12


@pytest.mark.parametrize('i0', [0, 3, 7])
def test_overlap_and_full_contraction_vs_jax(ref, i0):
    """``MPSEnvironment(bra, ket).full_contraction(i0)`` and
    ``MPS.overlap`` of two committed finite states (the S=1 chain's
    host-DMRG state and JAX's real-time written-back state, complex and
    off canonical form at its truncation) equal ``tenpy_tpu``'s within
    1e-12, and ``<psi|psi> = 1`` for the canonical one."""
    case = 'real_finite'
    m = spins.SpinChain(tx.spin1_params('finite', 8))
    jm = jspins.SpinChain(tx.spin1_params('finite', 8))
    psi0 = tx.load_state(ref, f'{case}.psi0', m.lat.mps_sites())
    psi = tx.load_state(ref, f'{case}.psi', m.lat.mps_sites())
    jpsi0 = tx.mps_to_jax(psi0, jm.lat.mps_sites())
    jpsi = tx.mps_to_jax(psi, jm.lat.mps_sites())
    got = MPSEnvironment(psi0, psi).full_contraction(i0)
    want = jmps.MPSEnvironment(jpsi0, jpsi).full_contraction(i0)
    assert abs(got - want) <= 1e-12
    # the evolved ground state: its overlap with the start is the phase
    # exp(-i E t), far from 1
    assert abs(got - 1.) > 0.5
    assert abs(psi0.overlap(psi) - jpsi0.overlap(jpsi)) <= 1e-12
    assert abs(MPSEnvironment(psi0, psi0).full_contraction(i0) - 1.) <= 1e-12
