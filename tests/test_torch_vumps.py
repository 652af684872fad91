"""The port's VUMPS against ``tenpy_tpu``'s.

The cases of ``tests/test_vumps.py`` (the ``UniformMPS`` round trip,
single-site VUMPS at L=2 and L=1, two-site VUMPS, two-site VUMPS with the
subspace-expansion and density-matrix mixers), an Sz-conserving XX chain
and a complex128 Hofstadter cylinder run through the port on the CPU
(``device='cpu'``), each from the start state ``tenpy_tpu`` made (read
from the reference file), and are held to ``tenpy_tpu``'s runs: the
energy to 1e-10, the state by gauge-invariant data (expectation values and
entanglement entropies to 1e-7; ``1 - |<port|jax>|`` per unit cell to
1e-7) and by the tests' own checks.  ``npc.polar`` is held to JAX entry by
entry (1e-12: a full-rank polar factor is unique).  The mixer guards raise
as in ``tenpy_tpu``.  ``minimal_DMRG.yml`` run as two-site VUMPS by the
command line gives JAX's energy, and the port measures the converged state
(``tenpy_tpu`` measures the initial one).  JAX's values come from
``tests/benchmark_data/vumps_reference.npz`` (``python
tests/torch_exchange.py --write-vumps``); no JAX runs here.
"""
import numpy as np
import pytest
import torch
from scipy.integrate import quad

import torch_exchange as tx
from tenpy_tpu_torch.algorithms.vumps import SingleSiteVUMPSEngine, \
    TwoSiteVUMPSEngine
from tenpy_tpu_torch.linalg import np_conserved as npc
from tenpy_tpu_torch.models.tf_ising import TFIChain
from tenpy_tpu_torch.networks import exchange
from tenpy_tpu_torch.networks.mps import MPS

torch.set_num_threads(1)

REF = tx.VUMPS_REF
# energies: converged VUMPS runs of the two packages agree to rounding
E_TOL = 1e-10
# expectation values and entropies are first order in the state, which
# converges to max_split_err (1e-8 to 1e-9) in both runs
STATE_TOL = 1e-7
# 1 - |<port|jax>| per unit cell: the dominant eigenvalue of the mixed
# transfer matrix by Arnoldi, measured -2.7e-9 to 1.0e-8 over the cases
OVERLAP_TOL = 1e-7


@pytest.fixture(scope='module')
def ref():
    return exchange.load_flat(REF)


def e0_tfi(g, J=1.):
    return -J * quad(lambda k: np.sqrt(1 + (g / J) ** 2
                                       + 2 * (g / J) * np.cos(k))
                     / (2 * np.pi), -np.pi, np.pi)[0]


@pytest.mark.parametrize('kind', ['real', 'complex'])
@pytest.mark.parametrize('side', ['right', 'left'])
def test_polar_vs_jax(kind, side, ref):
    """``a = W P`` (``P W`` on the left): W and P equal JAX's entry by
    entry, W a partial isometry, P hermitian."""
    a = tx.vumps_polar_input('torch')[kind == 'complex']
    W, P = npc.polar(a, left=side == 'left')
    tag = f'polar.{kind}.{side}'
    assert np.allclose(W.to_ndarray(), ref[tag + '.W'], rtol=0, atol=1e-12)
    assert np.allclose(P.to_ndarray(), ref[tag + '.P'], rtol=0, atol=1e-12)
    dense, Wd, Pd = (np.asarray(x.to_ndarray()) for x in (a, W, P))
    prod = Pd @ Wd if side == 'left' else Wd @ Pd
    assert np.allclose(prod, dense, rtol=0, atol=1e-12)
    assert np.allclose(Pd, Pd.conj().T, rtol=0, atol=1e-12)
    # the blocks are 2x3, 3x3 and 3x2: W is a partial isometry
    assert np.allclose(Wd @ Wd.conj().T @ Wd, Wd, rtol=0, atol=1e-12)


def test_uniform_mps_roundtrip(ref):
    """JAX's DMRG state to a UniformMPS and back (tests/test_vumps.py:18):
    valid, canonical, its Sigmaz and entropies JAX's."""
    out = tx.vumps_case('torch', 'roundtrip', ref)
    assert out['roundtrip.validity'] < 1e-7
    assert out['roundtrip.norm_err'] < 1e-8
    for key in ('sz_mps', 'sz_u', 'sz_back', 'S_u', 'S_back'):
        assert np.allclose(out[f'roundtrip.{key}'], ref[f'roundtrip.{key}'],
                           rtol=0, atol=1e-10), key
    assert np.allclose(out['roundtrip.sz_u'], out['roundtrip.sz_mps'],
                       rtol=0, atol=1e-10)


def state_overlap(case, ref, out):
    """``|<port|jax>|`` per unit cell of the two final states."""
    psi_j = tx.load_state(ref, f'{case}.psi', _sites(case))
    psi_t = tx.load_state(out, f'{case}.psi', _sites(case))
    return abs(complex(psi_t.overlap(psi_j)))


def _sites(case):
    vu = tx._VU('torch')
    if case == 'xx_sz':
        return vu.xxz_chain.XXZChain(dict(tx.VUMPS_XX)).lat.mps_sites()
    if case == 'hofstadter':
        return vu.hofstadter.HofstadterFermions(
            dict(tx.VUMPS_HOF)).lat.mps_sites()
    L = {'single_L1': 1, 'mixer_L3_SE': 3, 'mixer_L3_DMM': 3}.get(case, 2)
    return TFIChain({'L': L, 'bc_MPS': 'infinite',
                     'conserve': None}).lat.mps_sites()


# the exact energy each case is held to as in tests/test_vumps.py (None:
# not a case of it)
VUMPS_EXACT = {'single': (e0_tfi(1.5), 1e-10), 'two': (e0_tfi(1.2), 1e-9),
               'single_L1': (e0_tfi(1.5), 1e-9),
               'mixer_L2_SE': (e0_tfi(1.2), 1e-8),
               'mixer_L3_SE': (e0_tfi(1.2), 1e-8),
               'mixer_L3_DMM': (e0_tfi(1.2), 1e-8),
               'xx_sz': (None, None), 'hofstadter': (None, None)}


@pytest.mark.parametrize('case', list(VUMPS_EXACT))
def test_vumps_vs_jax(case, ref):
    """The port's run from JAX's start state: energy (1e-10), Sigmaz, Sz
    or N per site and entropies (1e-7) JAX's, the same state (overlap),
    canonical, and the exact energy of tests/test_vumps.py."""
    out = tx.vumps_case('torch', case, ref)
    E, E_ref = float(out[f'{case}.E']), float(ref[f'{case}.E'])
    assert abs(E - E_ref) < E_TOL, (E, E_ref)
    assert np.allclose(out[f'{case}.S'], ref[f'{case}.S'], rtol=0,
                       atol=STATE_TOL)
    op, op_ref = out[f'{case}.op'], ref[f'{case}.op']
    if case == 'xx_sz':
        # Sz per site is +-9e-7: the chi=24 cut inside a multiplet of the
        # spin-flip symmetric chain, decided by roundoff in either package
        op, op_ref = np.abs(op), np.abs(op_ref)
    assert np.allclose(op, op_ref, rtol=0, atol=STATE_TOL)
    assert 1. - state_overlap(case, ref, out) < OVERLAP_TOL
    assert out[f'{case}.norm_err'] < 1e-8
    e_exact, tol = VUMPS_EXACT[case]
    if e_exact is not None:
        assert abs(E - e_exact) < tol
    if case == 'two':
        assert max(out['two.chi']) > 4          # grew from chi=1
    if case == 'single_L1' or case.startswith('mixer_'):
        norm_err = float(out[f'{case}.norm_err'])
        assert abs(E - float(out[f'{case}.E_bond'])) < max(1e-8,
                                                           10 * norm_err)
    if case == 'single_L1':
        assert abs(E - float(out['single_L1.E_mpo'])) < max(1e-10,
                                                            10 * norm_err)
    if case == 'hofstadter':
        assert bool(out['hofstadter.complex'])
        assert abs(np.sum(out['hofstadter.op']) - 1.) < 1e-10


def test_vumps_mixer_guards():
    """A mixer on the single-site engine, and the density-matrix mixer on
    a two-site cell, raise NotImplementedError (tests/test_vumps.py:109)."""
    m = TFIChain({'L': 2, 'J': 1., 'g': 1.2, 'bc_MPS': 'infinite',
                  'conserve': None})
    psi = MPS.from_desired_bond_dimension(m.lat.mps_sites(), 8,
                                          bc='infinite', seed=2)
    eng = SingleSiteVUMPSEngine(psi, m, {'mixer': True, 'max_sweeps': 2,
                                         'check_overlap': False},
                                device='cpu')
    with pytest.raises(NotImplementedError):
        eng.run()
    psi2 = MPS.from_product_state(m.lat.mps_sites(), ['up', 'up'],
                                  bc='infinite')
    eng2 = TwoSiteVUMPSEngine(psi2, m, {
        'mixer': 'DensityMatrixMixer', 'max_sweeps': 2,
        'check_overlap': False, 'trunc_params': {'chi_max': 8}},
        device='cpu')
    with pytest.raises(NotImplementedError):
        eng2.run()


def test_vumps_from_yaml(ref):
    """minimal_DMRG.yml as two-site VUMPS on the infinite Heisenberg chain
    through console_main: JAX's energy (1e-10).  The port measures the
    converged state (chi 16; its MPO energy per site is the run's energy),
    tenpy_tpu the initial Neel state (chi 1; ROADMAP Queue 3)."""
    out = tx.vumps_case('torch', 'yaml', ref)
    E, E_ref = float(out['yaml.energy']), float(ref['yaml.energy'])
    assert abs(E - E_ref) < E_TOL
    assert abs(float(out['yaml.energy_MPO']) - E) < E_TOL
    assert int(out['yaml.max_chi']) == 16 and max(out['yaml.chi']) == 16
    assert int(ref['yaml.max_chi']) == 1
