"""The port's quasiparticle excitations against ``tenpy_tpu``, exact results
and its own host route.

The cases of ``tests/test_plane_wave_excitation.py`` and
``tests/test_excitation_simulations.py`` run through the port on the CPU
from the states ``tenpy_tpu`` made (uniform MPS and DMRG ground states,
read from ``tests/benchmark_data/excitation_reference.npz``, written by
``python tests/torch_exchange.py --write-excitations``; no JAX runs here)
and are held to ``tenpy_tpu``'s runs: excitation energies at 1e-10 (the
same arithmetic from the same input), and to the exact dispersion or ED
with the JAX tests' tolerances; the random-seeded ``OrthogonalExcitations``
cases to ED at 1e-6 and to JAX at 1e-8 (each DMRG converges from its own
random start).  The sparse wrappers and the direct-sum Krylov vectors are
held to ``tenpy_tpu`` on small seeded operators.  The card's route
(``device_threshold=0`` on CPU tensors: the packed tensordots run the
kernel's plain version) is held to the host route at 1e-12: the matvec X
by X (a neutral and a charged X, both sum methods), the energies of a
solve and of a solve with ``orthogonal_to``.  ``orthogonal_columns`` is
checked gauge-invariantly.
"""
import numpy as np
import pytest
import torch

import torch_exchange as tx
from tenpy_tpu_torch.algorithms import mps_common
from tenpy_tpu_torch.algorithms.plane_wave_excitation import (
    MultiSitePlaneWaveExcitationEngine, PlaneWaveExcitationEngine)
from tenpy_tpu_torch.linalg import krylov_based as kr
from tenpy_tpu_torch.linalg import np_conserved as npc
from tenpy_tpu_torch.linalg import packed as pk
from tenpy_tpu_torch.linalg.charges import ChargeInfo, LegCharge
from tenpy_tpu_torch.models.spins import SpinChain
from tenpy_tpu_torch.models.tf_ising import TFIChain
from tenpy_tpu_torch.networks import exchange
from tenpy_tpu_torch.networks.momentum_mps import MomentumMPS
from tenpy_tpu_torch.networks.mps import MPS
from tenpy_tpu_torch.simulations.ground_state_search import \
    OrthogonalExcitations

torch.set_num_threads(1)

# port against tenpy_tpu on the same input: only roundoff separates them
TOL_JAX = 1e-10
# the random-seeded OrthogonalExcitations runs: each DMRG converges from
# its own random start, to ED within the JAX test's 1e-6
TOL_JAX_RANDOM = 1e-8
TOL_ED = 1e-6
# the card's route against the host route in one package
TOL_ROUTE = 1e-12
G = tx.EX_G


@pytest.fixture(scope='module')
def ref():
    return exchange.load_flat(tx.EX_REF)


def eps_exact(k):
    return 2 * np.sqrt(1 + G ** 2 - 2 * G * np.cos(k))


def folded(k):
    """The 2-site unit cell folds k and k + pi."""
    return min(eps_exact(k), eps_exact(k + np.pi))


def tfi_inf():
    return TFIChain(dict(tx.EX_TFI_INF))


@pytest.fixture(scope='module')
def tfi_u(ref):
    return tx.load_uniform(ref, 'tfi.u', tfi_inf().lat.mps_sites())


# ------------------------------------------------------ orthogonal_columns
def _isometry(dtype, drop_sector):
    """A charge-conserving isometry M (legs ``a``, ``b``) and its dense
    form; with ``drop_sector`` one sector of leg ``a`` has no block."""
    chinfo = ChargeInfo([1], ['N'])
    qa = np.array([[0]] * 3 + [[1]] * 4 + [[2]] * 2)
    qb = np.array([[0]] * 1 + [[1]] * 2 + ([] if drop_sector else [[2]]))
    la = LegCharge.from_qflat(chinfo, qa, +1)
    lb = LegCharge.from_qflat(chinfo, np.array(qb).reshape(-1, 1), -1)
    rng = np.random.default_rng(3)
    M = np.zeros((la.ind_len, lb.ind_len), dtype)
    for q in range(3):
        rows = np.nonzero(qa[:, 0] == q)[0]
        cols = np.nonzero(np.asarray(qb).reshape(-1) == q)[0]
        if len(cols):
            a = rng.standard_normal((len(rows), len(cols)))
            if dtype == complex:
                a = a + 1j * rng.standard_normal(a.shape)
            M[np.ix_(rows, cols)] = np.linalg.qr(a)[0]
    return npc.Array.from_ndarray(M, [la, lb], labels=['a', 'b']), M, qa


@pytest.mark.parametrize('dtype', [float, complex])
@pytest.mark.parametrize('drop_sector', [False, True])
def test_orthogonal_columns(dtype, drop_sector):
    """Q spans the complement of M's columns: Q^dagger Q = 1, Q Q^dagger +
    M M^dagger = 1, Q^dagger M = 0, the columns' charges those of their
    rows, a sector without a block of M completed by the identity."""
    Ma, M, qa = _isometry(dtype, drop_sector)
    Q = npc.orthogonal_columns(Ma, 'c')
    assert Q.get_leg_labels() == ('a', 'c')
    Qd = np.asarray(Q.to_ndarray())
    n = M.shape[0]
    assert Qd.shape == (n, n - M.shape[1])
    assert np.allclose(Qd.conj().T @ Qd, np.eye(Qd.shape[1]), atol=1e-13)
    assert np.allclose(Qd @ Qd.conj().T + M @ M.conj().T, np.eye(n),
                       atol=1e-13)
    assert np.allclose(Qd.conj().T @ M, 0., atol=1e-13)
    assert np.linalg.norm(np.asarray(npc.tensordot(
        Q.conj(), Ma, axes=[['a*'], ['a']]).to_ndarray())) < 1e-13
    # every column's charge (in leg c's own sign convention) is its rows'
    leg = Q.get_leg('c')
    qc = leg.to_qflat()[:, 0] * leg.qconj
    for j in range(Qd.shape[1]):
        rows = np.nonzero(np.abs(Qd[:, j]) > 1e-12)[0]
        assert len(rows) and np.all(qa[rows, 0] == -qc[j])
    assert Q.qtotal == Ma.qtotal


def test_construct_orthogonal_vs_jax(ref):
    """tests/test_plane_wave_excitation.py:13 on JAX's DMRG state: VL^dag
    AL = 0, VL^dag VL = 1, the complement as wide as JAX's."""
    out = tx.excitation_case('torch', 'construct_orthogonal', ref)
    assert out['construct_orthogonal.ov'] < 1e-10
    assert out['construct_orthogonal.idty'] < 1e-10
    assert out['construct_orthogonal.n_complement'] == \
        ref['construct_orthogonal.n_complement']


# -------------------------------------------------- plane-wave excitations
def test_tfi_dispersion_vs_jax(ref):
    """tests/test_plane_wave_excitation.py:28 from JAX's uniform state:
    each energy JAX's (1e-10) and the exact folded dispersion (1e-8)."""
    out = tx.excitation_case('torch', 'tfi', ref)
    for key in ('lambda_C1', 'energy_density'):
        assert abs(float(out[f'tfi.{key}']) - float(ref[f'tfi.{key}'])) \
            < TOL_JAX
    for k, p in enumerate(tx.EX_MOMENTA):
        E = float(out[f'tfi.E{k}'])
        assert abs(E - float(ref[f'tfi.E{k}'])) < TOL_JAX, (p, E)
        assert abs(E - folded(p)) < 1e-8
        assert int(out[f'tfi.L{k}']) == 2


def test_multi_site_vs_jax(ref):
    """tests/test_plane_wave_excitation.py:55 from JAX's uniform state, the
    two-site window at k = pi/2: JAX's energy (1e-10), the single-site
    engine's (JAX's run of it, 1e-7) and the exact dispersion (1e-7).  The
    size-1 window runs in the next test; k = 0 (in the reference file) is
    cut for time (11-14 s a run)."""
    m = tfi_inf()
    u = tx.load_uniform(ref, 'multi.u', m.lat.mps_sites())
    k, p = 1, tx.EX_MOMENTA[1]
    Es, psis, N = MultiSitePlaneWaveExcitationEngine(
        u, m, {'excitation_size': 2,
               'lanczos_params': {'N_max': 40}}).run(p)
    E = float(np.real(Es[0]))
    assert abs(E - float(ref[f'multi.Ems2_{k}'])) < TOL_JAX
    assert abs(E - float(ref[f'multi.E1_{k}'])) < 1e-7
    assert abs(E - folded(p)) < 1e-7
    assert psis[0].n_sites == 2


def test_multi_site_size1_vs_jax(ref):
    """tests/test_plane_wave_excitation.py:55's size-1 window at k = pi/2
    ("size=1 must equal the single-site engine"): JAX's multi-site energy
    and JAX's single-site engine's (both 1e-10), the exact dispersion
    (1e-7)."""
    m = tfi_inf()
    u = tx.load_uniform(ref, 'multi.u', m.lat.mps_sites())
    k, p = 1, tx.EX_MOMENTA[1]
    Es, psis, N = MultiSitePlaneWaveExcitationEngine(
        u, m, {'excitation_size': 1,
               'lanczos_params': {'N_max': 40}}).run(p)
    E = float(np.real(Es[0]))
    assert abs(E - float(ref[f'multi.Ems1_{k}'])) < TOL_JAX
    assert abs(E - float(ref[f'multi.E1_{k}'])) < TOL_JAX
    assert abs(E - folded(p)) < 1e-7
    assert psis[0].n_sites == 1


def test_haldane_gap_vs_jax(ref):
    """tests/test_plane_wave_excitation.py:85: the S=1 chain's magnon at
    k=pi in the Sz=+1 sector (qtotal_change=[2]) from JAX's chi=24
    uniform state: JAX's gap (1e-10), 0.41048 within 5e-3."""
    out = tx.excitation_case('torch', 'haldane', ref)
    gap = float(out['haldane.gap'])
    assert abs(gap - float(ref['haldane.gap'])) < TOL_JAX
    assert abs(gap - 0.41048) < 5e-3


def test_energy_and_momentum_mps(tfi_u):
    """``energy(p, X)`` of the Ritz vector is the Lanczos energy; the
    MomentumMPS keeps X, p and its norm (1, a normalized Ritz vector)."""
    eng = PlaneWaveExcitationEngine(tfi_u, tfi_inf(), {
        'lanczos_params': {'N_max': 40}}, device='cpu')
    p = tx.EX_MOMENTA[1]
    Es, psis, N = eng.run(p)
    psi = psis[0]
    assert isinstance(psi, MomentumMPS) and psi.p == p and psi.L == 2
    assert abs(psi.norm() - 1.) < 1e-12
    assert abs(eng.energy(p, psi._X) - float(Es[0])) < 1e-10
    c = psi.copy()
    c.set_X(3, psi.get_X(0, copy=True))
    assert c.get_X(1) is not psi.get_X(1)
    st = eng.excitation_stats[-1]
    assert st['route'] == 'host' and st['steps'] == N and \
        st['matvecs'] == N and len(st['sum_iterations']) == N


def test_route_rule(tfi_u):
    """``device_threshold``: None never, 0 always, 'auto' never on the
    CPU; a number is a threshold on N."""
    m = tfi_inf()
    for thr, N, route in ((None, 10 ** 9, 'host'), (0, 1, 'device'),
                          ('auto', 10 ** 9, 'host'), (100, 99, 'host'),
                          (100, 100, 'device')):
        opts = {} if thr == 'auto' else {'device_threshold': thr}
        eng = PlaneWaveExcitationEngine(tfi_u, m, opts, device='cpu')
        assert eng.route_for(N) == route, (thr, N)


# ----------------------------------------------------------- simulations
@pytest.mark.parametrize('case', ['sim_orthogonal', 'sim_builder'])
def test_orthogonal_excitations_vs_jax(case, ref):
    """tests/test_excitation_simulations.py:13 (two excitations of the
    L=8 TFI chain) and :45 (the builder from the ground state, L=6), from
    JAX's ground state: the gaps ED's (1e-6) and JAX's (1e-8); the
    builder's perturbed state close to, but not, the ground state."""
    out = tx.excitation_case('torch', case, ref)
    gaps = out[f'{case}.gaps']
    assert len(gaps) == len(ref[f'{case}.gaps'])
    ed = out[f'{case}.ed_gaps'][:len(gaps)]
    assert np.allclose(ed, ref[f'{case}.ed_gaps'][:len(gaps)], atol=1e-10)
    assert np.allclose(gaps, ed, rtol=0, atol=TOL_ED)
    assert np.allclose(gaps, ref[f'{case}.gaps'], rtol=0,
                       atol=TOL_JAX_RANDOM)
    if case == 'sim_builder':
        assert 0.5 < float(out[f'{case}.overlap']) < 1.0 - 1e-12


def test_orthogonal_excitations_infinite_raises():
    """An infinite ground state no longer raises: it gives a segment of
    ``segment_enlarge`` unit cells in the infinite state's fixed-point
    environments, whose energy density is the transfer matrix's (the
    excitation runs themselves: tests/test_torch_segment.py)."""
    from tenpy_tpu_torch.networks.mpo import MPOTransferMatrix
    m = tfi_inf()
    psi = MPS.from_product_state(m.lat.mps_sites(), ['up', 'up'],
                                 bc='infinite')
    sim = OrthogonalExcitations(
        {'model_class': 'TFIChain', 'model_params': dict(tx.EX_TFI_INF),
         'segment_enlarge': 3, 'save_psi': False, 'output_filename': None},
        ground_state_data=psi, device='cpu')
    sim.init_model()
    sim.init_state()
    assert sim.model.lat.bc_MPS == 'segment' and sim.model.H_MPO.L == 6
    assert sim.ground_state.bc == 'segment' and sim.ground_state.L == 6
    assert sim.psi.bc == 'segment'
    assert set(sim.init_env_data) >= {'init_LP', 'init_RP'}
    _, Es, _ = MPOTransferMatrix.find_init_LP_RP(m.H_MPO, psi, calc_E=True)
    assert abs(sim.results['ground_state_energy_density']
               - float(np.real(Es[0]))) < 1e-12


def test_plane_wave_excitations_driver_vs_jax(ref):
    """tests/test_excitation_simulations.py:80 through the simulation on
    JAX's uniform state: JAX's energies (1e-10), the exact dispersion
    (1e-7)."""
    out = tx.excitation_case('torch', 'sim_plane_wave', ref)
    assert np.allclose(out['sim_plane_wave.momenta'],
                       ref['sim_plane_wave.momenta'])
    assert np.allclose(out['sim_plane_wave.energies'],
                       ref['sim_plane_wave.energies'], rtol=0, atol=TOL_JAX)
    for p, Es in zip(out['sim_plane_wave.momenta'],
                     out['sim_plane_wave.energies']):
        assert abs(Es[0] - folded(p)) < 1e-7


# ------------------------------------------- operators and Krylov vectors
def test_operators_vs_jax(ref):
    """Sum, Shift, Boost and Orthogonal wrappers, their adjoints, and
    Lanczos, Arnoldi and GMRES on two-vector lists (a hermitian direct-sum
    operator), against tenpy_tpu: JAX's values (1e-12; Lanczos's vector
    up to its phase)."""
    out = tx.excitation_case('torch', 'operators', ref)
    for key in ('sum', 'shift', 'boost', 'ortho', 'sum_adj', 'shift_adj',
                'boost_list', 'gmres_x', 'lanczos_E', 'arnoldi_E'):
        assert np.allclose(out[f'operators.{key}'], ref[f'operators.{key}'],
                           rtol=0, atol=1e-12), key
    v, w = out['operators.lanczos_psi'], ref['operators.lanczos_psi']
    assert abs(abs(np.vdot(v, w)) - 1.) < 1e-12


def test_packed_list_krylov():
    """Lanczos, Arnoldi and GMRES on lists of PackedArrays (CPU tensors)
    give the host lists' results (1e-12): the packed helpers of
    krylov_based."""
    arrays = tx.ex_operator_input('torch')
    Mat, block = tx.ex_operators('torch', arrays)
    packed = {k: pk.pack(a, pad=False, device='cpu')
              for k, a in arrays.items()}
    Ch = arrays['C'].conj().itranspose(['p', 'p*'])
    Chp = pk.pack(Ch, pad=False, device='cpu')

    class Block:
        def matvec(self, v):
            a, b = v

            def mv(M, x):
                return pk.tensordot(M, x, axes=(['p*'], ['p']))
            return [mv(packed['H1'], a) + mv(packed['C'], b),
                    mv(Chp, a) + mv(packed['H2'], b)]

    v0h = [arrays['v'], arrays['w']]
    v0p = [packed['v'], packed['w']]
    opts = {'N_max': 14, 'N_min': 14, 'P_tol': 0.}
    Eh, psih, _ = kr.LanczosGroundState(block, v0h, opts).run()
    Ep, psip, _ = kr.LanczosGroundState(Block(), v0p, opts).run()
    assert abs(Eh - Ep) < TOL_ROUTE
    dense_p = np.concatenate([np.asarray(pk.unpack(x).to_ndarray())
                              for x in psip])
    assert abs(abs(np.vdot(tx._dense(psih), dense_p)) - 1.) < TOL_ROUTE
    aopts = dict(opts, which='SR', num_ev=2)
    eh = kr.Arnoldi(block, v0h, aopts).run()[0]
    ep = kr.Arnoldi(Block(), v0p, aopts).run()[0]
    assert np.allclose(eh, ep, rtol=0, atol=TOL_ROUTE)
    from tenpy_tpu_torch.linalg.sparse import ShiftNpcLinearOperator
    xh, _ = kr.GMRES(ShiftNpcLinearOperator(block, 9.), [x * 0. for x in v0h],
                     v0h, {'N_max': 14, 'res': 1e-13}).run()
    xp, _ = kr.GMRES(ShiftNpcLinearOperator(Block(), 9.),
                     [x * 0. for x in v0p], v0p,
                     {'N_max': 14, 'res': 1e-13}).run()
    assert np.allclose(tx._dense(xh), np.concatenate(
        [np.asarray(pk.unpack(x).to_ndarray()) for x in xp]), rtol=0,
        atol=TOL_ROUTE)


# ---------------------------------------------- the card's route on the CPU
@pytest.fixture(scope='module')
def spin1_u():
    """A seeded random canonical state of the S=1 chain (Sz conserved,
    chi=8) as a uniform MPS: the charged route's input (the matvec is
    compared, not a physical energy)."""
    from tenpy_tpu_torch.networks.uniform_mps import UniformMPS
    m = SpinChain(dict(tx.EX_SPIN1))
    psi = MPS.from_desired_bond_dimension(m.lat.mps_sites(), 8,
                                          bc='infinite', seed=5)
    return m, UniformMPS.from_MPS(psi)


def _padding_zero(x, orig_legs):
    """Every entry of the packed ``x`` outside the unpadded legs' sector
    sizes is exactly zero."""
    for q, d in zip(x.qdatas, x.data):
        for i, row in enumerate(q):
            shape = tuple(int(l.slices[s + 1] - l.slices[s])
                          for l, s in zip(orig_legs, row))
            blk = d[i].clone()
            blk[tuple(slice(0, n) for n in shape)] = 0
            if bool(blk.any()):
                return False
    return True


def _rel(a, b):
    num = sum(float(npc.norm(x - y)) ** 2 for x, y in zip(a, b)) ** .5
    return num / sum(float(npc.norm(y)) ** 2 for y in b) ** .5


@pytest.mark.parametrize('method', ['explicit', 'GMRES'])
@pytest.mark.parametrize('charge', [None, [2]])
def test_packed_matvec_vs_host(method, charge, spin1_u):
    """One matvec of the card's route (packed, CPU tensors) against the
    host route's on the same X: a neutral and a charged (Sz=+1) X, the
    explicit and the GMRES sums, at 1e-12; the padding stays zero."""
    m, u = spin1_u
    eng = PlaneWaveExcitationEngine(u, m, {
        'sum_method': method, 'sum_tol': 1e-8,
        'GMRES_params': {'N_max': 10, 'res': 1e-10},
        'lanczos_params': {'N_max': 4}}, device='cpu')
    X = eng.initial_guess(charge)
    p = 0.9
    host = eng._effective_H(p, eng.tensors('host')).matvec(X)
    T = eng.tensors('device')
    out_p = eng._effective_H(p, T).matvec(T.vector(X))
    card = T.to_host(out_p, X)
    assert _rel(card, host) < TOL_ROUTE
    for x, X0 in zip(out_p, X):
        assert _padding_zero(x, [X0.get_leg(l) for l in x.get_leg_labels()])
    assert T.ops.n_contract > 0


def test_packed_solve_vs_host(spin1_u):
    """A solve on the card's route (``device_threshold=0``, CPU tensors)
    against the host route on the charged S=1 state: the energy (1e-12),
    and a second solve with the first one's X in ``orthogonal_to``
    (1e-12); the route and counts in ``excitation_stats``."""
    m, u = spin1_u
    opts = {'lanczos_params': {'N_max': 8, 'N_min': 8, 'P_tol': 0.},
            'sum_tol': 1e-8}
    p = tx.EX_MOMENTA[1]
    res = {}
    for thr in (None, 0):
        eng = PlaneWaveExcitationEngine(u, m, dict(
            opts, device_threshold=thr), device='cpu')
        E1, psis, _ = eng.run(p, qtotal_change=[2])
        E2, _, _ = eng.run(p, qtotal_change=[2],
                           orthogonal_to=[psis[0]._X], E_boosts=[5.])
        res[thr] = (float(E1[0]), float(E2[0]), eng.excitation_stats)
    assert abs(res[0][0] - res[None][0]) < TOL_ROUTE
    assert abs(res[0][1] - res[None][1]) < TOL_ROUTE
    assert res[0][1] > res[0][0] + 1e-3    # the boost lifted the first
    st = res[0][2][0]
    assert st['route'] == 'device' and st['tensordots'] > 0 and \
        st['host_reads'] > 0
    assert res[None][2][0]['route'] == 'host'
    assert mps_common.DEVICE_EXCITATION_THRESHOLD is None or \
        mps_common.DEVICE_EXCITATION_THRESHOLD > 0
