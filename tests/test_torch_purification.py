"""The port's finite-temperature purification against ``tenpy_tpu``, exact
diagonalization, and its own host route.

The cases of ``tests/test_purification.py:22-269`` (and
``PurificationApplyMPO`` and ``from_density_matrix``, which that file does
not test) run through the port on the CPU and are held to ``tenpy_tpu``'s
runs of the same cases (``tests/benchmark_data/purification_reference.npz``,
written by ``python tests/torch_exchange.py --write-purification``) at
1e-10 in energies, expectation values, entropies, mutual information and
overlaps (never in gauge-dependent tensors; measured 4e-15 or closer), and
to exact diagonalization with the JAX tests' tolerances.  The card's route
of a bond update (``device_threshold=0``; the packed tensordot and split on
CPU tensors, the kernel's plain version) is held to the host route on the
same start state at 1e-12: Schmidt values, the state's overlap and the
energy after each of a few stages.  ``split_truncate``'s host cut
(``trunc_cut``) is held to ``truncate``.
"""
import functools
import itertools

import numpy as np
import pytest
import torch

import torch_exchange as tx
from tenpy_tpu_torch.algorithms import purification as pur
from tenpy_tpu_torch.algorithms.disentangler import NoiseDisentangler
from tenpy_tpu_torch.algorithms.exact_diag import ExactDiag
from tenpy_tpu_torch.linalg import np_conserved as npc
from tenpy_tpu_torch.linalg import packed as pk
from tenpy_tpu_torch.linalg import packed_split as ps
from tenpy_tpu_torch.linalg.charges import ChargeInfo, LegCharge
from tenpy_tpu_torch.linalg.truncation import truncate
from tenpy_tpu_torch.models.xxz_chain import XXZChain
from tenpy_tpu_torch.networks import exchange
from tenpy_tpu_torch.networks.mps import MPS
from tenpy_tpu_torch.networks.purification_mps import PurificationMPS, \
    convert_model_purification_canonical_conserve_ancilla_charge
from tenpy_tpu_torch.networks.site import SpinHalfSite

torch.set_num_threads(1)

# port against tenpy_tpu: the same arithmetic in the same order, so only
# LAPACK's roundoff separates them (measured 4e-15 at most)
TOL_JAX = 1e-10
# the card's route against the host route in one package
TOL_ROUTE = 1e-12


@pytest.fixture(scope='module')
def ref():
    return exchange.load_flat(tx.PU_REF)


def _same(out, ref, case, tol=TOL_JAX):
    """Every numeric value of ``case`` within ``tol`` of tenpy_tpu's."""
    keys = [k for k in out if k.startswith(case + '.')]
    assert keys and sorted(keys) == sorted(k for k in ref
                                           if k.startswith(case + '.'))
    for k in keys:
        if out[k].dtype.kind in 'fc':
            np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=tol,
                                       err_msg=k)
        else:
            assert np.array_equal(out[k], ref[k]), k


def _run(case):
    return tx.purification_case('torch', case)


def _full_H(model):
    ed = ExactDiag.from_H_mpo(model.H_MPO)
    ed.build_full_H_from_mpo()
    return ed.full_H.to_numpy()


def _thermal_E(w, beta):
    z = np.exp(-beta * (w - w[0]))
    return float(np.sum(w * z) / np.sum(z))


def _sector_E(beta, Jz=1.3, L=4):
    """The thermal energy of the open XXZ chain in the Sz=0 sector, by
    dense matrices (tests/test_purification.py)."""
    s = SpinHalfSite('Sz')
    sp, sm, sz = (s.get_op(o).to_numpy() for o in ('Sp', 'Sm', 'Sz'))

    def two(i, a, b):
        ops = [np.eye(2)] * L
        ops[i], ops[i + 1] = a, b
        return functools.reduce(np.kron, ops)

    H = sum(0.5 * (two(i, sp, sm) + two(i, sm, sp)) + Jz * two(i, sz, sz)
            for i in range(L - 1))
    Sz = sum(functools.reduce(np.kron, [sz if j == i else np.eye(2)
                                        for j in range(L)])
             for i in range(L))
    sector = np.isclose(np.diag(Sz), 0.)
    return _thermal_E(np.linalg.eigvalsh(H[np.ix_(sector, sector)]), beta)


# ------------------------------------------- the cases of test_purification
def test_infiniteT(ref):
    out = _run('infiniteT')
    _same(out, ref, 'infiniteT')
    assert np.allclose(out['infiniteT.Sz'], 0., atol=1e-14)
    assert abs(out['infiniteT.overlap'] - 1.) < 1e-12
    assert np.allclose(out['infiniteT.norm_test'], 0., atol=1e-13)


@pytest.mark.parametrize('beta', [0.5, 2.0])
def test_purification_tebd_thermal(ref, beta):
    """The XXZ chain's thermal energy: JAX's to 1e-10, ED's to 1e-3."""
    case = f'thermal_{beta}'
    out = _run(case)
    _same(out, ref, case)
    w = np.linalg.eigvalsh(_full_H(tx.bond_model(tx._TE('torch'), 'xxz',
                                                 4)))
    assert abs(float(out[case + '.E']) - _thermal_E(w, beta)) < 1e-3


def test_purification_tebd2(ref):
    out = _run('tebd2')
    _same(out, ref, 'tebd2')
    w = np.linalg.eigvalsh(_full_H(tx.bond_model(tx._TE('torch'), 'xxz',
                                                 4)))
    assert abs(float(out['tebd2.E']) - _thermal_E(w, 1.)) < 1e-3


def test_disentangler_renyi(ref):
    """The Renyi disentangler: energies and entropies JAX's; the energy
    the plain run's (an ancilla gauge), the entropy not larger."""
    out = _run('renyi')
    _same(out, ref, 'renyi')
    assert abs(out['renyi.E_plain'] - out['renyi.E_dis']) < 1e-6
    assert np.max(out['renyi.S_dis']) <= np.max(out['renyi.S_plain']) + 0.05


def test_disentangler_graddesc(ref):
    out = _run('graddesc')
    _same(out, ref, 'graddesc')
    assert abs(out['graddesc.E_plain'] - out['graddesc.E_dis']) < 1e-6


def test_from_infiniteT_canonical(ref):
    """Equal weight on the basis states of fixed Sz: correlations exact to
    1e-10, as in the JAX test."""
    out = _run('canonical')
    _same(out, ref, 'canonical')
    L = 4
    states = [s for s in itertools.product([0.5, -0.5], repeat=L)
              if sum(s) == 0]
    assert np.allclose(out['canonical.Sz'], 0., atol=1e-12)
    for i, j in ((0, 1), (0, 3), (1, 2)):
        exact = np.mean([s[i] * s[j] for s in states])
        assert abs(out[f'canonical.corr{i}{j}'] - exact) < 1e-10
    states2 = [s for s in itertools.product([0.5, -0.5], repeat=L)
               if sum(s) == 1.]
    for i in range(L):
        assert abs(out['canonical.Sz2'][i]
                   - np.mean([s[i] for s in states2])) < 1e-10


def test_from_infiniteT_canonical_conserve_ancilla(ref):
    """The doubled charges give the single-charge ensemble's observables."""
    out = _run('canonical_ancilla')
    _same(out, ref, 'canonical_ancilla')
    assert int(out['canonical_ancilla.qnumber']) == 2
    assert str(out['canonical_ancilla.names'][1]).endswith('ancilla')
    for k in ('Sz', 'S', 'corr01_', 'corr03_'):
        np.testing.assert_allclose(out[f'canonical_ancilla.{k}1'],
                                   out[f'canonical_ancilla.{k}2'], rtol=0,
                                   atol=1e-10)


def test_purification_tebd_canonical_ancilla(ref):
    """TEBD in the canonical ensemble with conserved ancilla charges: the
    energy JAX's, and the fixed-Sz thermal value's to 1e-4."""
    out = _run('tebd_canonical_ancilla')
    _same(out, ref, 'tebd_canonical_ancilla')
    assert abs(float(out['tebd_canonical_ancilla.E']) - _sector_E(1.)) < 1e-4
    assert int(out['tebd_canonical_ancilla.qnumber']) == 2


def test_entanglement_entropy_segment_and_mutinf(ref):
    """Segment entropies and mutual information: JAX's on the infinite-T
    and on a thermal state; on the infinite-T state S_p = S_q = n log 2,
    S_pq = 0, no mutual information."""
    out = _run('segment')
    _same(out, ref, 'segment')
    assert np.allclose(out['segment.S_p'], 2 * np.log(2), atol=1e-10)
    assert np.allclose(out['segment.S_q'], 2 * np.log(2), atol=1e-10)
    assert np.allclose(out['segment.S_pq'], 0., atol=1e-10)
    assert np.allclose(out['segment.S_nc'], 2 * np.log(2), atol=1e-10)
    psi = PurificationMPS.from_infiniteT([SpinHalfSite('Sz')] * 4)
    coords, mutinf = psi.mutinf_two_site(legs='p')
    assert np.allclose(mutinf, 0., atol=1e-10) and len(coords) == 6
    assert out['segment.mutinf_p'].max() > 1e-3


def test_update_imag_second_order(ref):
    """The canonical-form-keeping imaginary update is second order in dt."""
    out = _run('second_order')
    _same(out, ref, 'second_order')
    errs = [abs(float(out[f'second_order.E{k}']) - _sector_E(1.))
            for k in range(2)]
    assert errs[0] < 1e-4
    assert 3.0 < errs[0] / errs[1] < 5.0


# ------------------------------------------------------ the rest of the port
def test_apply_mpo(ref):
    """exp(-beta H / 2) by PurificationApplyMPO: JAX's energy, and the
    thermal one's up to the W_II approximation."""
    out = _run('apply_mpo')
    _same(out, ref, 'apply_mpo')
    w = np.linalg.eigvalsh(_full_H(XXZChain(dict(tx.PU_XXZ13))))
    assert abs(float(out['apply_mpo.E']) - _thermal_E(w, 1.)) < 1e-2


def test_from_density_matrix(ref):
    """The purification of exp(-H) / Z: Tr(rho H) to 1e-12, JAX's
    state."""
    out = _run('density_matrix')
    _same(out, ref, 'density_matrix')
    assert abs(out['density_matrix.E'] - out['density_matrix.E_exact']) \
        < 1e-12


def test_mps_rho_segment_and_mutinf():
    """The base MPS's segment density matrix, entropies and mutual
    information against the dense state's partial traces."""
    rng = np.random.default_rng(3)
    sites = [SpinHalfSite(None)] * 4
    vec = rng.standard_normal(16)
    vec /= np.linalg.norm(vec)
    psi = MPS.from_full(sites, npc.Array.from_ndarray(
        vec.reshape([2] * 4), [s.leg for s in sites],
        labels=['p0', 'p1', 'p2', 'p3']))
    full = vec.reshape([2] * 4)

    def rho_dense(seg):
        rest = [k for k in range(4) if k not in seg]
        t = np.transpose(full, list(seg) + rest).reshape(2 ** len(seg), -1)
        return t @ t.T

    def S(rho):
        p = np.linalg.eigvalsh(rho)
        p = p[p > 1e-30]
        return -np.sum(p * np.log(p))

    for seg in ([1], [0, 1], [0, 2], [1, 3], [0, 1, 3]):
        rho = psi.get_rho_segment(seg)
        n = len(seg)
        rho = rho.combine_legs([[f'p{k}' for k in range(n)],
                                [f'p{k}*' for k in range(n)]],
                               qconj=[+1, -1]).to_numpy()
        np.testing.assert_allclose(rho, rho_dense(seg), rtol=0, atol=1e-12)
        if n == 2:
            assert abs(psi.entanglement_entropy_segment(seg)
                       - S(rho_dense(seg))) < 1e-12
    coords, mutinf = psi.mutinf_two_site()
    for (i, j), I in zip(coords, mutinf):
        exact = S(rho_dense([i])) + S(rho_dense([j])) - S(rho_dense([i, j]))
        assert abs(I - exact) < 1e-12


def _xxz(L, **kw):
    return XXZChain(dict({'L': L, 'Jxx': 1., 'Jz': 0.6, 'hz': 0.1,
                          'bc_MPS': 'finite'}, **kw))


def _energy(eng):
    return np.sum(eng.bond_energies()) / float(np.real(
        eng.psi.overlap(eng.psi)))


def _packed_route_case(case):
    """Start state, model, engine class, options and run of one case."""
    opts = {'trunc_params': {'chi_max': 12, 'svd_min': 1e-10}, 'dt': 0.05,
            'order': 2}
    m = _xxz(6)
    if case == 'canonical_ancilla':
        psi = PurificationMPS.from_infiniteT_canonical(
            m.lat.mps_sites(), [0], conserve_ancilla_charge=True)
        m = convert_model_purification_canonical_conserve_ancilla_charge(m)
    else:
        psi = PurificationMPS.from_infiniteT(m.lat.mps_sites())
    cls = pur.PurificationTEBD2 if case == 'tebd2' else pur.PurificationTEBD
    if case == 'renyi':
        opts['disentangle'] = 'renyi'
        opts['disent_max_iter'] = 4
    if case == 'real_backwards':
        pur.PurificationTEBD(psi, m, dict(opts), device='cpu') \
            .run_imaginary(0.4)
        opts.update(disentangle='backwards', N_steps=2)

        def run(eng):
            eng.run()
    else:
        def run(eng):
            eng.run_imaginary(0.2)
    return psi, m, cls, opts, run


@pytest.mark.parametrize('case', ['imag', 'tebd2', 'renyi', 'real_backwards',
                                  'canonical_ancilla'])
def test_packed_route_vs_host(case):
    """The card's route on CPU tensors (``device_threshold=0``: every
    update) against the host route from the same state, after each of
    three stages: sorted Schmidt values of every bond, the two states'
    overlap and the energy to 1e-12; every update took the expected
    route."""
    psi0, m, cls, opts, run = _packed_route_case(case)
    engs = {}
    for thr in (None, 0):
        engs[thr] = cls(psi0.copy(), m, dict(opts, device_threshold=thr),
                        device='cpu')
    for _ in range(3):
        for eng in engs.values():
            run(eng)
        host, dev = engs[None].psi, engs[0].psi
        for b in range(1, host.L):
            Sh, Sd = np.sort(host.get_SL(b)), np.sort(dev.get_SL(b))
            assert Sh.shape == Sd.shape
            np.testing.assert_allclose(Sd, Sh, rtol=0, atol=TOL_ROUTE)
        ov = abs(complex(host.overlap(dev))) / np.sqrt(
            abs(complex(host.overlap(host))) * abs(complex(dev.overlap(dev))))
        assert 1. - ov < TOL_ROUTE
        assert abs(_energy(engs[0]) - _energy(engs[None])) < TOL_ROUTE
    routes = {r for _, _, r, _ in engs[0].update_stats}
    assert routes == {'device_split' if case == 'renyi' else 'device'}
    assert {r for _, _, r, _ in engs[None].update_stats} == {'host'}


def test_backwards_disentangler_real_time():
    """U_p conj(U)_q leaves the infinite-temperature state as it is: in
    real time with 'backwards' the bond dimension stays 1 on either
    route, and the plain run's energy is the backwards run's."""
    m = _xxz(4)
    for thr in (None, 0):
        psi = PurificationMPS.from_infiniteT(m.lat.mps_sites())
        eng = pur.PurificationTEBD(psi, m, {
            'trunc_params': {'chi_max': 16, 'svd_min': 1e-10}, 'dt': 0.1,
            'N_steps': 3, 'disentangle': 'backwards',
            'device_threshold': thr}, device='cpu')
        eng.run()
        assert psi.chi == [1, 1, 1]
    psi0 = PurificationMPS.from_infiniteT(m.lat.mps_sites())
    pur.PurificationTEBD(psi0, m, {'dt': 0.05, 'trunc_params': {
        'chi_max': 16, 'svd_min': 1e-12}}, device='cpu').run_imaginary(0.5)
    E = []
    for dis in (None, 'backwards'):
        eng = pur.PurificationTEBD(psi0.copy(), m, {
            'trunc_params': {'chi_max': 64, 'svd_min': 1e-12}, 'dt': 0.1,
            'N_steps': 2, 'disentangle': dis}, device='cpu')
        eng.run()
        E.append(_energy(eng))
    assert abs(E[0] - E[1]) < 1e-10


def test_noise_disentangler():
    """The seeded noise disentangler: U unitary, the state's norm and
    energy unchanged; the same seed, the same U."""
    m = _xxz(4)
    psi = PurificationMPS.from_infiniteT(m.lat.mps_sites())
    eng = pur.PurificationTEBD(psi, m, {'dt': 0.05, 'disent_seed': 7},
                               device='cpu')
    eng.run_imaginary(0.5)
    theta = psi.get_theta(1, 2)
    h = m.H_bond[2]
    Us = []
    for _ in range(2):
        eng.options['disent_seed'] = 7
        th2, U = NoiseDisentangler(eng)(theta)
        Us.append(U.to_numpy())
        Um = U.combine_legs([['q0', 'q1'], ['q0*', 'q1*']]).to_numpy()
        assert np.abs(Um @ Um.conj().T - np.eye(len(Um))).max() < 1e-12
        assert abs(npc.norm(th2) - npc.norm(theta)) < 1e-12

        def e(th):
            hth = npc.tensordot(h, th, axes=[['p0*', 'p1*'], ['p0', 'p1']])
            return complex(npc.inner(th, hth, axes='labels', do_conj=True))
        assert abs(e(th2) - e(theta)) < 1e-12
    assert np.array_equal(Us[0], Us[1])


def _random_theta(rng):
    ch = ChargeInfo([1], ['2*Sz'])
    vL = LegCharge.from_qflat(ch, [[q] for q in rng.integers(-3, 4, 40)], +1)
    vL = vL.sort()[1]
    p = LegCharge.from_qflat(ch, [[1], [-1], [1], [-1]], +1).sort()[1]
    decay = np.exp(-np.arange(40) / 4.)
    theta = npc.Array.from_func(lambda size: rng.standard_normal(size),
                                [vL, p, p, vL.conj()], qtotal=[0],
                                labels=['vL', 'p0', 'p1', 'vR'])
    # a spectrum over many decades: scale the vL directions
    return theta.iscale_axis(decay[:vL.ind_len], 'vL')


@pytest.mark.parametrize('opts', [
    {'chi_max': 20, 'svd_min': 1e-14, 'trunc_cut': 1e-14},
    {'chi_max': 100, 'svd_min': 1e-3, 'trunc_cut': None},
    {'chi_max': 100, 'svd_min': 1e-14, 'trunc_cut': 1e-2},
    {'chi_max': 0, 'svd_min': None, 'trunc_cut': 1e-4}])
def test_split_truncate_trunc_cut(opts):
    """``split_truncate`` with a ``trunc_cut`` keeps the values that the
    host ``truncate`` keeps after the host SVD: the same count, the kept
    Schmidt values to 1e-12, err and renorm to 1e-12."""
    theta = _random_theta(np.random.default_rng(11))
    U, S, VH = npc.svd(theta.combine_legs([['vL', 'p0'], ['p1', 'vR']],
                                          qconj=[+1, -1]))
    nrm = np.linalg.norm(S)
    mask, norm_new, err = truncate(S / nrm, dict(opts))
    kept = np.sort(S[mask] / nrm / norm_new)
    thp = pk.pack(theta, multiple=16, pad_labels=('vL', 'vR'), device='cpu')
    q0 = np.zeros(1, np.int64)
    bond = ps.bond_layout(thp.legs, thp.qtotal, q0, multiple=16,
                          full_rank=True)
    plan = ps.split_plan(thp, bond, q0, group_multiple=16)
    _, Sp, _, perr, pren, n = ps.split_truncate(
        thp, plan, opts['chi_max'], opts['svd_min'],
        trunc_cut=opts['trunc_cut'] or 0.)
    Sp = np.sort(Sp.numpy()[Sp.numpy() > 0])
    assert int(n) == mask.sum() == len(Sp)
    assert 3 < len(Sp) < len(S)
    np.testing.assert_allclose(Sp, kept, rtol=0, atol=1e-12)
    assert abs(float(perr) - err.eps) < 1e-12
    assert abs(float(pren) - nrm * norm_new) < 1e-12 * nrm


def test_card_route_options():
    """On the CPU the default rule keeps every update on the host; the
    card's split has no chi_min or degeneracy_tol and raises; without a
    card the default device raises."""
    m = _xxz(4)
    psi = PurificationMPS.from_infiniteT(m.lat.mps_sites())
    eng = pur.PurificationTEBD(psi, m, {'dt': 0.05}, device='cpu')
    eng.run_imaginary(0.2)
    assert {r for _, _, r, _ in eng.update_stats} == {'host'}
    assert eng.route(10 ** 9) == 'host'
    for extra in ({'chi_min': 4}, {'degeneracy_tol': 1e-8}):
        eng = pur.PurificationTEBD(psi.copy(), m, {
            'dt': 0.05, 'device_threshold': 0,
            'trunc_params': dict({'chi_max': 8}, **extra)}, device='cpu')
        with pytest.raises(NotImplementedError):
            eng.run_imaginary(0.1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pur.PurificationTEBD(psi, m, {'dt': 0.05})
