"""The port's canonical form, eigensolvers and measurements against
``tenpy_tpu``.

* (a) ``canonical_form`` of the chi=16 Ly=2 cylinder state
  (``hubbard_cyl_ly2_chi16_exchange.npz``) spoiled by seeded per-bond,
  per-sector invertible gauges, in both packages (and the plateau path
  ``canonical_form_infinite1`` directly; a finite chain by
  ``canonical_form_finite``): sorted Schmidt values within 1e-10,
  ``norm_test`` at most 1e-12 in each, TM energy within 1e-10 relative;
  ``compress_svd`` keeps the same Schmidt values.
* (b) ``correlation_length`` and ``TransferMatrix.eigenvectors(num_ev=3)``
  within 1e-8.
* (c) ``find_init_LP_RP(method='arnoldi')`` against the port's GMRES route
  and ``tenpy_tpu``'s Arnoldi route: environments within 1e-10 of the
  largest entry, energies within 1e-12.
* (d) ``Arnoldi`` and ``FlatLinearOperator.eigenvectors`` on a seeded
  charge-conserving operator against ``numpy.linalg.eig``, 1e-12.
* (e) ``svd`` (with a cutoff), ``truncate`` and ``svd_theta`` on seeded
  charged arrays: S and the reconstruction within 1e-12, the same kept set;
  ``eigh`` likewise.
* (f) ``entanglement_entropy``, ``expectation_value(['Ntot', 'Sz'])`` and
  the TM energy of ``MPO.expectation_value`` on the infinite state (the
  finite case, by ``full_contraction``, is in ``test_torch_write_back.py``).
"""
import os

import numpy as np
import pytest
import torch

import tenpy_tpu.linalg.np_conserved as jnpc
import tenpy_tpu.linalg.truncation as jtrunc
from tenpy_tpu.linalg.charges import ChargeInfo as JChargeInfo, \
    LegCharge as JLegCharge
from tenpy_tpu.models.hubbard import FermiHubbardModel as JHubbard
from tenpy_tpu.networks.mpo import MPOTransferMatrix as JMPOTM
from tenpy_tpu.networks.mps import TransferMatrix as JTransferMatrix
from tenpy_tpu_torch.linalg import np_conserved as npc
from tenpy_tpu_torch.linalg import truncation
from tenpy_tpu_torch.linalg.charges import ChargeInfo, LegCharge
from tenpy_tpu_torch.linalg.krylov_based import Arnoldi
from tenpy_tpu_torch.linalg.sparse import FlatLinearOperator
from tenpy_tpu_torch.models.hubbard import FermiHubbardModel
from tenpy_tpu_torch.networks import exchange
from tenpy_tpu_torch.networks.mpo import MPOTransferMatrix
from tenpy_tpu_torch.networks.mps import MPS, TransferMatrix

import torch_exchange as tx

torch.set_num_threads(1)

SMALL = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     'benchmark_data', 'hubbard_cyl_ly2_chi16_exchange.npz')
JCH = JChargeInfo([1, 1], ['N', '2*Sz'])
CH = ChargeInfo([1, 1], ['N', '2*Sz'])


@pytest.fixture(scope='module')
def small():
    """The chi=16 cylinder state in both packages, with both models, and
    ``tenpy_tpu``'s environments and energies of it (its Arnoldi route;
    computed once, as they take two seconds)."""
    m, jm = FermiHubbardModel(dict(tx.SMALL_MODEL)), \
        JHubbard(dict(tx.SMALL_MODEL))
    psi = exchange.load_mps(SMALL, m.lat.mps_sites())
    jpsi = tx.mps_to_jax(psi, jm.lat.mps_sites())
    jenv = JMPOTM.find_init_LP_RP(jm.H_MPO, jpsi, calc_E=True,
                                  method='arnoldi')
    return m, jm, psi, jpsi, jenv


def _spoil(psi, seed):
    """Multiply a seeded invertible gauge ``X`` (identity plus 0.3 times a
    normal matrix, per charge block) into every bond: ``B[b-1] X`` and
    ``X^-1 B[b]``; the forms become unknown.  The state is unchanged."""
    rng = np.random.default_rng(seed)
    psi = psi.copy()
    L = psi.L
    bonds = range(L) if not psi.finite else range(1, L)
    for b in bonds:
        X = npc.eye_like(psi._B[b], 'vL', labels=['vL', 'vR'])
        X._data = [torch.eye(x.shape[0], dtype=torch.float64)
                   + 0.3 * torch.from_numpy(rng.standard_normal(x.shape))
                   for x in X._data]
        Xi = X.copy()
        Xi._data = [torch.linalg.inv(x) for x in X._data]
        psi._B[b - 1] = npc.tensordot(psi._B[b - 1], X, [['vR'], ['vL']])
        psi._B[b] = npc.tensordot(Xi, psi._B[b], [['vR'], ['vL']])
    psi.form = [None] * L
    return psi


def _schmidt_close(psi, jpsi, tol):
    for i in range(psi.L + (0 if psi.finite else 1)):
        a = np.sort(np.asarray(psi.get_SL(i)))[::-1]
        b = np.sort(np.asarray(jpsi.get_SL(i)))[::-1]
        assert len(a) == len(b) and np.abs(a - b).max() <= tol, i


@pytest.mark.parametrize('method', ['canonical_form',
                                    'canonical_form_infinite1'])
def test_canonical_form_infinite_vs_jax(small, method):
    m, jm, psi0, _, jenv = small
    psi = _spoil(psi0, 0)
    jpsi = tx.mps_to_jax(psi, jm.lat.mps_sites())
    B = psi._B[1]                      # spoiled for real: no isometry
    c = npc.tensordot(B, B.conj(), axes=[['p', 'vR'], ['p*', 'vR*']])
    assert npc.norm(c - npc.eye_like(c, 0)) > 1e-2
    getattr(psi, method)()
    getattr(jpsi, method)()
    _schmidt_close(psi, jpsi, 1e-10)
    # the plateau path gauges by Arnoldi fixed points (N_max=40): in both
    # packages it lands 3.9e-9 from canonical (norm_test) and moves the
    # Schmidt values by up to 3.9e-8, the same in both to 4e-14
    tol = 1e-12 if method == 'canonical_form' else 1e-8
    _schmidt_close(psi, psi0, tol * 10)     # the original state's
    assert np.max(psi.norm_test()) <= tol
    assert np.max(jpsi.norm_test()) <= tol
    assert psi.dtype == torch.float64
    if method == 'canonical_form':
        # the TM energy, against tenpy_tpu's of the state before the spoil
        # (canonical_form restores it to 3e-15)
        jE = np.mean(np.real(jenv[1]))
        assert abs(m.H_MPO.expectation_value(psi) - jE) <= 1e-10 * abs(jE)


def test_canonical_form_finite_vs_jax(small):
    """A finite MPS: the chi=16 cylinder state cut to one unit cell (its
    outer legs projected to one state), gauged as above; the QR and SVD
    sweeps of ``canonical_form_finite``, and the energy by
    ``full_contraction``."""
    params = dict(tx.SMALL_MODEL, bc_MPS='finite')
    m, jm = FermiHubbardModel(dict(params)), JHubbard(dict(params))
    Bs = [B.copy() for B in small[2]._B]
    for i, lab in [(0, 'vL'), (-1, 'vR')]:
        keep = np.zeros(Bs[i].get_leg(lab).ind_len, bool)
        keep[0] = True
        Bs[i].iproject(keep, lab)
    S = [np.ones(1)] + [small[2].get_SL(i) for i in range(1, 4)] + \
        [np.ones(1)]
    psi = _spoil(MPS(m.lat.mps_sites(), Bs, S, bc='finite'), 1)
    jpsi = tx.mps_to_jax(psi, jm.lat.mps_sites())
    psi.canonical_form()
    jpsi.canonical_form()
    assert min(psi.chi) > 1
    _schmidt_close(psi, jpsi, 1e-10)
    assert np.max(psi.norm_test()) <= 1e-12
    assert np.max(jpsi.norm_test()) <= 1e-12
    E = m.H_MPO.expectation_value(psi)
    jE = jm.H_MPO.expectation_value(jpsi)
    assert abs(E - jE) <= 1e-10 * abs(jE)


def test_compress_svd_vs_jax(small):
    _, jm, psi0, _, _ = small
    psi = psi0.copy()
    jpsi = tx.mps_to_jax(psi, jm.lat.mps_sites())
    par = {'chi_max': 12, 'svd_min': 1e-10}
    err, jerr = psi.compress_svd(par), jpsi.compress_svd(par)
    assert abs(err.eps - jerr.eps) <= 1e-12
    assert max(psi.chi) == 12
    _schmidt_close(psi, jpsi, 1e-10)


def test_correlation_length_and_tm_eigenvectors_vs_jax(small):
    _, _, psi, jpsi, _ = small
    xi, jxi = psi.correlation_length(), jpsi.correlation_length()
    assert abs(xi - jxi) <= 1e-8 * jxi
    etas, vecs = TransferMatrix(psi, psi).eigenvectors(num_ev=3)
    jetas, jvecs = JTransferMatrix(jpsi, jpsi).eigenvectors(num_ev=3)
    assert len(etas) == len(jetas) == 3
    assert np.abs(etas - jetas).max() <= 1e-8
    for v, jv in zip(vecs, jvecs):     # the same vectors, up to a phase
        a, b = v.to_numpy().ravel(), np.asarray(jv.to_numpy()).ravel()
        assert abs(abs(np.vdot(a, b)) - 1.) <= 1e-8


def test_find_init_LP_RP_arnoldi_vs_gmres_and_jax(small):
    m, _, psi, _, (jarn, jEs, jE0) = small
    arn, Es, E0 = MPOTransferMatrix.find_init_LP_RP(m.H_MPO, psi,
                                                    calc_E=True,
                                                    method='arnoldi')
    gm, gEs, gE0 = MPOTransferMatrix.find_init_LP_RP(m.H_MPO, psi,
                                                     calc_E=True)
    for key in ['init_LP', 'init_RP']:
        a = arn[key].to_numpy()
        assert arn[key].dtype == torch.float64
        labels = arn[key].get_leg_labels()
        assert jarn[key].get_leg_labels() == labels
        for other in (gm[key].transpose(labels).to_numpy(),
                      np.asarray(jarn[key].to_numpy())):
            assert a.shape == other.shape
            assert np.abs(a - other).max() <= 1e-10 * np.abs(other).max()
    assert np.abs(np.asarray(Es) - np.asarray(jEs)).max() <= 1e-12
    assert np.abs(np.asarray(Es) - np.asarray(gEs)).max() <= 1e-12
    assert abs(E0 - jE0) <= 1e-12 and abs(E0 - gE0) <= 1e-12


def _leg(rng, n, qconj, sizes=(3, 7)):
    """A sorted, bunched leg with ``n`` sectors of ``sizes`` states (both
    packages)."""
    charges = np.unique(rng.integers(-2, 3, size=(3 * n, 2)), axis=0)[:n]
    charges = charges[np.lexsort(charges.T)]
    sizes = rng.integers(*sizes, size=len(charges))
    slices = np.concatenate([[0], np.cumsum(sizes)])
    return (JLegCharge(JCH, slices, charges, qconj),
            LegCharge(CH, slices, charges, qconj))


def test_arnoldi_and_flat_eigenvectors_vs_numpy():
    rng = np.random.default_rng(5)
    _, leg = _leg(rng, 4, +1, sizes=(10, 17))     # ARPACK's regime
    M = npc.zeros([leg, leg.conj()], labels=['a', 'a*'])
    rows = np.array([(q, q) for q in range(leg.block_number)])
    blocks = [torch.from_numpy(rng.standard_normal((n, n))) for n in
              np.diff(leg.slices)]
    M._set_blocks(rows, blocks)
    dense = M.to_numpy()

    def matvec(v):
        return npc.tensordot(M, v, axes=[[1], [0]])

    class Op:
        pass
    op = Op()
    op.matvec = matvec
    for q in range(leg.block_number):
        sl = slice(int(leg.slices[q]), int(leg.slices[q + 1]))
        w = np.linalg.eigvals(dense[sl, sl])
        w = w[np.argsort(-np.abs(w), kind='stable')]
        v0 = npc.Array.from_ndarray(
            np.where(np.arange(leg.ind_len) < sl.stop,
                     np.where(np.arange(leg.ind_len) >= sl.start, 1., 0.),
                     0.), [leg], qtotal=leg.charges[q] * leg.qconj,
            labels=['a'])
        eta, vec, _ = Arnoldi(op, v0, {'N_max': sl.stop - sl.start,
                                       'N_min': 2}).run()
        assert abs(eta - w[0]) <= 1e-12 * abs(w[0])
        res = matvec(vec) - vec * eta
        assert npc.norm(res) <= 1e-12 * abs(eta)
        sector = tuple(leg.charges[q] * leg.qconj)
        flat = FlatLinearOperator(matvec, leg, np.float64,
                                  charge_sector=sector)
        assert flat.shape == (sl.stop - sl.start,) * 2
        etas, vecs = flat.eigenvectors(num_ev=2, which='LM')
        assert np.abs(np.abs(etas[:2]) - np.abs(w[:2])).max() \
            <= 1e-12 * abs(w[0])
        for e, v in zip(etas, vecs):
            assert npc.norm(matvec(v) - v * e) <= 1e-12 * abs(w[0])


def test_eigh_vs_jax():
    """``eigh`` per charge block of a seeded symmetric zero-charge array:
    the eigenvalues equal ``tenpy_tpu``'s, and ``V diag(W) V^T`` is the
    array, within 1e-12."""
    rng = np.random.default_rng(9)
    jleg, leg = _leg(rng, 4, +1)
    ja = jnpc.Array.from_func(lambda size: rng.standard_normal(size),
                              [jleg, jleg.conj()], qtotal=[0, 0],
                              labels=['a', 'a*'])
    ja = (ja + ja.conj().itranspose([1, 0]).iset_leg_labels(['a', 'a*'])) \
        * 0.5
    a = tx.to_host(ja)
    W, V = npc.eigh(a)
    jW, _ = jnpc.eigh(ja)
    assert np.abs(W - np.asarray(jW)).max() <= 1e-12
    dense = a.to_numpy()
    rec = V.to_numpy() @ np.diag(W) @ V.to_numpy().T
    assert np.abs(rec - dense).max() <= 1e-12 * np.abs(dense).max()


def _charged_matrix(rng):
    (jv, v), (jw, w) = _leg(rng, 5, +1), _leg(rng, 5, -1)
    qtotal = JCH.make_valid(jv.charges[1] * 1 + jw.charges[2] * -1)
    ja = jnpc.Array.from_func(lambda size: rng.standard_normal(size),
                              [jv, jw], qtotal=qtotal, labels=['a', 'b'])
    return ja, tx.to_host(ja)


@pytest.mark.parametrize('seed', [0, 1])
def test_svd_and_svd_theta_vs_jax(seed):
    rng = np.random.default_rng(seed)
    ja, a = _charged_matrix(rng)
    assert a.stored_blocks > 1
    dense = a.to_numpy()
    U, S, VH = npc.svd(a, inner_labels=['r', 'l'], qtotal_LR=[None, None])
    jU, jS, jVH = jnpc.svd(ja, inner_labels=['r', 'l'])
    assert np.abs(np.sort(S) - np.sort(np.asarray(jS))).max() <= 1e-12
    assert U.qtotal == tuple(jU.qtotal) and VH.qtotal == tuple(jVH.qtotal)
    rec = npc.tensordot(U.scale_axis(S, 'r'), VH, axes=[['r'], ['l']])
    assert np.abs(rec.to_numpy() - dense).max() <= 1e-12 * np.abs(dense).max()
    # the charge on U, and a cutoff
    cut = float(np.median(S))
    U2, S2, VH2 = npc.svd(a, cutoff=cut, qtotal_LR=[a.qtotal, None],
                          inner_labels=['r', 'l'])
    jU2, jS2, jVH2 = jnpc.svd(ja, cutoff=cut, qtotal_LR=[ja.qtotal, None],
                              inner_labels=['r', 'l'])
    assert np.array_equal(np.sort(S2), np.sort(S[S > cut]))
    assert np.abs(np.sort(S2) - np.sort(np.asarray(jS2))).max() <= 1e-12
    assert U2.qtotal == tuple(jU2.qtotal) and all(q == 0 for q in VH2.qtotal)
    assert np.array_equal(npc.svd(a, compute_uv=False), S)
    # truncate and svd_theta: the same kept set, S and reconstruction
    par = {'chi_max': len(S) - 3, 'svd_min': 1e-14, 'trunc_cut': None}
    Sn = S / np.linalg.norm(S)
    mask, norm, err = truncation.truncate(Sn, par)
    jmask, jnorm, jerr = jtrunc.truncate(Sn, par)
    assert np.array_equal(mask, np.asarray(jmask))
    assert abs(norm - jnorm) <= 1e-12 and abs(err.eps - jerr.eps) <= 1e-12
    U3, S3, VH3, err3, ren = truncation.svd_theta(a, par)
    jU3, jS3, jVH3, jerr3, jren = jtrunc.svd_theta(ja, par)
    assert np.abs(np.sort(S3) - np.sort(np.asarray(jS3))).max() <= 1e-12
    assert abs(ren - jren) <= 1e-12 * jren
    assert abs(err3.eps - jerr3.eps) <= 1e-12
    rec = npc.tensordot(U3.scale_axis(S3 * ren, 'vR'), VH3,
                        axes=[['vR'], ['vL']]).to_numpy()
    jrec = np.asarray(jnpc.tensordot(jU3.scale_axis(jS3 * jren, 'vR'), jVH3,
                                     axes=[['vR'], ['vL']]).to_numpy())
    assert np.abs(rec - jrec).max() <= 1e-12 * np.abs(dense).max()


def test_measurements_infinite_vs_jax(small):
    m, _, psi, jpsi, jenv = small
    assert np.abs(psi.entanglement_entropy()
                  - jpsi.entanglement_entropy()).max() <= 1e-12
    assert np.abs(psi.entanglement_entropy(n=2, bonds=[0, 1])
                  - jpsi.entanglement_entropy(n=2, bonds=[0, 1])).max() \
        <= 1e-12
    for ops in (['Ntot', 'Sz'], 'NuNd'):
        a, b = psi.expectation_value(ops), jpsi.expectation_value(ops)
        assert np.abs(a - np.asarray(b)).max() <= 1e-12
    # tenpy_tpu's MPO.expectation_value: the mean of its two TM energies
    jE = float(np.mean(np.real(jenv[1])))
    assert abs(m.H_MPO.expectation_value(psi) - jE) <= 1e-10 * abs(jE)
