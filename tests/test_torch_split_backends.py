"""The split's eigh-based backends (``'qr_eigh'``, ``'qr_eigh32'``) against
``tenpy_tpu`` and against the port's own ``'svd'``.

The same seeded theta (legs ``vL, p0, p1, vR``, a decaying spectrum) is
packed by each package with the same bond layout.  ``split_truncate``
with ``'qr_eigh'`` is held to ``tenpy_tpu``'s ``'qr_eigh'`` in f64 (its
only type there: ``tenpy_tpu``'s ``qr_eigh`` has no complex path) and to
the port's ``'svd'`` in f64 and complex128.  Schmidt
values from 1e-6 of the largest agree to 1e-10 of it (the Gram matrix's
eigh squares them: an eigenvalue error of 1e-16 of the largest moves a
value at 1e-6 by 5e-11), smaller ones to 1e-7; the truncation error to
1e-12, the reconstruction ``A S B`` from the values above 1e-6 to 1e-10
(Frobenius, relative; the smaller values weigh at most 1e-12), and A's
isometry to 1e-12.
``'qr_eigh32'`` is held at ``tenpy_tpu``'s own tolerance, 1e-5
(``tests/test_packed_dmrg.py``).  ``DeviceSweepEngine`` and
``DeviceTEBDEngine`` with ``'qr_eigh'`` end where they end with ``'svd'``
on the CPU.
"""
import numpy as np
import pytest
import torch

import tenpy_tpu.linalg.np_conserved as jnpc
from tenpy_tpu.linalg import packed as jpk
from tenpy_tpu.linalg import packed_split as jps
from tenpy_tpu_torch.algorithms.packed_dmrg import DeviceSweepEngine
from tenpy_tpu_torch.algorithms.packed_tebd import DeviceTEBDEngine
from tenpy_tpu_torch.linalg import packed as pk
from tenpy_tpu_torch.linalg import packed_split as ps
from tenpy_tpu_torch.models.hubbard import FermiHubbardChain
from tenpy_tpu_torch.models.xxz_chain import XXZChain
from tenpy_tpu_torch.networks.mps import MPS

from test_torch_np_conserved import _leg
from torch_exchange import to_host

torch.set_num_threads(1)

CHI = 20
SVD_MIN = 1e-10


def _theta(seed, complex_):
    """A random theta (vL, p0, p1, vR) whose singular values decay."""
    rng = np.random.default_rng(seed)
    (jv, _), (jp, _) = _leg(rng, 6, 1), _leg(rng, 3, 1)
    legs = [jv, jp, jp, jv.conj()]

    def draw(s):
        x = rng.standard_normal(s)
        return x + 1j * rng.standard_normal(s) if complex_ else x
    jth = jnpc.Array.from_func(draw, legs, qtotal=[0, 0],
                               labels=['vL', 'p0', 'p1', 'vR'])
    jth.iscale_axis(0.6 ** np.arange(jv.ind_len), 'vL')
    jth.iscale_axis(0.8 ** np.arange(jv.ind_len), 'vR')
    return jth


@pytest.fixture(scope='module', params=[False, True], ids=['f64', 'c128'])
def case(request):
    jth = _theta(10, request.param)
    out = {}
    for name, pkg, spl, th, kw in (('jax', jpk, jps, jth, {}),
                                   ('port', pk, ps, to_host(jth),
                                    {'device': 'cpu'})):
        thp = pkg.pack(th, multiple=8, pad_labels=('vL', 'vR'), **kw)
        bond = spl.bond_layout(thp.legs, thp.qtotal, [0, 0], multiple=8)
        out[name] = (thp, spl.split_plan(thp, bond, [0, 0],
                                         group_multiple=8))
    return request.param, out


def _split(case, who, backend, expand=False):
    thp, plan = case[1][who]
    spl = ps if who == 'port' else jps
    A, S, B, err, ren, n = spl.split_truncate(thp, plan, CHI, SVD_MIN,
                                              backend=backend, expand=expand)
    return A, np.asarray(S), B, float(err), float(ren), int(n)


def _S_close(S, ref, tol=1e-10):
    assert S.shape == ref.shape
    top = np.abs(ref).max()
    big = ref >= 1e-6 * top
    assert np.abs(S - ref)[big].max() <= tol * top
    assert np.abs(S - ref).max() <= max(tol, 1e-7) * top


def _rebuilt(who, A, S, B):
    pkg, spl = (pk, ps) if who == 'port' else (jpk, jps)
    S = torch.from_numpy(S) if who == 'port' else S
    rec = pkg.tensordot(spl.scale_bond(A, S, spl.scale_bond_plan(A, 'vR')),
                        B, axes=(['vR'], ['vL']))
    rec = pkg.unpack(rec)
    return rec.to_numpy() if who == 'port' else np.asarray(rec.to_numpy())


def _isometry_err(A):
    AA = pk.unpack(pk.tensordot(A.conj(), A, axes=(['vL*', 'p*'],
                                                   ['vL', 'p'])))
    worst = 0.
    for blk in AA._data:
        blk = blk.numpy()
        d = np.diagonal(blk).real
        worst = max(worst, np.abs(d * (1. - d)).max(),
                    np.abs(blk - np.diag(d)).max())
    return worst


@pytest.mark.parametrize('backend', ['qr_eigh', 'qr_eigh32'])
@pytest.mark.parametrize('expand', [False, True])
def test_backend_vs_svd_and_jax(case, backend, expand):
    """Against the port's ``'svd'`` (f64 and complex128; held to
    tenpy_tpu's ``'svd'`` by ``tests/test_torch_split.py``) and in f64
    against tenpy_tpu's same backend.  The Gram matrix's roundoff leaves
    values of about 1e-8 of the largest where the SVD has zeros, and the
    cut keeps those above ``svd_min``: the counts of kept values agree
    from 1e-6 of the largest up."""
    complex_ = case[0]
    tol = 1e-5 if backend == 'qr_eigh32' else 1e-10
    A, S, B, err, ren, n = _split(case, 'port', backend, expand)
    refs = [('port', 'svd')] + ([] if complex_ else [('jax', backend)])
    for who, ref_backend in refs:
        rA, rS, rB, rerr, rren, rn = _split(case, who, ref_backend, expand)
        _S_close(S, rS, tol)
        assert abs(err - rerr) <= max(tol, 1e-12)
        assert abs(ren - rren) <= tol * rren
        big = 1e-6 * rS.max()
        assert n >= int(np.sum(rS >= big)) == int(np.sum(S >= big))
        # A S B from the values above 1e-6; the others weigh nothing
        small, rsmall = S < 1e-6 * S.max(), rS < 1e-6 * rS.max()
        assert np.sum(S[small] ** 2) <= 1e-12 and np.sum(rS[rsmall] ** 2) \
            <= 1e-12
        rec = _rebuilt('port', A, np.where(small, 0., S), B)
        rrec = _rebuilt(who, rA, np.where(rsmall, 0., rS), rB)
        assert np.linalg.norm(rec - rrec) <= tol * np.linalg.norm(rrec)
    assert _isometry_err(A) <= 1e-12
    assert A.dtype == (torch.complex128 if complex_ else torch.float64)


def test_decomp_qr_eigh_batches():
    """``M = U diag(S) V^H`` with orthonormal U and V and S descending, on
    tall, wide and square batches with zero rows and columns (the padding
    of a bucket group), real and complex.  A rank-deficient matrix (batch
    entries 1 and 2) has singular values at the square root of the Gram
    matrix's roundoff, about 1e-8 of the largest, with arbitrary vectors:
    it is rebuilt to 1e-7, a full-rank one to 1e-12.  The float32-seeded
    route (1e-5) on a batch holding a zero and a tiny (1e-7) matrix."""
    rng = np.random.default_rng(11)
    for dtype in (torch.float64, torch.complex128):
        for R, C in ((24, 9), (9, 24), (16, 16)):
            M = rng.standard_normal((3, R, C))
            if dtype.is_complex:
                M = M + 1j * rng.standard_normal((3, R, C))
            M = torch.from_numpy(M)
            M[1, :, C // 2:] = 0.
            M[2, R // 3:, :] = 0.
            U, S, V = ps._decomp_qr_eigh(M)
            K = min(R, C)
            assert U.shape == (3, R, K) and V.shape == (3, C, K)
            eye = torch.eye(K, dtype=dtype)
            for X in (U, V):
                assert float((X.conj().transpose(-1, -2) @ X - eye).abs()
                             .max()) <= 1e-12
            rec = (U * S[:, None, :].to(dtype)) @ V.conj().transpose(-1, -2)
            err = (rec - M).abs().amax((1, 2)) / M.abs().max()
            assert float(err[0]) <= 1e-12 and float(err.max()) <= 1e-7
            assert bool((S[:, :-1] >= S[:, 1:]).all())
            ref = torch.linalg.svdvals(M)
            assert float((S - ref).abs().max()) <= 1e-7 * float(ref.max())
            assert float((S - ref)[ref > 1e-6 * ref.max()].abs().max()) \
                <= 1e-10 * float(ref.max())
            # the float32 seed on a batch with a zero and a tiny matrix
            Mz = torch.stack([M[0], torch.zeros_like(M[0]), 1e-7 * M[0]])
            U, S, V = ps._decomp_qr_eigh(Mz, f32_seed=True)
            ref = torch.linalg.svdvals(Mz)
            assert bool(torch.isfinite(S).all() & torch.isfinite(U).all())
            assert float(S[1].abs().max()) == 0.
            for k in (0, 2):
                assert float((S[k] - ref[k]).abs().max()) <= 1e-5 * float(
                    ref[k].max())


def test_backend_names():
    """Every backend name of ``tenpy_tpu`` runs; an unknown one raises;
    ``'auto'`` on a CPU tensor takes the SVD route (``torch.linalg.svd``,
    the same values as ``'svd'``, bit for bit)."""
    thp, plan = _theta_packed()
    with pytest.raises(ValueError, match='unknown'):
        ps.split_truncate(thp, plan, CHI, SVD_MIN, backend='gesvd')
    for ok in (None, 'auto', 'svd', 'qr_eigh', 'qr_eigh32', 'jacobi',
               'jacobi32'):
        ps.split_truncate(thp, plan, CHI, SVD_MIN, backend=ok)
    calls = []
    svd = torch.linalg.svd

    def counted(*a, **kw):
        calls.append(1)
        return svd(*a, **kw)

    torch.linalg.svd = counted
    try:
        auto = ps.split_truncate(thp, plan, CHI, SVD_MIN, backend='auto')
    finally:
        torch.linalg.svd = svd
    assert len(calls) == len(plan.groups)
    ref = ps.split_truncate(thp, plan, CHI, SVD_MIN, backend='svd')
    assert torch.equal(auto[1], ref[1])


def _theta_packed():
    thp = pk.pack(to_host(_theta(12, False)), multiple=8,
                  pad_labels=('vL', 'vR'), device='cpu')
    bond = ps.bond_layout(thp.legs, thp.qtotal, [0, 0], multiple=8)
    return thp, ps.split_plan(thp, bond, [0, 0], group_multiple=8)


def test_engines_run_the_backends():
    """The device sweep engine (finite Hubbard chain, exact regime) and the
    device TEBD engine (real time, complex128) on the CPU with
    ``'qr_eigh'``: the same sweep energy as with ``'svd'`` to 1e-10, and
    Schmidt values (from 1e-6 up) and Sz to 1e-8.  These are first order in
    the state, and the splits keep the directions of the Gram matrix's
    roundoff (about 1e-8 of the largest value) in it; the energy is second
    order."""
    chain = {'L': 6, 'bc_MPS': 'finite', 't': 1., 'U': 4., 'mu': 0.}
    res = {}
    for backend in ('svd', 'qr_eigh'):
        m = FermiHubbardChain(dict(chain))
        psi = MPS.from_product_state(m.lat.mps_sites(), ['up', 'down'] * 3)
        eng = DeviceSweepEngine(psi, m, {
            'chi_max': 64, 'svd_min': 1e-12, 'lanczos_K': 20, 'n_sweeps': 4,
            'multiple': 16, 'backend': backend}, 'cpu')
        E, _ = eng.run()
        xm = XXZChain({'L': 2, 'Jxx': 1., 'Jz': 1.5, 'hz': 0.,
                       'bc_MPS': 'infinite'})
        xpsi = MPS.from_product_state(xm.lat.mps_sites(), ['up', 'down'],
                                      bc='infinite')
        teng = DeviceTEBDEngine(xpsi, xm, {
            'N_steps': 4, 'dt': 0.05, 'order': 2, 'chi_max': 16,
            'multiple': 8, 'backend': backend}, device='cpu')
        teng.run()
        res[backend] = (E, np.sort(np.asarray(psi.get_SL(3)))[::-1],
                        np.sort(np.asarray(xpsi.get_SL(1)))[::-1],
                        np.real(xpsi.expectation_value('Sz')))
    E, S, St, sz = res['qr_eigh']
    E0, S0, St0, sz0 = res['svd']
    assert abs(E - E0) <= 1e-10 * abs(E0)
    for x, x0 in ((S, S0), (St, St0)):
        x0 = x0[x0 >= 1e-6 * x0[0]]
        assert np.abs(x[:len(x0)] - x0).max() <= 1e-8
    assert np.abs(sz - sz0).max() <= 1e-8
