"""The split's one-sided Jacobi SVD (``'jacobi'``, ``'jacobi32'``) against
``tenpy_tpu`` on the CPU, where the port runs the kernel's plain version.

JAX's side comes from ``tests/benchmark_data/jacobi_reference.npz``
(``python tests/torch_exchange.py --write-jacobi ...``; its JAX runs take
about 40 s), on the same seeded numpy inputs (``jacobi_groups``, checked
equal to the file's).  Per group of one ragged list (tall, wide, odd C,
rank-deficient, equal singular values), f64 and complex128:
``'jacobi'``'s singular values within 1e-12 of the largest of
``tenpy_tpu``'s, ``U S V^H`` within 1e-12 of ``M`` (relative Frobenius),
``U`` and ``V`` isometric to 1e-12 on the kept columns (singular values
from 1e-10 of the largest; below, a rank-deficient matrix's columns are
roundoff); ``'jacobi32'`` at ``tenpy_tpu``'s own 1e-9 and 1e-8
(``tests/test_packed_complex.py``); both against LAPACK's singular values
at 1e-9.  U and V are never compared entry by entry.
"""
import os

import numpy as np
import pytest
import torch

from tenpy_tpu.linalg.packed_split import _jacobi_schedule
from tenpy_tpu_torch.algorithms import purification as pur
from tenpy_tpu_torch.algorithms.packed_dmrg import DeviceSweepEngine
from tenpy_tpu_torch.algorithms.packed_tebd import DeviceTEBDEngine
from tenpy_tpu_torch.linalg import jacobi_svd as js
from tenpy_tpu_torch.linalg import packed as pk
from tenpy_tpu_torch.linalg import packed_split as ps
from tenpy_tpu_torch.models.hubbard import FermiHubbardChain
from tenpy_tpu_torch.models.xxz_chain import XXZChain
from tenpy_tpu_torch.networks import exchange
from tenpy_tpu_torch.networks.mps import MPS
from tenpy_tpu_torch.networks.purification_mps import PurificationMPS

from test_torch_split_backends import _theta
from torch_exchange import (JACOBI_BACKENDS, JACOBI_CHI, JACOBI_SVD_MIN,
                            JACOBI_THETA_SEED, jacobi_groups, to_host)

torch.set_num_threads(1)

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   'benchmark_data', 'jacobi_reference.npz')
# (S against JAX, U S V^H, isometry) per backend
TOL = {'jacobi': (1e-12, 1e-12, 1e-12), 'jacobi32': (1e-9, 1e-8, 1e-8)}
LAPACK_TOL = 1e-9
KEPT = 1e-10


@pytest.fixture(scope='module')
def ref():
    return exchange.load_flat(REF)


@pytest.mark.parametrize('n', [2, 4, 16, 192])
def test_schedule_is_jax(n):
    p, q = js.jacobi_schedule(n)
    jp, jq = _jacobi_schedule(n)
    assert p.dtype == jp.dtype and np.array_equal(p, jp)
    assert np.array_equal(q, jq)


def _isometry_err(X, keep):
    """Largest deviation of ``X^H X`` from the identity on the columns
    ``keep`` (per batch entry)."""
    worst = 0.
    for x, k in zip(X, keep):
        x = x[:, k]
        g = x.conj().T @ x
        worst = max(worst, float((g - torch.eye(g.shape[0],
                                                dtype=g.dtype)).abs().max()))
    return worst


@pytest.mark.parametrize('backend', JACOBI_BACKENDS)
@pytest.mark.parametrize('complex_', [False, True], ids=['f64', 'c128'])
def test_decomp_against_jax(ref, complex_, backend):
    """One ragged list of groups in one call, each group held to
    ``tenpy_tpu``'s ``_decomp_jacobi`` on it and to LAPACK."""
    tag = 'c128' if complex_ else 'f64'
    s_tol, rec_tol, iso_tol = TOL[backend]
    Ms = jacobi_groups(complex_)
    for g, M in enumerate(Ms):
        assert np.array_equal(M, ref[f'decomp.{tag}.{g}.M'])
    out = js.decomp_jacobi([torch.from_numpy(M) for M in Ms],
                           bulk_f32=backend == 'jacobi32')
    for g, (M, (U, S, V)) in enumerate(zip(Ms, out)):
        N, R, C = M.shape
        K = min(R, C)
        assert U.shape == (N, R, K) and S.shape == (N, K) \
            and V.shape == (N, C, K)
        assert U.dtype == V.dtype == torch.from_numpy(M).dtype
        assert S.dtype == torch.float64
        S_np = S.numpy()
        S_jax = ref[f'decomp.{tag}.{backend}.{g}.S']
        top = S_jax.max(axis=1, keepdims=True)
        assert (np.abs(S_np - S_jax) <= s_tol * top).all()
        lapack = np.linalg.svd(M, compute_uv=False)
        assert (np.abs(S_np - lapack) <= LAPACK_TOL * top).all()
        assert bool((S[:, :-1] >= S[:, 1:]).all())
        rec = (U * S[:, None, :].to(U.dtype)) @ V.conj().transpose(1, 2)
        for n in range(N):
            assert np.linalg.norm(rec[n].numpy() - M[n]) \
                <= rec_tol * np.linalg.norm(M[n])
        keep = S > KEPT * S[:, :1]
        assert _isometry_err(U, keep) <= iso_tol
        assert _isometry_err(V, keep) <= iso_tol
        # the rotated matrix's columns of zero singular values are zero (U,
        # or V for a wide M, decomposed as M^H)
        X = U if R >= C else V
        assert float(X.abs()[(S == 0)[:, None, :].expand(X.shape)].sum()) \
            == 0.


def test_ragged_layout():
    """A group decomposed alone gives what it gives in the ragged list, bit
    for bit; each matrix stops once converged, before the cap (the sweeps
    run, per table row, as the kernel reports them); the table lists every
    matrix once, largest work first, at its offsets; ``jacobi_sweeps``
    raises for a device with neither a kernel nor the plain route."""
    Ms = [torch.from_numpy(M) for M in jacobi_groups(True)]
    sweeps = []
    together = js.decomp_jacobi(Ms, sweeps_out=sweeps)
    for M, outs in zip(Ms, together):
        alone = js.decomp_jacobi([M])[0]
        for x, y in zip(alone, outs):
            assert torch.equal(x, y)
    assert len(sweeps) == 1 and sweeps[0].dtype == torch.int32
    assert 1 <= int(sweeps[0].min()) and int(sweeps[0].max()) < js.MAX_SWEEPS
    # a converged matrix: one more sweep changes nothing
    M = Ms[0][:1]
    U, S, V = js.decomp_jacobi([M])[0]
    S_cap = js.decomp_jacobi([M], max_sweeps=int(sweeps[0].max()) + 1)[0][1]
    assert torch.equal(S, S_cap)
    dims = [tuple(M.shape) for M in Ms]
    table = js.ragged_table(dims)
    assert table.shape == (sum(d[0] for d in dims), 4)
    work = table[:, 2] * table[:, 3] ** 2
    assert (work[:-1] >= work[1:]).all()
    assert (table[:, 2] >= table[:, 3]).all() and not (table[:, 3] % 2).any()
    sizes = sorted(zip(table[:, 0], table[:, 2] * table[:, 3]))
    assert sizes[0][0] == 0 and all(a + n == b for (a, n), (b, _) in
                                    zip(sizes, sizes[1:]))
    ws = torch.zeros(8, device='meta')
    with pytest.raises(ValueError, match='no Jacobi SVD kernel'):
        js.jacobi_sweeps(ws, ws, [(1, 2, 2)], 1, True)


def _split_case(complex_):
    thp = pk.pack(to_host(_theta(JACOBI_THETA_SEED, complex_)), multiple=8,
                  pad_labels=('vL', 'vR'), device='cpu')
    bond = ps.bond_layout(thp.legs, thp.qtotal, [0, 0], multiple=8)
    return thp, ps.split_plan(thp, bond, [0, 0], group_multiple=8)


@pytest.mark.parametrize('backend', JACOBI_BACKENDS)
@pytest.mark.parametrize('complex_', [False, True], ids=['f64', 'c128'])
def test_split_against_jax(ref, complex_, backend):
    """``split_truncate`` with the backend against ``tenpy_tpu``'s with the
    same backend on the same theta: S, the truncation error, the count
    kept and ``A S B``; every group in one call of ``decomp_jacobi``."""
    thp, plan = _split_case(complex_)
    calls = []
    orig = js.decomp_jacobi

    def counted(Ms, **kw):
        calls.append(len(Ms))
        return orig(Ms, **kw)

    js.decomp_jacobi = counted
    try:
        A, S, B, err, _, n = ps.split_truncate(thp, plan, JACOBI_CHI,
                                               JACOBI_SVD_MIN,
                                               backend=backend)
    finally:
        js.decomp_jacobi = orig
    assert calls == [len(plan.groups)] and len(plan.groups) > 1
    key = f"split.{'c128' if complex_ else 'f64'}.{backend}"
    s_tol, rec_tol, _ = TOL[backend]
    S, S_jax = S.numpy(), ref[f'{key}.S']
    assert np.abs(S - S_jax).max() <= s_tol * S_jax.max()
    assert abs(float(err) - float(ref[f'{key}.err'])) <= s_tol
    assert int(n) == int(ref[f'{key}.n'])
    rec = pk.unpack(pk.tensordot(
        ps.scale_bond(A, torch.from_numpy(S), ps.scale_bond_plan(A, 'vR')),
        B, axes=(['vR'], ['vL']))).to_numpy()
    rec_jax = ref[f'{key}.rec']
    assert np.linalg.norm(rec - rec_jax) <= rec_tol * np.linalg.norm(rec_jax)
    assert A.dtype == (torch.complex128 if complex_ else torch.float64)


def test_engines_with_jacobi():
    """``DeviceSweepEngine`` (finite Hubbard chain, exact regime) and
    ``DeviceTEBDEngine`` (real time, complex128) on the CPU with
    ``'jacobi'`` end where they end with ``'svd'``: energies, Schmidt
    values and Sz to 1e-10; every split of both engines goes through
    ``decomp_jacobi``."""
    chain = {'L': 6, 'bc_MPS': 'finite', 't': 1., 'U': 4., 'mu': 0.}
    res = {}
    calls = []
    orig = js.decomp_jacobi

    def counted(Ms, **kw):
        calls.append(len(Ms))
        return orig(Ms, **kw)

    for backend in ('svd', 'jacobi'):
        js.decomp_jacobi = counted
        try:
            m = FermiHubbardChain(dict(chain))
            psi = MPS.from_product_state(m.lat.mps_sites(),
                                         ['up', 'down'] * 3)
            eng = DeviceSweepEngine(psi, m, {
                'chi_max': 32, 'svd_min': 1e-12, 'lanczos_K': 20,
                'n_sweeps': 3, 'multiple': 16, 'backend': backend}, 'cpu')
            E, _ = eng.run()
            n_dmrg = len(calls)
            xm = XXZChain({'L': 2, 'Jxx': 1., 'Jz': 1.5, 'hz': 0.,
                           'bc_MPS': 'infinite'})
            xpsi = MPS.from_product_state(xm.lat.mps_sites(), ['up', 'down'],
                                          bc='infinite')
            teng = DeviceTEBDEngine(xpsi, xm, {
                'N_steps': 4, 'dt': 0.05, 'order': 2, 'chi_max': 16,
                'multiple': 8, 'backend': backend}, device='cpu')
            teng.run()
        finally:
            js.decomp_jacobi = orig
        if backend == 'jacobi':
            assert n_dmrg > 0 and len(calls) > n_dmrg
        else:
            assert not calls
        res[backend] = (E, np.sort(np.asarray(psi.get_SL(3)))[::-1],
                        np.sort(np.asarray(xpsi.get_SL(1)))[::-1],
                        np.real(xpsi.expectation_value('Sz')))
    E, S, St, sz = res['jacobi']
    E0, S0, St0, sz0 = res['svd']
    assert abs(E - E0) <= 1e-10 * abs(E0)
    for x, x0 in ((S, S0), (St, St0)):
        x0 = x0[x0 >= 1e-6 * x0[0]]
        assert np.abs(x[:len(x0)] - x0).max() <= 1e-10
    assert np.abs(sz - sz0).max() <= 1e-10


def test_purification_split_backend():
    """``PurificationTEBD``'s card route (``device_threshold=0``, every
    update) with ``split_backend='jacobi'`` splits through
    ``decomp_jacobi`` and ends where the host route ends: Schmidt values
    of every bond to 1e-10."""
    m = XXZChain({'L': 6, 'Jxx': 1., 'Jz': 0.6, 'hz': 0.1,
                  'bc_MPS': 'finite'})
    psi0 = PurificationMPS.from_infiniteT(m.lat.mps_sites())
    opts = {'trunc_params': {'chi_max': 12, 'svd_min': 1e-10}, 'dt': 0.05,
            'order': 2}
    calls = []
    orig = js.decomp_jacobi

    def counted(Ms, **kw):
        calls.append(len(Ms))
        return orig(Ms, **kw)

    engs = {}
    js.decomp_jacobi = counted
    try:
        for thr in (None, 0):
            engs[thr] = pur.PurificationTEBD(
                psi0.copy(), m, dict(opts, device_threshold=thr,
                                     split_backend='jacobi'), device='cpu')
            engs[thr].run_imaginary(0.2)
    finally:
        js.decomp_jacobi = orig
    n_card = sum(r == 'device' for _, _, r, _ in engs[0].update_stats)
    assert n_card > 0 and len(calls) == n_card
    host, dev = engs[None].psi, engs[0].psi
    for b in range(1, host.L):
        Sh, Sd = np.sort(host.get_SL(b)), np.sort(dev.get_SL(b))
        assert Sh.shape == Sd.shape
        assert np.abs(Sd - Sh).max() <= 1e-10
