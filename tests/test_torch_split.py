"""The port's packed split against ``tenpy_tpu.linalg.packed_split``.

Same theta (the S=1 Heisenberg chain of tests/test_packed_dmrg.py), packed
by each package.  The bond layout and the split plan are host-side integer
maps and must be identical.  ``split_truncate`` (``backend='svd'``): S to
1e-12 and the same kept count (LAPACK in both, f64), ``err`` to 1e-14, A
isometric to 1e-12, and the reconstruction A.S.B to 1e-10 (singular vectors
may differ in sign; their product may not).
"""
import numpy as np
import pytest
import torch

from tenpy_tpu.linalg import packed as jpk
from tenpy_tpu.linalg import packed_split as jps
from tenpy_tpu_torch.linalg import packed as pk
from tenpy_tpu_torch.linalg import packed_split as ps

from test_packed_dmrg import _ramped_state
from torch_exchange import assert_packed_close, to_host

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def split_case():
    _, psi, _ = _ramped_state()
    i0 = 3
    theta = psi.get_theta(i0, 2).itranspose(['vL', 'p0', 'p1', 'vR'])
    qtot_A = psi.get_B(i0, None).qtotal
    vb = psi.get_B(i0, None).get_leg('vR')
    hint = {tuple(np.asarray(vb.charges[b])):
            int(vb.slices[b + 1] - vb.slices[b])
            for b in range(vb.block_number)}
    out = {}
    for name, pkg, spl, th, kw in (('jax', jpk, jps, theta, {}),
                                   ('port', pk, ps, to_host(theta),
                                    {'device': 'cpu'})):
        thp = pkg.pack(th, multiple=16, pad_labels=('vL', 'vR'), **kw)
        bond = spl.bond_layout(thp.legs, thp.qtotal, qtot_A, cap_hint=hint,
                               multiple=16)
        out[name] = (thp, bond, spl.split_plan(thp, bond, qtot_A,
                                               group_multiple=16))
    return out


def test_bond_layout_and_plan_match_jax(split_case):
    _, jbond, jplan = split_case['jax']
    _, pbond, pplan = split_case['port']
    assert np.array_equal(pbond.slices, jbond.slices)
    assert np.array_equal(pbond.charges, jbond.charges)
    assert pbond.qconj == jbond.qconj
    assert pplan.flat_lens == jplan.flat_lens
    assert len(pplan.groups) == len(jplan.groups)
    for pg, jg in zip(pplan.groups, jplan.groups):
        assert (pg.R, pg.C, pg.K, pg.N) == (jg.R, jg.C, jg.K, jg.N)
        assert pg.sectors == jg.sectors
        assert np.array_equal(pg.idx, jg.idx)
        assert np.array_equal(pg.cap_mask, jg.cap_mask)
    for pi, ji in zip(pplan.A_idx + pplan.B_idx, jplan.A_idx + jplan.B_idx):
        assert np.array_equal(pi, ji)
    assert np.array_equal(pplan.S_idx, jplan.S_idx)
    for pst, jst in ((pplan.A_struct, jplan.A_struct),
                     (pplan.B_struct, jplan.B_struct)):
        assert pst[1:3] == tuple(jst[1:3])
        assert all(np.array_equal(a, b) for a, b in zip(pst[3], jst[3]))


def _isometry_err(A):
    """Largest deviation of A^T A from a diagonal 0/1 matrix."""
    AA = pk.unpack(pk.tensordot(A.conj(), A, axes=(['vL*', 'p*'],
                                                   ['vL', 'p'])))
    worst = 0.
    for blk in AA._data:
        d = np.diagonal(blk)
        worst = max(worst, np.abs(d * (1. - d)).max(),
                    np.abs(blk - np.diag(d)).max())
    return worst


@pytest.mark.parametrize('expand', [False, True])
def test_split_truncate_vs_jax(split_case, expand):
    jth, _, jplan = split_case['jax']
    pth, _, pplan = split_case['port']
    jA, jS, jB, jerr, jren, jn = jps.split_truncate(
        jth, jplan, 20, 1e-10, backend='svd', expand=expand)
    pA, pS, pB, perr, pren, pn = ps.split_truncate(
        pth, pplan, 20, 1e-10, backend='svd', expand=expand)
    assert np.abs(pS.numpy() - np.asarray(jS)).max() <= 1e-12
    assert int(pn) == int(jn)
    assert abs(float(perr) - float(jerr)) <= 1e-14
    assert abs(float(pren) - float(jren)) <= 1e-12 * float(jren)
    assert _isometry_err(pA) <= 1e-12
    # the same A columns survive (the mixer keeps more of them)
    for x, y in zip(pA.data, jA.data):
        assert np.array_equal((x.numpy() != 0).any(axis=(1, 2)),
                              (np.asarray(y) != 0).any(axis=(1, 2)))
    # reconstruction A . S . B agrees although singular vectors may flip sign
    rec = [pkg.tensordot(spl.scale_bond(A, S, spl.scale_bond_plan(A, 'vR')),
                         B, axes=(['vR'], ['vL']))
           for pkg, spl, A, S, B in ((pk, ps, pA, pS, pB),
                                     (jpk, jps, jA, jS, jB))]
    assert_packed_close(rec[0], rec[1], rtol=1e-10)
