"""The port's QR-based split and eigh-based SVD against ``tenpy_tpu``.

``decompose_theta_qr_based`` (both directions, with and without the
expansion, with and without ``use_eig_based_svd``, ``return_both_T``),
``_eig_based_svd`` and ``TruncationError.from_norm`` on the same seeded
theta in both packages.  The singular vectors have a free phase per
charge sector, so the results are held through S and the reconstruction
``T_L diag(S) T_R`` (``T_L T_R`` where one of them carries S, form
'Th'), and the truncation error: 1e-12 relative, f64 and complex128
(Schmidt values below 1e-6 of the largest, which the Gram matrix's eigh
gives as square roots of roundoff, to 1e-7).
"""
import numpy as np
import pytest
import torch

import tenpy_tpu.linalg.np_conserved as jnpc
from tenpy_tpu.linalg import truncation as jtr
from tenpy_tpu_torch.linalg import np_conserved as npc
from tenpy_tpu_torch.linalg import truncation as tr
from tenpy_tpu_torch.linalg.charges import ChargeInfo, LegCharge

from test_torch_np_conserved import _leg
from torch_exchange import to_host

torch.set_num_threads(1)

TOL = 1e-12
TRUNC = {'chi_max': 14, 'svd_min': 1e-10}


def _theta(seed, complex_, qtotal_R):
    """A random two-site theta ``[(vL.p0), (p1.vR)]``, the old bond leg and
    the total charges, in both packages."""
    rng = np.random.default_rng(seed)
    (jv, _), (jp, _), (jb, _) = _leg(rng, 5, 1), _leg(rng, 3, 1), \
        _leg(rng, 4, 1)
    legs = [jv, jp, jp, jv.conj()]
    labels = ['vL', 'p0', 'p1', 'vR']
    # charge 0, or the charge of a block off the diagonal
    row = (1, 0, jp.block_number - 1, 0) if qtotal_R else (0, 0, 0, 0)
    qtot = jv.chinfo.make_valid(sum(l.charges[s] * l.qconj
                                    for l, s in zip(legs, row)))
    draw = (lambda s: rng.standard_normal(s) + 1j * rng.standard_normal(s)) \
        if complex_ else (lambda s: rng.standard_normal(s))
    jth = jnpc.Array.from_func(draw, legs, qtotal=qtot, labels=labels)
    assert jth.stored_blocks > 0
    # a decaying spectrum: vL's indices scaled geometrically
    jth.iscale_axis(0.7 ** np.arange(jv.ind_len), 'vL')
    th = to_host(jth)
    combine = ([['vL', 'p0'], ['p1', 'vR']],)
    jth = jth.combine_legs(*combine, qconj=[+1, -1])
    th = th.combine_legs(*combine, qconj=[+1, -1])
    qL = np.zeros(2, int)
    qR = np.array(jth.qtotal)
    return jth, th, jb, _host_leg(jb), qL, qR


def _host_leg(jl):
    return LegCharge(ChargeInfo(jl.chinfo.mod, jl.chinfo.names), jl.slices,
                     jl.charges, jl.qconj)


def _S_close(S, jS):
    """Schmidt values from 1e-6 of the largest up to 1e-12 of it; smaller
    ones, which an eigh of the Gram matrix computes as square roots of
    roundoff, to 1e-7 of it."""
    S, jS = np.asarray(S), np.asarray(jS)
    assert S.shape == jS.shape
    big = jS >= 1e-6 * jS.max()
    assert np.abs(S - jS)[big].max() <= TOL * jS.max()
    assert np.abs(S - jS).max() <= 1e-7 * jS.max()


def _dense(x):
    if isinstance(x, npc.Array):
        return x.to_numpy()
    return np.asarray(x.to_numpy())


def _rebuilt(pkg, T_L, S, T_R, form):
    if 'Th' in form:
        return pkg.tensordot(T_L, T_R, axes=[['vR'], ['vL']])
    return pkg.tensordot(T_L.scale_axis(np.asarray(S), 'vR'), T_R,
                         axes=[['vR'], ['vL']])


@pytest.mark.parametrize('move_right', [True, False])
@pytest.mark.parametrize('expand', [None, 0.5])
@pytest.mark.parametrize('eig_based', [False, True])
@pytest.mark.parametrize('complex_', [False, True])
def test_decompose_theta_qr_based_vs_jax(move_right, expand, eig_based,
                                         complex_):
    seed = 2 * move_right + 5 * bool(expand) + 11 * eig_based
    jth, th, jb, b, qL, qR = _theta(seed, complex_, qtotal_R=seed % 2)
    args = (move_right, expand, 1, eig_based, dict(TRUNC))
    for compute_err, both in ((True, True), (False, False), (False, True)):
        res = tr.decompose_theta_qr_based(qL, qR, b, th, *args, compute_err,
                                          both)
        jres = jtr.decompose_theta_qr_based(qL, qR, jb, jth, *args,
                                            compute_err, both)
        T_L, S, T_R, form, err, ren = res
        jT_L, jS, jT_R, jform, jerr, jren = jres
        assert form == jform
        _S_close(S, jS)
        assert abs(ren - jren) <= TOL * jren
        if compute_err:
            assert abs(err.eps - jerr.eps) <= TOL
            assert 0. <= err.eps <= 1.
        else:
            assert np.isnan(err.eps) and np.isnan(jerr.eps)
        kept = jT_L if move_right else jT_R
        got = T_L if move_right else T_R
        assert (got is None) == (kept is None) is False
        for x, jx in ((T_L, jT_L), (T_R, jT_R)):
            assert (x is None) == (jx is None)
            if x is not None:
                assert x.get_leg_labels() == tuple(jx.get_leg_labels())
        if T_L is not None and T_R is not None:
            rec, jrec = _rebuilt(npc, T_L, S, T_R, form), \
                _rebuilt(jnpc, jT_L, jS, jT_R, jform)
            d, jd = _dense(rec), _dense(jrec)
            assert np.abs(d - jd).max() <= TOL * np.abs(jd).max()
            # and the rebuilt theta is theta up to the truncation
            full = _dense(th) / npc.norm(th)
            approx = d * ren / npc.norm(th)
            if compute_err:
                assert abs(np.linalg.norm(full - approx) ** 2 - err.eps) \
                    <= 1e-10


@pytest.mark.parametrize('side', ['U', 'Vd', 'S'])
def test_eig_based_svd_and_from_norm_vs_jax(side):
    rng = np.random.default_rng(9)
    (jv, _), (jw, _) = _leg(rng, 6, 1), _leg(rng, 5, -1)
    jA = jnpc.Array.from_func(lambda s: rng.standard_normal(s), [jv, jw],
                              qtotal=[0, 0], labels=['vL', 'vR'])
    A = to_host(jA)
    kw = {'need_U': side == 'U', 'need_Vd': side == 'Vd',
          'inner_labels': ('vR', 'vL')}
    for trunc in (None, dict(TRUNC, chi_max=6)):
        U, S, Vd, err, ren = tr._eig_based_svd(A, trunc_params=trunc, **kw)
        jU, jS, jVd, jerr, jren = jtr._eig_based_svd(jA, trunc_params=trunc,
                                                     **kw)
        _S_close(S, jS)
        assert abs(ren - jren) <= TOL * jren
        assert abs(err.eps - jerr.eps) <= TOL
        sv = np.sort(npc.svd(A, compute_uv=False))[::-1]
        if trunc is None:     # the SVD's values, then the Gram's zeros
            S_desc = np.sort(S)[::-1] * ren
            np.testing.assert_allclose(S_desc[:len(sv)], sv,
                                       atol=1e-10 * sv[0])
            assert np.all(S_desc[len(sv):] <= 1e-7 * sv[0])
        if side == 'U':     # U^H A A^H U = diag(S^2 ren^2)
            g = npc.tensordot(npc.tensordot(U.conj(), A, axes=[[0], [0]]),
                              A.conj(), axes=[[1], [1]])
            g = npc.tensordot(g, U, axes=[[1], [0]]).to_numpy()
            np.testing.assert_allclose(g, np.diag(np.diag(g)),
                                       atol=1e-10 * ren ** 2)
            assert U.get_leg_labels() == tuple(jU.get_leg_labels())
        if side == 'Vd':
            assert Vd.get_leg_labels() == tuple(jVd.get_leg_labels())
    with pytest.raises(NotImplementedError):
        tr._eig_based_svd(A, need_U=True, need_Vd=True)
    for new, old in ((0.9, 1.), (0.5, 2.), (1., 1.)):
        e, je = tr.TruncationError.from_norm(new, old), \
            jtr.TruncationError.from_norm(new, old)
        assert (e.eps, e.ov) == (je.eps, je.ov)
