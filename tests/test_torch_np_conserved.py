"""The port's host Array against ``tenpy_tpu.linalg.np_conserved``.

Seeded random U(1)xU(1) arrays are built once from numpy blocks in
``tenpy_tpu`` and carried into the port through the exchange format; each
case applies the same function in both packages and compares the results
densely.  Tolerance 1e-13 relative to the largest entry: the two sum block
products in the same order, and differ only where LAPACK or BLAS builds do.
"""
import numpy as np
import pytest
import torch

import tenpy_tpu.linalg.np_conserved as jnpc
from tenpy_tpu.linalg.charges import ChargeInfo as JChargeInfo, \
    LegCharge as JLegCharge
from tenpy_tpu_torch.linalg import np_conserved as npc
from tenpy_tpu_torch.linalg.charges import ChargeInfo, LegCharge

from torch_exchange import to_host

torch.set_num_threads(1)

TOL = 1e-13
JCH = JChargeInfo([1, 1], ['N', '2*Sz'])
CH = ChargeInfo([1, 1], ['N', '2*Sz'])


def _leg(rng, n, qconj):
    """A sorted, bunched random leg of length n (both packages)."""
    sizes = rng.integers(1, 4, size=n)
    charges = np.unique(rng.integers(-2, 3, size=(n, 2)), axis=0)[:n]
    charges = charges[np.lexsort(charges.T)]
    sizes = sizes[:len(charges)]
    slices = np.concatenate([[0], np.cumsum(sizes)])
    return (JLegCharge(JCH, slices, charges, qconj),
            LegCharge(CH, slices, charges, qconj))


def _random(rng, jlegs, labels, qtotal=None):
    """A random tenpy_tpu Array on ``jlegs`` and its port copy."""
    a = jnpc.Array.from_func(lambda size: rng.standard_normal(size), jlegs,
                             qtotal=qtotal, labels=labels)
    if a.stored_blocks == 0:   # make the first sectors' block allowed
        q = JCH.make_valid(sum(l.charges[0] * l.qconj for l in jlegs))
        a = jnpc.Array.from_func(lambda size: rng.standard_normal(size),
                                 jlegs, qtotal=q, labels=labels)
    return a, to_host(a)


def _dense(x):
    if isinstance(x, npc.Array):
        return x.to_numpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, jnpc.Array):
        return np.asarray(x.to_numpy())
    return np.asarray(x)


def _close(p, j):
    p, j = _dense(p), _dense(j)
    assert p.shape == j.shape
    scale = max(float(np.abs(j).max()) if j.size else 0., 1e-300)
    assert float(np.abs(p - j).max()) <= TOL * scale


def _same_struct(p, j):
    assert p.qtotal == tuple(j.qtotal)
    assert p.get_leg_labels() == tuple(j.get_leg_labels())
    assert np.array_equal(p._qdata, j._qdata)
    for lp, lj in zip(p.legs, j.legs):
        assert np.array_equal(lp.slices, lj.slices)
        assert np.array_equal(lp.charges, lj.charges)
        assert lp.qconj == lj.qconj


def _case_tensordot(rng):
    (jv, v), (jp, p) = _leg(rng, 5, 1), _leg(rng, 3, 1)
    jw, w = _leg(rng, 4, -1)
    ja, a = _random(rng, [jv, jp, jw], ['vL', 'p', 'w'])
    jb, b = _random(rng, [jw.conj(), jp.conj(), jv.conj()], ['w*', 'p*', 'x'])
    ax = (['p', 'w'], ['p*', 'w*'])
    res, jres = npc.tensordot(a, b, ax), jnpc.tensordot(ja, jb, ax)
    _same_struct(res, jres)
    _close(res, jres)


def _case_inner(rng):
    (jv, v), (jp, p) = _leg(rng, 5, 1), _leg(rng, 3, -1)
    ja, a = _random(rng, [jv, jp], ['vL', 'p'])
    jb, b = _random(rng, [jv, jp], ['vL', 'p'], qtotal=ja.qtotal)
    _close(npc.inner(a, b, axes='range', do_conj=True),
           jnpc.inner(ja, jb, axes='range', do_conj=True))
    _close(npc.inner(a, b.conj(), axes='labels'),
           jnpc.inner(ja, jb.conj(), axes='labels'))


def _case_outer(rng):
    (jv, v), (jp, p) = _leg(rng, 4, 1), _leg(rng, 3, -1)
    ja, a = _random(rng, [jv, jp], ['a', 'b'])
    jb, b = _random(rng, [jp.conj(), jv], ['c', 'd'])
    res, jres = npc.outer(a, b), jnpc.outer(ja, jb)
    _same_struct(res, jres)
    _close(res, jres)


def _case_grid_outer(rng):
    (jp, p) = _leg(rng, 3, 1)
    jId, Id = _random(rng, [jp, jp.conj()], ['p', 'p*'], qtotal=[0, 0])
    jX, X = _random(rng, [jp, jp.conj()], ['p', 'p*'], qtotal=[1, -1])
    jL = JLegCharge.from_qflat(JCH, [[0, 0], [1, -1]])
    L = LegCharge.from_qflat(CH, [[0, 0], [1, -1]])
    jgrid = [[jId, jX], [None, jId * 0.5]]
    grid = [[Id, X], [None, Id * 0.5]]
    res = npc.grid_outer(grid, [L, L.conj()], grid_labels=['wL', 'wR'])
    jres = jnpc.grid_outer(jgrid, [jL, jL.conj()], grid_labels=['wL', 'wR'])
    _same_struct(res, jres)
    _close(res, jres)


def _matrix(rng):
    (jv, v), (jp, p) = _leg(rng, 5, 1), _leg(rng, 3, 1)
    (jw, w) = _leg(rng, 5, -1)
    ja, a = _random(rng, [jv, jp, jw], ['vL', 'p', 'vR'])
    return ja, a


def _case_qr(rng):
    ja, a = _matrix(rng)
    jm = ja.combine_legs([['vL', 'p']], qconj=[+1])
    m = a.combine_legs([['vL', 'p']], qconj=[+1])
    _same_struct(m, jm)
    _close(m, jm)
    jq, jr = jnpc.qr(jm, inner_labels=['vR', 'vL'], pos_diag_R=True)
    q, r = npc.qr(m, inner_labels=['vR', 'vL'], pos_diag_R=True)
    for x, jx in ((q, jq), (r, jr)):
        _same_struct(x, jx)
        _close(x, jx)
    _close(q.split_legs([0]), jq.split_legs([0]))


def _case_lq(rng):
    ja, a = _matrix(rng)
    jm = ja.combine_legs([['p', 'vR']], qconj=[-1])
    m = a.combine_legs([['p', 'vR']], qconj=[-1])
    jl, jq = jnpc.lq(jm, inner_labels=['vR', 'vL'], pos_diag_L=True,
                     inner_qconj=+1)
    l, q = npc.lq(m, inner_labels=['vR', 'vL'], pos_diag_L=True,
                  inner_qconj=+1)
    for x, jx in ((l, jl), (q, jq)):
        _same_struct(x, jx)
        _close(x, jx)
    _close(q.split_legs([1]), jq.split_legs([1]))


def _case_add_leg(rng):
    (jv, v) = _leg(rng, 5, 1)
    ja, a = _random(rng, [jv, jv.conj()], ['vR*', 'vR'], qtotal=[0, 0])
    (jw, w) = _leg(rng, 4, -1)
    res = a.add_leg(w, 2, axis=1, label='wR')
    jres = ja.add_leg(jw, 2, axis=1, label='wR')
    _same_struct(res, jres)
    _close(res, jres)


def _case_iproject(rng):
    ja, a = _matrix(rng)
    mask = rng.random(ja.get_leg('vL').ind_len) < 0.6
    mask[0] = True
    _close(a.copy().iproject(mask, 'vL'), ja.copy().iproject(mask, 'vL'))
    res = a.copy().iproject([mask], ['vL'])
    jres = ja.copy().iproject([mask], ['vL'])
    _same_struct(res, jres)


def _case_norm(rng):
    ja, a = _matrix(rng)
    _close(npc.norm(a), jnpc.norm(ja))
    _close(npc.norm(a * 2.5 - a.conj().conj()),
           jnpc.norm(ja * 2.5 - ja.conj().conj()))


def _case_trace(rng):
    """The partial trace of a 4-leg Array over two pairs in turn, and the
    full trace of a 2-leg one."""
    (jv, v), (jp, p) = _leg(rng, 4, 1), _leg(rng, 3, 1)
    ja, a = _random(rng, [jv, jp, jp.conj(), jv.conj()],
                    ['a', 'p', 'p*', 'a*'])
    res, jres = npc.trace(a, 'p', 'p*'), jnpc.trace(ja, 'p', 'p*')
    _same_struct(res, jres)
    _close(res, jres)
    _close(npc.trace(res, 'a*', 'a'), jnpc.trace(jres, 'a*', 'a'))
    res, jres = npc.trace(a, 0, 3), jnpc.trace(ja, 0, 3)
    _same_struct(res, jres)
    _close(res, jres)


def _case_eigvalsh(rng):
    """Eigenvalues of a hermitian (real and complex) charge-0 Array with a
    sector without a stored block, ascending and sorted."""
    (jv, v) = _leg(rng, 5, 1)
    for cplx in (False, True):
        ja, a = _random(rng, [jv, jv.conj()], ['a', 'a*'], qtotal=[0, 0])
        if cplx:
            jb, b = _random(rng, [jv, jv.conj()], ['a', 'a*'],
                            qtotal=[0, 0])
            ja, a = ja + jb * 1j, a + b * 1j
        jh = ja + ja.conj().transpose([1, 0]).iset_leg_labels(['a', 'a*'])
        h = a + a.conj().transpose([1, 0]).iset_leg_labels(['a', 'a*'])
        h._data, h._qdata = h._data[1:], h._qdata[1:]
        jh._data, jh._qdata = jh._data[1:], jh._qdata[1:]
        for sort in (None, '>', '<'):
            _close(npc.eigvalsh(h, sort=sort), jnpc.eigvalsh(jh, sort=sort))


CASES = {'tensordot': _case_tensordot, 'inner': _case_inner,
         'outer': _case_outer, 'grid_outer': _case_grid_outer,
         'qr': _case_qr, 'lq': _case_lq, 'add_leg': _case_add_leg,
         'iproject': _case_iproject, 'norm': _case_norm,
         'trace': _case_trace, 'eigvalsh': _case_eigvalsh}


@pytest.mark.parametrize('name', sorted(CASES))
@pytest.mark.parametrize('seed', [0, 1])
def test_npc_vs_jax(name, seed):
    CASES[name](np.random.default_rng(seed))
