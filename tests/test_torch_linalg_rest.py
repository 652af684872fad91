"""The rest of the port's host linear algebra against ``tenpy_tpu``.

``np_conserved`` (indexing, block access, leg permutations and sorts,
blockwise arithmetic, the constructors and detections, ``grid_concat``,
``qr``/``lq`` with ``mode`` and ``cutoff``, ``eig``/``eigvals``,
``speigs``, ``pinv``), ``charges``, ``svd_robust``, ``tools/math`` and
``tools/misc``: the same seeded numpy inputs through both packages.
Tolerance 1e-12 relative to the largest entry (f64 and complex128; the
two packages' LAPACK and BLAS builds differ), exact for integer and
structural results.  Decompositions are held through gauge-free
quantities (``Q R``, residuals, sorted spectra) and, with a fixed gauge
(``pos_diag_R``), entry by entry.
"""
import warnings

import numpy as np
import pytest
import torch

import tenpy_tpu.linalg.np_conserved as jnpc
from tenpy_tpu.linalg import svd_robust as jsvd
from tenpy_tpu.linalg.charges import LegCharge as JLegCharge, \
    LegPipe as JLegPipe
from tenpy_tpu.tools import math as jmath, misc as jmisc
from tenpy_tpu_torch.linalg import np_conserved as npc
from tenpy_tpu_torch.linalg import svd_robust
from tenpy_tpu_torch.linalg.charges import ChargeInfo, LegCharge, LegPipe
from tenpy_tpu_torch.tools import math as tmath, misc as tmisc

from test_torch_np_conserved import CH, JCH, _dense, _leg, _random, \
    _same_struct
from torch_exchange import to_host

torch.set_num_threads(1)

TOL = 1e-12


def _close(p, j, tol=TOL):
    p, j = _dense(p), _dense(j)
    assert p.shape == j.shape
    scale = max(float(np.abs(j).max()) if j.size else 0., 1e-300)
    assert float(np.abs(p - j).max()) <= tol * scale


def _both(rng, n_legs=3, qtotal=None, complex_=False):
    """A random 3-leg Array (vL, p, vR) in both packages."""
    (jv, _), (jp, _), (jw, _) = _leg(rng, 5, 1), _leg(rng, 3, 1), \
        _leg(rng, 5, -1)
    legs = [jv, jp, jw][:n_legs]
    labels = ['vL', 'p', 'vR'][:n_legs]
    ja, a = _random(rng, legs, labels, qtotal)
    if complex_:
        jb = jnpc.Array.from_func(lambda size: rng.standard_normal(size),
                                  legs, qtotal=ja.qtotal, labels=labels)
        ja = ja + 1j * jb
        a = to_host(ja)
    return ja, a


def _unsorted_leg(rng, n, qconj):
    """A leg whose sectors are neither sorted nor bunched."""
    charges = rng.integers(-1, 2, size=(n, 2))
    charges[1] = charges[0]                 # two equal sectors in a row
    slices = np.concatenate([[0], np.cumsum(rng.integers(1, 3, size=n))])
    return (JLegCharge(JCH, slices, charges, qconj),
            LegCharge(CH, slices, charges, qconj))


# ------------------------------------------------------------- np_conserved
def _case_small_methods(rng):
    ja, a = _both(rng)
    assert a.size == ja.size
    assert a.get_leg_indices(['vR', 'vL']) == ja.get_leg_indices(['vR', 'vL'])
    assert a.set_leg_labels(['x', 'y', 'z']).get_leg_labels() == \
        tuple(ja.set_leg_labels(['x', 'y', 'z']).get_leg_labels())
    assert a.get_leg_labels() == ('vL', 'p', 'vR')
    assert a.copy().idrop_labels(['p']).get_leg_labels() == \
        tuple(ja.copy().idrop_labels(['p']).get_leg_labels())
    assert a.copy().idrop_labels().get_leg_labels() == (None,) * 3
    assert a.sparse_stats() == ja.sparse_stats()
    _close(np.asarray(a), np.asarray(ja))
    pp, jpp = a.make_pipe(['vL', 'p'], qconj=-1), \
        ja.make_pipe(['vL', 'p'], qconj=-1)
    assert isinstance(pp, LegPipe)
    assert np.array_equal(pp.slices, jpp.slices)
    assert np.array_equal(pp.charges, jpp.charges) and pp.qconj == -1
    for axis in (0, 2):
        res, jres = a.add_trivial_leg(axis, 'triv', -1), \
            ja.add_trivial_leg(axis, 'triv', -1)
        _same_struct(res, jres)
        _close(res, jres)
    jv = JLegCharge(JCH, [0, 1], [[1, -1]], 1)
    jx = jnpc.Array.from_func(lambda s: rng.standard_normal(s),
                              [jv, jv.conj()], qtotal=[0, 0])
    _close(to_host(jx).item(), jx.item())


def _case_trivial_and_blocks(rng):
    dense = rng.standard_normal((3, 4, 2))
    res = npc.Array.from_ndarray_trivial(dense, labels=['a', 'b', 'c'])
    jres = jnpc.Array.from_ndarray_trivial(dense, labels=['a', 'b', 'c'])
    _same_struct(res, jres)
    _close(res, jres)
    assert res.chinfo.qnumber == 0
    ja, a = _both(rng)
    for row in ja._qdata[::2]:
        _close(a.get_block(row), ja.get_block(row))
    missing = [(i, j, k) for i in range(a.legs[0].block_number)
               for j in range(a.legs[1].block_number)
               for k in range(a.legs[2].block_number)
               if a._find_block((i, j, k)) is None]
    row = next(r for r in missing
               if tuple(npc._row_qtotal(a.legs, r)) == a.qtotal) \
        if any(tuple(npc._row_qtotal(a.legs, r)) == a.qtotal
               for r in missing) else None
    r0 = missing[0]
    assert a.get_block(r0) is None and ja.get_block(r0) is None
    _close(a.get_block(r0, insert_zeros=True),
           ja.get_block(r0, insert_zeros=True))
    blk = rng.standard_normal(npc._block_shape(a.legs, ja._qdata[0]))
    a.set_block(ja._qdata[0], blk)
    ja.set_block(ja._qdata[0], blk)
    if row is not None:
        blk = rng.standard_normal(npc._block_shape(a.legs, row))
        a.set_block(row, blk)
        ja.set_block(row, blk)
    forbidden = [r for r in missing
                 if tuple(npc._row_qtotal(a.legs, r)) != a.qtotal]
    if forbidden:
        with pytest.raises(ValueError):
            a.set_block(forbidden[0], np.zeros(
                npc._block_shape(a.legs, forbidden[0])))
    _same_struct(a, ja)
    _close(a, ja)
    a.test_sanity()


def _case_getitem(rng):
    ja, a = _both(rng, complex_=True)
    mask = rng.random(a.shape[2]) < 0.6
    mask[0] = True
    shape = a.shape
    dense = ja.to_numpy()
    for _ in range(6):          # single elements, in and out of blocks
        idx = tuple(int(rng.integers(n)) for n in shape)
        _close(complex(a[idx]), complex(ja[idx]))
        assert abs(complex(a[idx]) - dense[idx]) <= TOL * np.abs(dense).max()
    for inds in ((1, slice(None), slice(None)), (Ellipsis, 2),
                 (slice(1, 4), Ellipsis, mask), (0, 1), (slice(None, 3),),
                 (Ellipsis, 0, slice(None)), (np.ones(shape[0], bool), 1)):
        res, jres = a[inds], ja[inds]
        _same_struct(res, jres)
        _close(res, jres)
    with pytest.raises(IndexError):
        a[np.array([0, 1])]
    with pytest.raises(IndexError):
        a[0, 0, 0, 0]
    for axes, idx in ((['vL'], [2]), ([0, 2], [1, 3]), (['p'], 1)):
        res, jres = a.take_slice(idx, axes), ja.take_slice(idx, axes)
        _same_struct(res, jres)
        _close(res, jres)


def _case_setitem(rng):
    ja, a = _both(rng)
    shape = a.shape
    for _ in range(8):
        idx = tuple(int(rng.integers(n)) for n in shape)
        allowed = tuple(npc._row_qtotal(
            a.legs, [l.get_qindex(i)[0] for l, i in zip(a.legs, idx)])) \
            == a.qtotal
        value = float(rng.standard_normal())
        if allowed:
            a[idx] = value
            ja[idx] = value
        else:
            with pytest.raises(ValueError):
                a[idx] = value
            with pytest.raises(ValueError):
                ja[idx] = value
            a[idx] = 0.
            ja[idx] = 0.
    with pytest.raises(NotImplementedError):
        a[0] = 1.
    _same_struct(a, ja)
    _close(a, ja)


def _case_permute_sort(rng):
    (jv, v), (jp, p) = _unsorted_leg(rng, 5, 1), _leg(rng, 3, -1)
    ja = jnpc.Array.from_func(lambda s: rng.standard_normal(s),
                              [jv, jp, jv.conj()], qtotal=[0, 0],
                              labels=['a', 'p', 'b'])
    a = to_host(ja)
    perm = rng.permutation(v.ind_len)
    for axis in ('a', 2):
        res, jres = a.permute(perm, axis), ja.permute(perm, axis)
        _same_struct(res, jres)
        _close(res, jres)
    for kw in ({}, {'bunch': False}, {'sort': [True, False, False]},
               {'sort': [perm, True, False]}):
        (perms, res), (jperms, jres) = a.sort_legcharge(**kw), \
            ja.sort_legcharge(**kw)
        assert all(np.array_equal(x, y) for x, y in zip(perms, jperms))
        _same_struct(res, jres)
        _close(res, jres)
    (perms, res), (jperms, jres) = a.as_completely_blocked(), \
        ja.as_completely_blocked()
    assert all(np.array_equal(x, y) for x, y in zip(perms, jperms))
    _same_struct(res, jres)
    _close(res, jres)
    b = res
    assert b.as_completely_blocked()[1] is b


def _case_blockwise(rng):
    ja, a = _both(rng, complex_=True)
    jb, b = _both(rng)
    for res, jres in ((a.complex_conj(), ja.complex_conj()),
                      (a.real, ja.real), (a.imag, ja.imag),
                      (b.real, jb.real), (b.imag, jb.imag),
                      (a.unary_blockwise(lambda x: 2. * x + 1.),
                       ja.unary_blockwise(lambda x: 2. * x + 1.)),
                      (a.copy().iscale_prefactor(0.5 - 2j),
                       ja.copy().iscale_prefactor(0.5 - 2j)),
                      (a.copy().iunary_blockwise(lambda x: x * x),
                       ja.copy().iunary_blockwise(lambda x: x * x))):
        _same_struct(res, jres)
        _close(res, jres)
    jc = jnpc.Array.from_func(lambda size: rng.standard_normal(size),
                              ja.legs, qtotal=ja.qtotal,
                              labels=list(ja.get_leg_labels()))
    c = to_host(jc)
    res = a.binary_blockwise(lambda x, y: x * y - y, c)
    jres = ja.binary_blockwise(lambda x, y: x * y - y, jc)
    _same_struct(res, jres)
    _close(res, jres)
    res = a.copy().iadd_prefactor_other(0.25j, c)
    jres = ja.copy().iadd_prefactor_other(0.25j, jc)
    _same_struct(res, jres)
    _close(res, jres)
    d = a.copy()
    d._data[0] = d._data[0] * 1e-17
    jd = ja.copy()
    jd._data[0] = jd._data[0] * 1e-17
    res, jres = d.ipurge_zeros(1e-15), jd.ipurge_zeros(1e-15)
    _same_struct(res, jres)
    _close(res, jres)


def _case_constructors(rng):
    (jv, v), (jp, p) = _leg(rng, 4, 1), _leg(rng, 3, -1)
    res = npc.ones([v, p], qtotal=[0, 0], labels=['a', 'b'])
    jres = jnpc.ones([jv, jp], qtotal=[0, 0], labels=['a', 'b'])
    _same_struct(res, jres)
    _close(res, jres)
    ja, a = _both(rng, qtotal=[1, 1])
    dense = ja.to_numpy()
    for ax in range(3):
        legs = list(a.legs)
        jlegs = list(ja.legs)
        legs[ax] = jlegs[ax] = None
        for qc in (1, -1):
            leg = npc.detect_legcharge(dense, CH, legs, a.qtotal, qc)
            jleg = jnpc.detect_legcharge(dense, JCH, jlegs, ja.qtotal, qc)
            assert np.array_equal(leg.slices, jleg.slices)
            assert np.array_equal(leg.charges, jleg.charges)
            assert leg.qconj == jleg.qconj
    assert np.array_equal(
        npc.detect_legcharge(torch.from_numpy(dense), CH, legs,
                             a.qtotal).charges,
        jnpc.detect_legcharge(dense, JCH, jlegs, ja.qtotal).charges)
    # an MPO-like grid: one leg detected from its entries
    jId, Id = _random(rng, [jp, jp.conj()], ['p', 'p*'], qtotal=[0, 0])
    jX, X = _random(rng, [jp, jp.conj()], ['p', 'p*'], qtotal=[1, -1])
    jY = jX.conj().itranspose([1, 0])
    jY.iset_leg_labels(['p', 'p*'])
    Y = to_host(jY)
    qflat = [[0, 0], list(jX.qtotal), [0, 0]]       # the grid's charges
    jL = JLegCharge.from_qflat(JCH, qflat)
    L = LegCharge.from_qflat(CH, qflat)
    grid = [[Id, X, None], [None, None, Y], [None, None, Id]]
    jgrid = [[jId, jX, None], [None, None, jY], [None, None, jId]]
    for legs, jlegs in (([L, None], [jL, None]),
                        ([None, L.conj()], [None, jL.conj()])):
        got = npc.detect_grid_outer_legcharge(grid, legs)
        jgot = jnpc.detect_grid_outer_legcharge(jgrid, jlegs)
        for l, jl in zip(got, jgot):
            assert np.array_equal(l.slices, jl.slices)
            assert np.array_equal(l.charges, jl.charges)
            assert l.qconj == jl.qconj
        res = npc.grid_outer(grid, legs, grid_labels=['wL', 'wR'])
        jres = jnpc.grid_outer(jgrid, jlegs, grid_labels=['wL', 'wR'])
        _same_struct(res, jres)
        _close(res, jres)
    with pytest.raises(ValueError) if any(jX.qtotal) else \
            warnings.catch_warnings():   # X and Id disagree on a charge
        npc.detect_grid_outer_legcharge(
            [[Id, X], [X, Id]],
            [None, LegCharge.from_qflat(CH, [[0, 0], [0, 0]], -1)])
    # grid_concat: a 2x2 grid of blocks along (vL, vR)
    (jw, _) = _leg(rng, 3, -1)
    jparts = np.empty((2, 2), dtype=object)   # np.asarray would unpack
    parts = np.empty((2, 2), dtype=object)    # Arrays of one shape
    for i, j in np.ndindex(2, 2):
        jparts[i, j] = _random(rng, [jv, jp, jw], ['vL', 'p', 'vR'],
                               [0, 0])[0]
        parts[i, j] = to_host(jparts[i, j])
    res = npc.grid_concat(parts, ['vL', 'vR'])
    jres = jnpc.grid_concat(jparts, ['vL', 'vR'])
    _same_struct(res, jres)
    _close(res, jres)


def _square(rng, complex_=False, hermitian=False):
    (jv, _) = _leg(rng, 5, 1)
    ja = jnpc.Array.from_func(lambda s: rng.standard_normal(s)
                              + (1j * rng.standard_normal(s) if complex_
                                 else 0.), [jv, jv.conj()], qtotal=[0, 0],
                              labels=['a', 'a*'])
    if hermitian:
        ja = ja + ja.conj().itranspose([1, 0]).iset_leg_labels(['a', 'a*'])
    return ja, to_host(ja)


def _case_eig(rng):
    for complex_ in (False, True):
        ja, a = _square(rng, complex_)
        W, V = npc.eig(a)
        jW, jV = jnpc.eig(ja)
        assert V.dtype == torch.complex128 and W.dtype == np.complex128
        _close(np.sort_complex(W), np.sort_complex(np.asarray(jW)))
        # the residual a V - V diag(W), blockwise, and V's columns normed
        lhs = npc.tensordot(a, V, axes=[[1], [0]])
        rhs = V.scale_axis(W, 1)
        assert npc.norm(lhs - rhs) <= TOL * npc.norm(a) * 10
        for sort in ('m>', '<', '>', 'm<'):
            Ws = npc.eigvals(a, sort=sort)
            _close(Ws, np.asarray(jnpc.eigvals(ja, sort=sort)))
            Ws2, _ = npc.eig(a, sort=sort)
            _close(Ws2, Ws)
        jh, h = _square(rng, complex_, hermitian=True)
        for sort in (None, 'm>'):
            W, V = npc.eigh(h, sort=sort)
            jW, jV = jnpc.eigh(jh, sort=sort)
            _close(W, np.asarray(jW))
            _close(npc.eigvalsh(h, sort=sort),
                   np.asarray(jnpc.eigvalsh(jh, sort=sort)))
            lhs = npc.tensordot(h, V, axes=[[1], [0]])
            assert npc.norm(lhs - V.scale_axis(W, 1)) <= \
                TOL * npc.norm(h) * 10


def _case_pinv_speigs(rng):
    ja, a = _both(rng)
    jm = ja.combine_legs([['vL', 'p']], qconj=[+1])
    m = a.combine_legs([['vL', 'p']], qconj=[+1])
    res, jres = npc.pinv(m, 1e-10), jnpc.pinv(jm, 1e-10)
    _same_struct(res, jres)
    _close(res, jres)
    # Moore-Penrose: m pinv(m) m = m
    mm = npc.tensordot(npc.tensordot(m, res, axes=[[1], [0]]), m,
                       axes=[[1], [0]])
    assert npc.norm(mm - m) <= TOL * npc.norm(m) * 10
    (jv, v) = _leg(rng, 8, 1)
    jb = jnpc.Array.from_func(lambda s: rng.standard_normal(s),
                              [jv, jv.conj()], qtotal=[0, 0])
    jh = jnpc.tensordot(jb, jb.conj().itranspose([1, 0]), axes=[[1], [0]])
    h = to_host(jh)
    for q in {tuple(x) for x in np.asarray(v.charges)}:
        n = int(sum(v.slices[i + 1] - v.slices[i]
                    for i in range(v.block_number)
                    if tuple(v.charges[i]) == q))
        k = 2 if n > 4 else 1
        W, vecs = npc.speigs(h, list(q), k, v0=np.ones(n) if n > 4 else None) \
            if n > 4 else npc.speigs(h, list(q), k)
        jW, jvecs = jnpc.speigs(jh, list(q), k, v0=np.ones(n)) if n > 4 \
            else jnpc.speigs(jh, list(q), k)
        _close(np.sort(np.abs(W)), np.sort(np.abs(jW)))
        for w, x in zip(W, vecs):
            hx = npc.tensordot(h, x, axes=[[1], [0]])
            assert npc.norm(hx - x * complex(w)) <= 1e-10 * abs(w)


def _case_qr_lq(rng):
    """Full-rank and rank-deficient (a zero last column per sector, where
    R's diagonal vanishes) matrices; Q and R entry by entry where the gauge is fixed
    (``pos_diag_R`` on the full-rank columns), else through ``Q R``."""
    ja, a = _both(rng, complex_=bool(rng.integers(2)))
    jm = ja.combine_legs([['vL', 'p']], qconj=[+1])
    m = a.combine_legs([['vL', 'p']], qconj=[+1])
    q, r = npc.qr(m, inner_labels=['vR', 'vL'], pos_diag_R=True)
    jq, jr = jnpc.qr(jm, inner_labels=['vR', 'vL'], pos_diag_R=True)
    for x, jx in ((q, jq), (r, jr)):
        _same_struct(x, jx)
        _close(x, jx)
    cols = np.ones(a.shape[2])      # each sector's last column zero
    cols[a.get_leg('vR').slices[1:] - 1] = 0.
    ja, a = ja.scale_axis(cols, 'vR'), a.scale_axis(cols, 'vR')
    jm = ja.combine_legs([['vL', 'p']], qconj=[+1])
    m = a.combine_legs([['vL', 'p']], qconj=[+1])
    for mode in ('reduced', 'complete'):
        for cutoff in (None, 1e-12):
            pos = mode == 'reduced' and cutoff is not None
            q, r = npc.qr(m, mode=mode, inner_labels=['vR', 'vL'],
                          cutoff=cutoff, pos_diag_R=pos)
            jq, jr = jnpc.qr(jm, mode=mode, inner_labels=['vR', 'vL'],
                             cutoff=cutoff, pos_diag_R=pos)
            _close(npc.tensordot(q, r, axes=[[1], [0]]), jm)
            for x, jx in ((q, jq), (r, jr)):
                _same_struct(x, jx)
                if pos:
                    _close(x, jx)
            qq = npc.tensordot(q.conj(), q, axes=[[0], [0]])
            assert npc.norm(qq - npc.eye_like(qq, 0)) <= TOL * 10 \
                or cutoff is None and mode == 'reduced'
    jm, m = jm.transpose([1, 0]), m.transpose([1, 0])   # zero last rows
    for mode in ('reduced', 'complete'):
        for cutoff in (None, 1e-12):
            pos = mode == 'reduced' and cutoff is not None
            l, q = npc.lq(m, mode=mode, inner_labels=['vR', 'vL'],
                          cutoff=cutoff, pos_diag_L=pos)
            jl, jq = jnpc.lq(jm, mode=mode, inner_labels=['vR', 'vL'],
                             cutoff=cutoff, pos_diag_L=pos)
            _close(npc.tensordot(l, q, axes=[[1], [0]]), jm)
            for x, jx in ((l, jl), (q, jq)):
                _same_struct(x, jx)
                if pos:
                    _close(x, jx)


NPC_CASES = {'small_methods': _case_small_methods,
             'trivial_and_blocks': _case_trivial_and_blocks,
             'getitem': _case_getitem, 'setitem': _case_setitem,
             'permute_sort': _case_permute_sort, 'blockwise': _case_blockwise,
             'constructors': _case_constructors, 'eig': _case_eig,
             'pinv_speigs': _case_pinv_speigs, 'qr_lq': _case_qr_lq}


@pytest.mark.parametrize('name', sorted(NPC_CASES))
@pytest.mark.parametrize('seed', [0, 1])
def test_npc_rest_vs_jax(name, seed):
    NPC_CASES[name](np.random.default_rng(seed))


# ------------------------------------------------------------------ charges
def test_charges_vs_jax():
    rng = np.random.default_rng(3)
    (jv, v) = _leg(rng, 5, -1)
    assert v.to_qdict() == jv.to_qdict()
    back = LegCharge.from_qdict(CH, v.to_qdict(), -1)
    assert back == v and not (back != v)
    jback = JLegCharge.from_qdict(JCH, jv.to_qdict(), -1)
    assert np.array_equal(back.slices, jback.slices)
    for qi in range(v.block_number):
        assert np.array_equal(v.get_charge(qi), jv.get_charge(qi))
    (ju, u) = _unsorted_leg(rng, 6, 1)
    assert np.array_equal(u.charge_sectors(), ju.charge_sectors())
    u.test_sanity()
    with pytest.raises(ValueError):
        LegCharge.from_qdict(CH, {(0, 0): slice(0, 2), (1, 1): slice(3, 4)})
    assert v != v.conj() and CH != ChargeInfo([1]) and not (CH != CH)
    assert JCH != JCH.__class__([1]) and not (JCH != JCH)
    (jw, w) = _leg(rng, 3, 1)
    pipe = LegPipe([v, w], qconj=1)
    jpipe = JLegPipe([jv, jw], qconj=1)
    oc, joc = pipe.outer_conj(), jpipe.outer_conj()
    assert oc.qconj == joc.qconj == -1
    assert all(a is b for a, b in zip(oc.legs, pipe.legs))
    assert np.array_equal(oc.charges, joc.charges)
    assert np.array_equal(oc.slices, joc.slices)
    assert np.array_equal(oc.q_map, joc.q_map)


# --------------------------------------------------------------- svd_robust
@pytest.mark.parametrize('complex_', [False, True])
def test_svd_robust_vs_jax(complex_):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((7, 5))
    if complex_:
        a = a + 1j * rng.standard_normal((7, 5))
    for kw in ({}, {'full_matrices': False}, {'lapack_driver': 'gesvd'}):
        U, S, Vh = svd_robust.svd(a, **kw)
        jU, jS, jVh = jsvd.svd(a, **kw)
        assert isinstance(U, np.ndarray) and U.shape == jU.shape
        _close(S, jS)
        k = len(S)
        _close((U[:, :k] * S) @ Vh[:k], a)
        tU, tS, tVh = svd_robust.svd(torch.from_numpy(a), **kw)
        assert isinstance(tS, torch.Tensor)
        _close(tS, jS)
    _close(svd_robust.svd(a, compute_uv=False),
           jsvd.svd(a, compute_uv=False))
    with pytest.raises(ValueError):
        svd_robust.svd(np.full((2, 2), np.nan))


def test_svd_robust_retry(monkeypatch):
    """A gesdd that fails (raises, or gives NaN) is retried with gesvd,
    with a warning, also from inside np_conserved.svd."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((6, 4))
    ref = np.linalg.svd(a, compute_uv=False)
    real_svd = torch.linalg.svd
    for failure in ('raise', 'nan'):
        def broken(t, *args, **kw):
            if failure == 'raise':
                raise torch.linalg.LinAlgError("did not converge")
            u, s, vh = real_svd(t, *args, **kw)
            return u, s * np.nan, vh
        monkeypatch.setattr(torch.linalg, 'svd', broken)
        with pytest.warns(UserWarning, match='retrying with gesvd'):
            U, S, Vh = svd_robust.svd(torch.from_numpy(a),
                                      full_matrices=False)
        _close(S, ref)
        _close((U * S) @ Vh, a)
        with warnings.catch_warnings():
            warnings.simplefilter('error')
            svd_robust.svd(a, lapack_driver='gesvd', full_matrices=False)
        (jv, v), (jw, w) = _leg(rng, 4, 1), _leg(rng, 4, -1)
        jm, _ = _random(rng, [jv, jw], ['a', 'b'])
        with pytest.warns(UserWarning, match='retrying with gesvd'):
            S_npc = npc.svd(to_host(jm), compute_uv=False)
        _close(np.sort(S_npc), np.sort(np.asarray(
            jnpc.svd(jm, compute_uv=False))))
        monkeypatch.setattr(torch.linalg, 'svd', real_svd)


# -------------------------------------------------------- tools/math, misc
class _Op:
    def __init__(self, mat):
        self.mat, self.dim, self.dtype = mat, mat.shape[0], mat.dtype

    def matvec(self, x):
        return self.mat @ x


def test_math_vs_jax():
    rng = np.random.default_rng(6)
    mat = rng.standard_normal((6, 6))
    _close(tmath.matvec_to_array(_Op(mat)), jmath.matvec_to_array(_Op(mat)))
    _close(tmath.matvec_to_array(_Op(mat)), mat)
    for x, y in ((12, 18), (-7, 21), (0, 5), (0, 0), (13, 17)):
        assert tmath.gcd(x, y) == jmath.gcd(x, y)
        assert tmath.lcm(x, y) == jmath.lcm(x, y)
    arr = np.array([12, 18, -30, 42])
    assert tmath.gcd_array(arr) == jmath.gcd_array(arr) == 6
    with pytest.raises(ValueError):
        tmath.gcd_array([])
    for p in ([0, 1, 2], [1, 0, 2], [2, 0, 1], list(rng.permutation(7))):
        assert tmath.perm_sign(p) == jmath.perm_sign(p)
    sym = mat + mat.T
    v0 = np.ones(6)
    for k, which in ((2, 'LM'), (5, 'LM'), (6, 'SA'), (2, 'SA')):
        W, V = tmath.speigsh(sym, k, which=which, v0=v0) if k < 5 \
            else tmath.speigsh(sym, k, which=which)
        jW, jV = jmath.speigsh(sym, k, which=which, v0=v0) if k < 5 \
            else jmath.speigsh(sym, k, which=which)
        _close(np.sort(W), np.sort(jW))
        _close(sym @ V, V * W)
        W, V = tmath.speigs(mat, min(k, 3), which='LM', v0=v0) if k < 5 \
            else tmath.speigs(mat, k, which='LM')
        jW, jV = jmath.speigs(mat, min(k, 3), which='LM', v0=v0) if k < 5 \
            else jmath.speigs(mat, k, which='LM')
        _close(np.sort_complex(W), np.sort_complex(jW))
        _close(mat @ V, V * W)
    rank2 = rng.standard_normal((6, 2)) @ rng.standard_normal((2, 5))
    for A in (rank2, rank2.T, rank2 + 1j * rank2[::-1]):
        q, r = tmath.qr_li(A)
        jq, jr = jmath.qr_li(A)
        assert q.shape == jq.shape == (A.shape[0], 2)
        _close(q, jq)
        _close(r, jr)
        _close(q @ r, A)
        r2, q2 = tmath.rq_li(A)
        jr2, jq2 = jmath.rq_li(A)
        _close(r2, jr2)
        _close(q2, jq2)
        _close(r2 @ q2, A)
    p = rng.random(8)
    p /= p.sum()
    for n in (1, 2, np.inf):
        _close(tmath.entropy(p, n), jmath.entropy(p, n))


def test_misc_vs_jax():
    rng = np.random.default_rng(7)
    a = rng.standard_normal(5)
    assert tmisc.anynan(a) == jmisc.anynan(a) is False
    a[2] = np.nan
    assert tmisc.anynan(a) == jmisc.anynan(a) is True
    lst = [1, [0, 1], 2, 1, np.array([0, 1]), 'x']
    assert tmisc.list_to_dict_list(lst) == jmisc.list_to_dict_list(lst)
    ragged = [[1, 2, 3], [4], [], [5, 6]]
    assert np.array_equal(tmisc.atleast_2d_pad(ragged, -1),
                          jmisc.atleast_2d_pad(ragged, -1))
    assert tmisc.transpose_list_list(ragged, 'p') == \
        jmisc.transpose_list_list(ragged, 'p')
    z = np.array([1e-16, -2e-16, 0.5, 1e-3]) \
        + 1j * np.array([0.2, 1e-17, -1e-16, 0.])
    assert np.array_equal(tmisc.zero_if_close(z), jmisc.zero_if_close(z))
    assert np.array_equal(tmisc.zero_if_close(z.real, 1e-2),
                          jmisc.zero_if_close(z.real, 1e-2))
    x = rng.standard_normal((3, 4))
    for kw in ({'w_l': 2, 'v_l': -1.}, {'w_r': 1, 'v_r': 7., 'axis': 1},
               {'w_l': 1, 'w_r': 3, 'v_l': 2., 'v_r': 3., 'axis': 0}):
        assert np.array_equal(tmisc.pad(x, **kw), jmisc.pad(x, **kw))
    E = np.array([0., 1., 1. + 1e-14, 0., 2., 1.])
    extra = np.array([0., 1., 1., 1., 2., 1.])
    for args, kw in (((), {}), ((extra,), {}), ((), {'subset': [5, 1, 2]}),
                     ((), {'cutoff': 1.5})):
        assert tmisc.group_by_degeneracy(E, *args, **kw) == \
            jmisc.group_by_degeneracy(E, *args, **kw)
