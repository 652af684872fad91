"""Native complex128 in the port's packed layer against ``tenpy_tpu``.

``tenpy_tpu`` stores a complex :class:`PackedArray` as two f64 channels and
multiplies them with three real GEMMs; the port stores complex128 buffers
and multiplies them in the kernel's complex mode (on the CPU: its plain
version, ``torch.bmm`` on complex128).  The same seeded inputs go through
both packages, on the cases of ``tests/test_packed_complex.py``:

* pack/unpack, tensordot (complex x complex and real x complex), conj,
  ``inner``, ``inner_re``, ``norm`` and complex scalars: 1e-12 (summation
  order only; the numbers are O(1) to O(10));
* ``split_truncate`` of a random complex theta: Schmidt values to 1e-12
  and the reconstructed truncated theta to 1e-10 of its norm (singular
  vectors have a free phase per sector, so U and V are never compared
  entry by entry);
* the grouped GEMM's plain version on complex blocks against
  ``pallas_gemm.reference_segsum``'s loop done in complex: 1e-12.
"""
import numpy as np
import pytest
import torch

from tenpy_tpu.linalg import np_conserved as jnpc, packed as jpk, \
    packed_split as jps
from tenpy_tpu.linalg.charges import ChargeInfo, LegCharge
from tenpy_tpu_torch.linalg import grouped_gemm as gg
from tenpy_tpu_torch.linalg import packed as pk
from tenpy_tpu_torch.linalg import packed_split as ps

import torch_exchange as tx

torch.set_num_threads(1)


def _leg(n, seed, qconj=1):
    """A sorted, bunched U(1) leg of ``n`` states with seeded charges."""
    q = np.random.default_rng(seed).integers(-2, 3, size=(n, 1))
    _, leg = LegCharge.from_qflat(ChargeInfo([1], ['q']), q, qconj).sort()
    return leg


def _rand_complex(legs, qtotal=None):
    return jnpc.Array.from_func(
        lambda s: (np.random.standard_normal(s)
                   + 1j * np.random.standard_normal(s)),
        legs, dtype=np.complex128, qtotal=qtotal)


def _dense(p, legs):
    """A port PackedArray as a dense numpy array on the unpadded legs."""
    return pk.unpack(p, orig_legs=legs).to_ndarray()


def _jdense(p, legs):
    return np.asarray(jpk.unpack(p, orig_legs=legs).to_ndarray())


def test_pack_unpack_complex_roundtrip():
    np.random.seed(5)
    a = _rand_complex([_leg(12, 1), _leg(12, 2, -1), _leg(12, 3)])
    p = pk.pack(tx.to_host(a), multiple=8, device='cpu')
    assert p.dtype == torch.complex128
    assert all(d.dtype == torch.complex128 for d in p.data)   # no channels
    got = _dense(p, tx.to_host(a).legs)
    want = np.asarray(a.to_ndarray())
    assert np.array_equal(got, want)
    assert np.array_equal(got, _jdense(jpk.pack(a, multiple=8), a.legs))


@pytest.mark.parametrize('kind', ['complex', 'real'])
def test_tensordot_complex_vs_jax(kind):
    """Complex x complex, and complex x real (promoted to complex128)."""
    np.random.seed(7)
    l1, l2, l3 = _leg(10, 4), _leg(8, 5, -1), _leg(9, 6)
    a = _rand_complex([l1, l2])
    b = (_rand_complex([l2.conj(), l3]) if kind == 'complex' else
         jnpc.Array.from_func(np.random.standard_normal, [l2.conj(), l3]))
    a.iset_leg_labels(['x', 'y'])
    b.iset_leg_labels(['y*', 'z'])
    jres = jpk.tensordot(jpk.pack(a, multiple=8), jpk.pack(b, multiple=8),
                         axes=(['y'], ['y*']))
    ap = pk.pack(tx.to_host(a), multiple=8, device='cpu')
    bp = pk.pack(tx.to_host(b), multiple=8, device='cpu')
    assert bp.dtype == (torch.complex128 if kind == 'complex'
                        else torch.float64)
    res = pk.tensordot(ap, bp, axes=(['y'], ['y*']))
    assert res.dtype == torch.complex128
    want = np.asarray(jnpc.tensordot(a, b, axes=[['y'], ['y*']]).to_ndarray())
    legs = [tx.to_host(a).legs[0], tx.to_host(b).legs[1]]
    got = _dense(res, legs)
    assert np.abs(got - _jdense(jres, [a.legs[0], b.legs[1]])).max() <= 1e-12
    assert np.abs(got - want).max() <= 1e-12
    with pytest.raises(NotImplementedError, match='complex'):
        with pk.matmul_mode('f32'):
            pk.tensordot(ap, bp, axes=(['y'], ['y*']))


def test_conj_inner_norm_vs_jax():
    np.random.seed(11)
    legs = [_leg(8, 7), _leg(8, 8, -1)]
    a, b = _rand_complex(legs), _rand_complex(legs)
    ja, jb = jpk.pack(a, multiple=8), jpk.pack(b, multiple=8)
    ap = pk.pack(tx.to_host(a), multiple=8, device='cpu')
    bp = pk.pack(tx.to_host(b), multiple=8, device='cpu')
    hlegs = tx.to_host(a).legs
    # conj conjugates the data as well as flipping the legs
    ac = ap.conj()
    assert np.array_equal(_dense(ac, [l.conj() for l in hlegs]),
                          np.conj(np.asarray(a.to_ndarray())))
    assert all(x.data_ptr() != y.data_ptr() and not x.is_conj()
               for x, y in zip(ac.data, ap.data))
    want = complex(jpk.inner(ja.conj(), jb))
    got = pk.inner(ap.conj(), bp)
    assert got.dtype == torch.complex128 and abs(want.imag) > 1e-2
    assert abs(complex(got) - want) <= 1e-12 * abs(want)
    # inner_re conjugates its first argument itself, and only once
    re = pk.inner_re(ap, bp)
    assert re.dtype == torch.float64
    assert abs(float(re) - float(jpk.inner_re(ja, jb))) <= 1e-12 * abs(want)
    assert abs(float(re) - want.real) <= 1e-12 * abs(want)
    nrm = float(pk.norm(ap))
    assert abs(nrm - float(jpk.norm(ja))) <= 1e-12 * nrm
    assert abs(nrm - float(jnpc.norm(a))) <= 1e-12 * nrm
    assert abs(float(pk.norm_sq(ap)) - nrm ** 2) <= 1e-12 * nrm ** 2
    # scalar algebra with a complex scalar, and a real array promoted by it
    s = 0.3 - 0.7j
    got3 = _dense(ap * s - bp, hlegs)
    assert np.abs(got3 - _jdense(ja * s - jb, legs)).max() <= 1e-12
    r = jnpc.Array.from_func(np.random.standard_normal, legs)
    rp = pk.pack(tx.to_host(r), multiple=8, device='cpu')
    got4 = _dense(rp * s, hlegs)
    assert np.abs(got4 - np.asarray(r.to_ndarray()) * s).max() <= 1e-12


def _split_inputs():
    """A random complex theta (vL, p0, p1, vR) with one U(1) charge."""
    np.random.seed(3)
    vL, p, vR = _leg(12, 9), _leg(3, 10), _leg(12, 11, -1)
    th = _rand_complex([vL, p, p, vR])
    th.iset_leg_labels(['vL', 'p0', 'p1', 'vR'])
    return th


def test_split_truncate_complex_vs_jax():
    th = _split_inputs()
    qtot_A = [0]
    chi = 10      # of 17 nonzero Schmidt values: the cut is by chi
    out = {}
    for name, mod, split in (('jax', jpk, jps), ('port', pk, ps)):
        arr = th if name == 'jax' else tx.to_host(th)
        kw = {} if name == 'jax' else {'device': 'cpu'}
        thp = mod.pack(arr, multiple=16, pad_labels=('vL', 'vR'), **kw)
        bond = split.bond_layout(thp.legs, thp.qtotal, qtot_A, multiple=16)
        plan = split.split_plan(thp, bond, qtot_A, group_multiple=16)
        A, S, B, err, renorm, n_kept = split.split_truncate(
            thp, plan, chi_max=chi, svd_min=1e-10, backend='svd')
        rec = mod.tensordot(split.scale_bond(A, S, split.scale_bond_plan(
            A, 'vR')), B, axes=(['vR'], ['vL']))
        legs = [arr.get_leg(l) for l in ('vL', 'p0', 'p1', 'vR')]
        dense = (_jdense if name == 'jax' else _dense)(rec, legs)
        S = np.asarray(S)
        out[name] = (np.sort(S[S > 0])[::-1], float(err), float(renorm),
                     int(n_kept), dense * float(renorm))
        if name == 'port':
            assert A.dtype == B.dtype == torch.complex128
            # S is real; A is a left isometry on its kept columns
            assert not torch.is_complex(torch.as_tensor(S))
            AA = pk.tensordot(A.conj(), A, axes=(['vL*', 'p*'], ['vL', 'p']))
            for blk in pk.unpack(AA)._data:
                d = torch.diagonal(blk).real
                assert float((d * (1. - d)).abs().max()) < 1e-12
                off = blk - torch.diag(torch.diagonal(blk))
                assert float(off.abs().max()) < 1e-12
    (Sj, ej, rj, nj, tj), (Sp, ep, rp, npt, tp) = out['jax'], out['port']
    assert npt == nj == chi
    assert np.abs(Sp - Sj).max() <= 1e-12
    assert abs(ep - ej) <= 1e-12 and abs(rp - rj) <= 1e-12 * rj
    assert np.abs(tp - tj).max() <= 1e-10 * np.linalg.norm(tj)
    assert np.abs(tp.imag).max() > 0.1


@pytest.mark.parametrize('case', [(3, 4, 8, 8, 8, 2, 3),
                                  (3, 2, 1, 3, 5, 2, 3),
                                  (5, 6, 8, 16, 8, 2, 40)])
def test_grouped_gemm_complex_plain(case):
    Na, Nb, m, k, n, U, fan_in = case
    rng = np.random.default_rng(4)
    a = rng.standard_normal((Na, m, k)) + 1j * rng.standard_normal((Na, m, k))
    b = rng.standard_normal((Nb, k, n)) + 1j * rng.standard_normal((Nb, k, n))
    B = fan_in * U
    seg = np.sort(np.concatenate([np.arange(U), rng.integers(0, U, B - U)]))
    ia, ib = rng.integers(0, Na, B), rng.integers(0, Nb, B)
    seg_ptr = np.concatenate([[0], np.cumsum(np.bincount(seg, minlength=U))])
    i32 = [torch.from_numpy(x.astype(np.int32)) for x in (seg_ptr, ia, ib)]
    n0 = gg.LAUNCHES
    got = gg.grouped_gemm_segsum(torch.from_numpy(a), torch.from_numpy(b),
                                 *i32, U).numpy()
    assert gg.LAUNCHES == n0
    want = np.zeros((U, m, n), complex)
    for t in range(B):
        want[seg[t]] += a[ia[t]] @ b[ib[t]]
    assert got.dtype == np.complex128
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    tables = gg.segsum_tables(torch.from_numpy(a), torch.from_numpy(b),
                              *i32, U)
    with pytest.raises(NotImplementedError, match='complex f32'):
        gg.packed_contract([torch.from_numpy(a)], [torch.from_numpy(b)],
                           tables, torch.float32)
