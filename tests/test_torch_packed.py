"""The port's PackedArray against ``tenpy_tpu.linalg.packed`` on the same inputs.

Both packages build the same packed layout (same shapes, same qdata rows, in
the same order), so results are compared bucket by bucket.  Tolerance
1e-12 relative (f64): the two sum in different orders (segment sum per
bucket pair, then gather-sum, against one gather-sum), nothing else.
"""
import numpy as np
import pytest
import torch

import tenpy_tpu.linalg.np_conserved as npc
from tenpy_tpu.linalg import packed as jpk
from tenpy_tpu.linalg.charges import ChargeInfo
from tenpy_tpu_torch.linalg import packed as pk

from random_test import gen_random_legcharge, rng
from torch_exchange import assert_packed_close, to_host

torch.set_num_threads(1)

CHINFOS = [ChargeInfo([], []), ChargeInfo([1], ['N']),
           ChargeInfo([1, 1], ['N', 'Sz'])]


def _random_on_legs(legs):
    a = npc.Array.from_func(lambda size: rng.normal(size=size), legs)
    if a.stored_blocks == 0:
        from tenpy_tpu.linalg.np_conserved import _row_qtotal
        row = [rng.randint(l.block_number) for l in legs]
        a = npc.Array.from_func(lambda size: rng.normal(size=size), legs,
                                qtotal=_row_qtotal(legs, row))
    return a


@pytest.mark.parametrize('qn', [0, 1, 2])
@pytest.mark.parametrize('multiple', [1, 8])
def test_pack_unpack_roundtrip(qn, multiple):
    legs = [gen_random_legcharge(CHINFOS[qn], s) for s in [12, 9, 14]]
    a = _random_on_legs(legs)
    h = to_host(a)
    p = pk.pack(h, multiple=multiple, device='cpu')
    assert_packed_close(p, jpk.pack(a, multiple=multiple), rtol=0.)
    b = pk.unpack(p, orig_legs=h.legs)
    assert np.array_equal(b._qdata, h._qdata)
    for x, y in zip(b._data, h._data):
        assert np.array_equal(x, y)


@pytest.mark.parametrize('qn', [0, 1, 2])
def test_tensordot_vs_jax(qn):
    chinfo = CHINFOS[qn]
    l1 = gen_random_legcharge(chinfo, 13)
    l2 = gen_random_legcharge(chinfo, 8)
    l3 = gen_random_legcharge(chinfo, 11)
    a = _random_on_legs([l1, l2, l3])
    b = _random_on_legs([l3.conj(), l2.conj(), gen_random_legcharge(chinfo,
                                                                     9)])
    ja, jb = jpk.pack(a, multiple=8), jpk.pack(b, multiple=8)
    pa = pk.pack(to_host(a), multiple=8, device='cpu')
    pb = pk.pack(to_host(b), multiple=8, device='cpu')
    jpk.reset_flops()
    ref = jpk.tensordot(ja, jb, axes=([2, 1], [0, 1]))
    rec = pk.FlopRecorder()
    with pk.flop_record(rec):
        got = pk.tensordot(pa, pb, axes=([2, 1], [0, 1]))
    assert_packed_close(got, ref)
    # the same GEMM FLOP count as tenpy_tpu's counter
    assert rec.flops == jpk.FLOPS_TRACED


def test_tensordot_labels_transpose_conj():
    chinfo = CHINFOS[2]
    lv = gen_random_legcharge(chinfo, 16, qconj=1)
    lp = gen_random_legcharge(chinfo, 3, qconj=1)
    a = _random_on_legs([lv, lp, lv.conj()])
    a.iset_leg_labels(['vL', 'p', 'vR'])
    b = npc.Array.from_func(lambda size: rng.normal(size=size), a.legs,
                            qtotal=a.qtotal, labels=['vL', 'p', 'vR'])
    ja, jb = jpk.pack(a, multiple=8), jpk.pack(b, multiple=8)
    pa = pk.pack(to_host(a), multiple=8, device='cpu')
    pb = pk.pack(to_host(b), multiple=8, device='cpu')
    ref = jpk.tensordot(ja, jb.conj(), axes=(['p', 'vR'], ['p*', 'vR*']))
    got = pk.tensordot(pa, pb.conj(), axes=(['p', 'vR'], ['p*', 'vR*']))
    assert got.get_leg_labels() == ref.get_leg_labels()
    assert_packed_close(got, ref)
    assert_packed_close(pa.transpose(['vR', 'vL', 'p']),
                        ja.transpose(['vR', 'vL', 'p']), rtol=0.)
    assert_packed_close(pa * 2. - pb, ja * 2. - jb)


def test_inner_and_norm_vs_jax():
    legs = [gen_random_legcharge(CHINFOS[2], s) for s in [10, 7, 9]]
    a = _random_on_legs(legs)
    b = npc.Array.from_func(lambda size: rng.normal(size=size), legs,
                            qtotal=a.qtotal)
    ja, jb = jpk.pack(a, multiple=8), jpk.pack(b, multiple=8)
    pa = pk.pack(to_host(a), multiple=8, device='cpu')
    pb = pk.pack(to_host(b), multiple=8, device='cpu')
    ref_n = float(jpk.norm(ja))
    assert abs(float(pk.norm(pa)) - ref_n) <= 1e-12 * ref_n
    ref_i = float(jpk.inner(ja.conj(), jb))
    got_i = float(pk.inner(pa.conj(), pb))
    assert abs(got_i - ref_i) <= 1e-12 * ref_n * float(jpk.norm(jb))
    assert abs(float(pk.inner_re(pa, pb)) - float(jpk.inner_re(ja, jb))) \
        <= 1e-12 * ref_n * float(jpk.norm(jb))


def _hubbard_effH_random(sector=3):
    """Two-site effective-H pieces: the U(1)xU(1) Hubbard chain MPO (the
    model of tests/test_packed.py) with random theta and environments on
    virtual legs holding every (N, Sz) in [-2, 2]^2 (a DMRG-ramped state
    costs a minute of host DMRG; the matvec's charge structure is alike)."""
    from tenpy_tpu.linalg.charges import LegCharge
    from tenpy_tpu.models.hubbard import FermiHubbardChain
    m = FermiHubbardChain({'L': 2, 't': 1., 'U': 4., 'bc_MPS': 'infinite'})
    W0 = m.H_MPO.get_W(0).replace_labels(['p', 'p*'], ['p0', 'p0*'])
    W1 = m.H_MPO.get_W(1).replace_labels(['p', 'p*'], ['p1', 'p1*'])
    chinfo = W0.chinfo
    charges = [(n, s) for n in range(-2, 3) for s in range(-2, 3)]
    slices = np.arange(len(charges) + 1) * sector
    vL = LegCharge(chinfo, slices, charges, 1)
    vR = LegCharge(chinfo, slices, charges, -1)

    def rand(legs, labels, qtotal=None):
        a = npc.Array.from_func(lambda size: rng.normal(size=size), legs,
                                qtotal=qtotal)
        a.iset_leg_labels(labels)
        return a

    theta = rand([vL, W0.get_leg('p0*').conj(), W1.get_leg('p1*').conj(),
                  vR], ['vL', 'p0', 'p1', 'vR'])
    LP = rand([vL, W0.get_leg('wL').conj(), vL.conj()], ['vR*', 'wR', 'vR'])
    RP = rand([W1.get_leg('wR').conj(), vR.conj(), vR], ['wL', 'vL', 'vL*'])
    return LP, RP, W0, W1, theta


def test_hubbard_effH_matvec_vs_jax():
    """U(1)xU(1) Hubbard effective-H matvec, with its GEMM FLOP count."""
    from tenpy_tpu.algorithms.mps_common import \
        _matvec_2site_packed as jax_matvec
    from tenpy_tpu_torch.algorithms.mps_common import _matvec_2site_packed
    LP, RP, W0, W1, theta = _hubbard_effH_random()
    VIRT = ('vL', 'vR', 'vL*', 'vR*')
    jargs = [jpk.pack(LP, multiple=8, pad_labels=VIRT),
             jpk.pack(RP, multiple=8, pad_labels=VIRT),
             jpk.pack(W0, pad=False), jpk.pack(W1, pad=False),
             jpk.pack(theta, multiple=8, pad_labels=VIRT)]
    pargs = [pk.pack(to_host(LP), multiple=8, pad_labels=VIRT, device='cpu'),
             pk.pack(to_host(RP), multiple=8, pad_labels=VIRT, device='cpu'),
             pk.pack(to_host(W0), pad=False, device='cpu'),
             pk.pack(to_host(W1), pad=False, device='cpu'),
             pk.pack(to_host(theta), multiple=8, pad_labels=VIRT,
                     device='cpu')]
    assert pargs[4].n_blocks > 50            # genuinely block-heavy
    jpk.reset_flops()
    ref = jax_matvec(*jargs)
    rec = pk.FlopRecorder()
    with pk.flop_record(rec):
        got = _matvec_2site_packed(*pargs)
    assert_packed_close(got, ref)
    assert rec.flops == jpk.FLOPS_TRACED > 0
