"""The port's packed-contraction tables and their plain walker.

``packed_contract`` takes its plain version on CPU tensors: a walk over the
same ``(tasks, entries)`` tables the CUDA kernel reads.

(a) The four tensordots of the two-site matvec on the small U(1)xU(1)
    Hubbard state of test_torch_packed.py (two of them the MPO contractions,
    k = n = 1), each against ``tenpy_tpu.linalg.packed.tensordot`` (JAX, CPU):
    f64 to 1e-12 relative (summation order only), and under
    ``matmul_mode('f32')`` to 1e-5 (f32 products).
(b) Several bucket pairs summing into one output row, and an output bucket
    that no entry reaches, against a numpy loop; the table invariants the
    kernel relies on.
(c) Shape-class selection.
(d) The entry points default to the card: without a CUDA device they raise
    before anything is built, and an empty PackedArray keeps its device.
"""
import numpy as np
import pytest
import torch

from tenpy_tpu.linalg import packed as jpk
from tenpy_tpu_torch.algorithms.packed_dmrg import (DeviceSweepEngine,
                                                    pack_S_from_leg)
from tenpy_tpu_torch.linalg import grouped_gemm as gg
from tenpy_tpu_torch.linalg import packed as pk

from test_torch_packed import _hubbard_effH_random
from torch_exchange import assert_packed_close, to_host

torch.set_num_threads(1)

VIRT = ('vL', 'vR', 'vL*', 'vR*')
# the matvec of mps_common._matvec_2site_packed, one tensordot per step:
# x = LP . theta, then x . W0, x . W1, x . RP; (operand index, axes, thin)
STEPS = [(4, (['vR'], ['vL']), False),
         (2, (['wR', 'p0'], ['wL', 'p0*']), True),
         (3, (['wR', 'p1'], ['wL', 'p1*']), True),
         (1, (['wR', 'vR'], ['wL', 'vL']), False)]


@pytest.fixture(scope='module')
def matvec_operands():
    LP, RP, W0, W1, theta = _hubbard_effH_random()
    jax_ops = [jpk.pack(LP, multiple=8, pad_labels=VIRT),
               jpk.pack(RP, multiple=8, pad_labels=VIRT),
               jpk.pack(W0, pad=False), jpk.pack(W1, pad=False),
               jpk.pack(theta, multiple=8, pad_labels=VIRT)]
    port_ops = [pk.pack(to_host(LP), multiple=8, pad_labels=VIRT,
                        device='cpu'),
                pk.pack(to_host(RP), multiple=8, pad_labels=VIRT,
                        device='cpu'),
                pk.pack(to_host(W0), pad=False, device='cpu'),
                pk.pack(to_host(W1), pad=False, device='cpu'),
                pk.pack(to_host(theta), multiple=8, pad_labels=VIRT,
                        device='cpu')]
    return jax_ops, port_ops


@pytest.mark.parametrize('mode, rtol', [(None, 1e-12), ('f32', 1e-5)])
def test_matvec_tensordots_vs_jax(matvec_operands, monkeypatch, mode, rtol):
    jax_ops, port_ops = matvec_operands
    calls = []
    walk = pk.packed_contract

    def recording(*args):
        calls.append(args)
        return walk(*args)

    monkeypatch.setattr(pk, 'packed_contract', recording)
    jx, px = jax_ops[0], port_ops[0]            # LP
    with pk.matmul_mode(mode), jpk.matmul_mode(mode):
        for i, (op, axes, thin) in enumerate(STEPS):
            ref = jpk.tensordot(jx, jax_ops[op], axes=axes)
            got = pk.tensordot(px, port_ops[op], axes=axes)
            assert len(calls) == i + 1        # one table walk per tensordot
            _, b_bufs, tables, compute = calls[-1]
            assert compute == (torch.float32 if mode else torch.float64)
            classes = set(tables.tasks[:, 0].tolist())
            assert classes == {0} if thin else 0 not in classes
            assert tables.thin == thin       # which kernel the card runs
            if thin:
                assert set(tables.entries[:, 4].tolist()) == {1}   # k = 1
                assert {b.shape[1:] for b in b_bufs} == {(1, 1, 1, 1)}
            assert_packed_close(got, ref, rtol=rtol)
            jx, px = ref, got


def _dense_reference(a_bufs, b_bufs, out_dims, cols):
    out = [np.zeros((r, m, n)) for r, m, n in out_dims]
    for so, row, ab, ablk, bb, bblk, k in cols.T:
        m, n = out_dims[so][1:]
        out[so][row] += (a_bufs[ab].reshape(-1, m, k)[ablk]
                         @ b_bufs[bb].reshape(-1, k, n)[bblk])
    return out


def test_cross_pair_row_sums_and_unreached_bucket():
    """Output bucket 0 sums two bucket pairs (k = 16 and k = 8) into the same
    rows; bucket 1 is thin (k = n = 1), bucket 2 thin with k = 3, bucket 3 a
    ragged block (k = 21) and bucket 4 gets no entry (thin: its tasks only
    write zeros).  The outputs are written into NaN-filled buffers."""
    rng = np.random.default_rng(5)
    a_shapes = [(6, 32, 16), (6, 32, 8), (7, 300, 1), (4, 12, 3),
                (3, 24, 21)]
    b_shapes = [(5, 16, 40), (5, 8, 40), (3, 1, 1), (4, 3, 5), (2, 21, 17)]
    out_dims = [(9, 32, 40), (8, 300, 1), (5, 12, 5), (4, 24, 17),
                (6, 16, 16)]
    pairs = [(0, 0, 30), (0, 1, 25), (1, 2, 30), (2, 3, 12), (3, 4, 9)]
    a_bufs = [rng.standard_normal(s) for s in a_shapes]
    b_bufs = [rng.standard_normal(s) for s in b_shapes]
    cols, k_min = [], [np.inf] * len(out_dims)
    for so, pi, cnt in pairs:
        k = a_shapes[pi][2]
        k_min[so] = min(k_min[so], k)
        cols.append(np.stack([
            np.full(cnt, so), rng.integers(0, out_dims[so][0], cnt),
            np.full(cnt, pi), rng.integers(0, a_shapes[pi][0], cnt),
            np.full(cnt, pi), rng.integers(0, b_shapes[pi][0], cnt),
            np.full(cnt, k)]))
    cols = np.concatenate(cols, axis=1)
    classes = [gg.shape_class(m, n, km)
               for (_, m, n), km in zip(out_dims, k_min)]
    assert classes == [gg.shape_class(32, 40, 8), 0, 0,
                       gg.shape_class(24, 17, 21), 0]
    tables = gg.build_tables(out_dims, classes, *torch.from_numpy(cols))
    assert not tables.thin
    tasks, entries = tables.tasks, tables.entries

    # invariants: every output row is tiled exactly once by tasks that
    # share one entry range; the first tasks' ranges partition the entries
    t = tasks.numpy()
    first = t[(t[:, 3] == 0) & (t[:, 4] == 0)]
    assert len(first) == sum(d[0] for d in out_dims)
    ranges = first[np.argsort(first[:, 5], kind='stable'), 5:7]
    assert ranges[0, 0] == 0 and ranges[-1, 1] == entries.shape[0]
    assert np.array_equal(ranges[1:, 0], ranges[:-1, 1])
    for so, (rows, m, n) in enumerate(out_dims):
        origins, _ = gg._tile_origins(classes[so], m, n)
        mine = t[t[:, 1] == so]
        assert len(mine) == rows * len(origins)
        for r in range(rows):
            tr = mine[mine[:, 2] == r]
            assert sorted(map(tuple, tr[:, 3:5])) == sorted(origins)
            assert len({tuple(x) for x in tr[:, 5:7]}) == 1
    rows0 = {}
    for so, row, ab in cols[:3].T:
        if so == 0:
            rows0.setdefault(row, set()).add(ab)
    assert any(len(s) == 2 for s in rows0.values())   # cross-pair sums

    nan = [torch.full(d, float('nan'), dtype=torch.float64)
           for d in out_dims]
    out = gg.packed_contract([torch.from_numpy(x) for x in a_bufs],
                             [torch.from_numpy(x) for x in b_bufs],
                             tables, out=nan)
    assert all(o is x for o, x in zip(out, nan))
    ref = _dense_reference(a_bufs, b_bufs, out_dims, cols)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert np.abs(o.numpy() - r).max() <= 1e-12 * max(np.abs(r).max(), 1)
    assert not out[4].any()


def test_shape_classes():
    assert gg.shape_class(4096, 1, 1) == 0        # MPO contraction
    assert gg.shape_class(64, 1, 1) == 0
    assert gg.shape_class(64, 64, 3) == 0          # shallow k
    assert gg.shape_class(4, 64, 64) == 0
    for m in (8, 16, 32, 64, 128):
        for n in (8, 16, 32, 64):
            cls = gg.shape_class(m, n, 8)
            assert 1 <= cls <= 9
            assert gg.class_tile(cls) == (min(m, 32), min(n, 32))
    assert gg.shape_class(24, 40, 8) == 1 + 3 * 1 + 2      # 16 x 32 tiles
    assert gg.shape_class(64, 64, np.inf) == 0      # no entry: zeros only
    assert gg.class_tile(0) is None
    # the thin kernel runs tables whose non-empty buckets are all thin
    empty = torch.zeros((0,), dtype=torch.int64)
    thin = gg.build_tables([(3, 64, 1), (0, 32, 32)], [0, 9], *[empty] * 7)
    assert thin.thin and thin.tasks.shape == (3, 8)
    assert not gg.build_tables([(3, 64, 1), (1, 32, 32)], [0, 9],
                               *[empty] * 7).thin


def test_entry_points_default_to_the_card():
    legs_src = _hubbard_effH_random(sector=1)[4]
    host = to_host(legs_src)
    if torch.cuda.is_available():
        assert pk.pack(host).device.type == 'cuda'
        return
    with pytest.raises(RuntimeError, match='CUDA'):
        pk.pack(host)
    with pytest.raises(RuntimeError, match='CUDA'):
        DeviceSweepEngine(None, {})          # raises before reading state
    leg = host.legs[0]
    with pytest.raises(RuntimeError, match='CUDA'):
        pack_S_from_leg(np.ones(leg.ind_len), leg, leg)
    p = pk.pack(host, device='cpu')
    assert p.device == torch.device('cpu')
    empty = pk.PackedArray(p.legs, p.qtotal, p.get_leg_labels(), (), (), [],
                           p.dtype, 'meta')
    assert empty.device.type == 'meta'
    assert empty.conj().device.type == 'meta'
    assert empty.replace_labels(['vL'], ['x']).device.type == 'meta'
    with pytest.raises(ValueError):
        pk.PackedArray(p.legs, p.qtotal, p.get_leg_labels(), (), (), [],
                       p.dtype)
