"""The C++ executor of the host tensordot's GEMM tasks against its plain
version, the per-task ``torch.matmul`` loop.

On 240 random block structures with at least one GEMM task (two or
three U(1) charges, 2-8 sectors of 1-4 entries, 2-4 legs, 1-2 contracted
legs, transposed and conjugated operands), in float64 and complex128, the
executor's output blocks are
held to the loop's on the same plan and blocks at 1e-13 of the largest
entry: both run the same BLAS and add in the same order, and differ only
where torch takes a matrix-vector kernel for a thin product.  Also: which
plans take which path, the build (named by the source's hash, raising
with the compiler's output when it fails) and that a failing executor
raises from ``tensordot`` rather than falling back.
"""
import numpy as np
import pytest
import torch

from tenpy_tpu_torch import native
from tenpy_tpu_torch.linalg import np_conserved as npc
from tenpy_tpu_torch.linalg.charges import ChargeInfo, LegCharge

torch.set_num_threads(1)

TOL = 1e-13
N_CASES = 240


def _leg(rng, chinfo, qconj):
    n = int(rng.integers(2, 9))
    q = rng.integers(0, 2, size=(n, chinfo.qnumber))
    slices = np.concatenate([[0], np.cumsum(rng.integers(1, 5, size=n))])
    return LegCharge(chinfo, slices, q, qconj)


def _array(rng, legs, dtype):
    """Random blocks, of the total charge of a random sector row."""
    qtotal = sum(l.charges[int(rng.integers(l.block_number))] * l.qconj
                 for l in legs)

    def draw(shape):
        x = rng.standard_normal(shape)
        if dtype == torch.complex128:
            x = x + 1j * rng.standard_normal(shape)
        return x
    return npc.Array.from_func(draw, legs, dtype=dtype, qtotal=qtotal)


def _case(seed):
    """Two random arrays and their contraction ``axes``."""
    rng = np.random.default_rng(seed)
    chinfo = ChargeInfo([1] * int(rng.integers(2, 4)))
    dtype = (torch.float64, torch.complex128)[seed % 2]
    n_c = int(rng.integers(1, 3))
    n_a, n_b = int(rng.integers(n_c, 4)), int(rng.integers(n_c, 4))
    contracted = [_leg(rng, chinfo, int(rng.choice([-1, 1])))
                  for _ in range(n_c)]
    legs_a = [_leg(rng, chinfo, 1) for _ in range(n_a - n_c)] + contracted
    legs_b = [l.conj() for l in contracted] + \
        [_leg(rng, chinfo, -1) for _ in range(n_b - n_c)]
    a, b = _array(rng, legs_a, dtype), _array(rng, legs_b, dtype)
    # contracted legs in a shuffled order on both sides, transposed blocks
    perm = list(rng.permutation(n_c))
    axes = ([n_a - n_c + p for p in perm], perm)
    if rng.integers(2):
        a = a.conj().iconj()     # conjugate views of the blocks (complex)
    return a, b, axes


def _both_paths(a, b, axes):
    """The loop's and the executor's output blocks of one tensordot."""
    axes_a, axes_b = axes
    at = a.transpose([i for i in range(a.rank) if i not in axes_a]
                     + list(axes_a))
    bt = b.transpose(list(axes_b) + [i for i in range(b.rank)
                                     if i not in axes_b])
    plan = npc._tensordot_plan(at, bt, len(axes_a))
    dtype = torch.promote_types(a.dtype, b.dtype)
    return plan, npc._run_loop(plan, at._data, bt._data, dtype), \
        npc._run_native(plan, at._data, bt._data, dtype)


def test_executor_matches_loop_on_random_structures():
    n_tasks, n_large = [], 0
    for seed in range(20 * N_CASES):
        if len(n_tasks) == N_CASES:
            break
        a, b, axes = _case(seed)
        if a.stored_blocks == 0 or b.stored_blocks == 0:
            continue
        plan, loop, nat = _both_paths(a, b, axes)
        if not plan.tasks:
            continue
        n_tasks.append(len(plan.tasks))
        n_large += len(plan.tasks) > npc.NATIVE_MIN_TASKS
        scale = max(float(x.abs().max()) for x in loop if x.numel()) \
            if any(x.numel() for x in loop) else 1.
        for x, y, s in zip(loop, nat, plan.out_shapes):
            assert tuple(y.shape) == tuple(s) == tuple(x.shape)
            assert y.dtype == x.dtype
            assert float((x - y).abs().max()) <= TOL * scale \
                if x.numel() else True
        # and through tensordot itself, against the dense product
        res = npc.tensordot(a, b, axes)
        res = res.to_ndarray() if isinstance(res, npc.Array) else res
        ref = torch.tensordot(a.to_ndarray(), b.to_ndarray(), dims=axes)
        assert float((res - ref).abs().max()) <= 1e-12 * max(
            float(ref.abs().max()), 1e-300)
    assert len(n_tasks) == N_CASES
    # those that tensordot gives to the executor
    assert n_large >= 30, (n_large, max(n_tasks))


def test_dispatch_by_task_count_and_dtype(monkeypatch):
    runs = []
    real = native.run_tasks
    monkeypatch.setattr(native, 'run_tasks',
                        lambda *a: runs.append(len(a[1])) or real(*a))
    for seed in range(40):
        a, b, axes = _case(seed)
        if a.stored_blocks == 0 or b.stored_blocks == 0:
            continue
        plan = _both_paths(a, b, axes)[0]
        before = len(runs)
        npc.tensordot(a, b, axes)
        assert len(runs) - before == (len(plan.tasks)
                                      > npc.NATIVE_MIN_TASKS)
        runs_f32 = len(runs)
        npc.tensordot(a.astype(torch.complex64 if a.dtype.is_complex
                               else torch.float32),
                      b.astype(torch.complex64 if b.dtype.is_complex
                               else torch.float32), axes)
        assert len(runs) == runs_f32       # other types: the loop
    assert runs


def test_build_is_keyed_and_failures_raise(tmp_path, monkeypatch):
    a, b, axes = next(c for c in map(_case, range(100))
                      if c[0].stored_blocks and c[1].stored_blocks
                      and len(_both_paths(*c)[0].tasks)
                      > npc.NATIVE_MIN_TASKS)
    so = native.build()
    assert so.exists() and so.name.startswith('host_gemm_')
    assert native.build() == so               # built once, then found
    lib, gemm = native.library()
    assert set(gemm) == {torch.float64, torch.complex128}
    bad = tmp_path / 'host_gemm.cpp'
    bad.write_text(native.SOURCE.read_text() + '\nthis is not C++;\n')
    monkeypatch.setattr(native, 'SOURCE', bad)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='g.. failed') as e:
        native.build()
    assert 'error' in str(e.value)
    assert not list((tmp_path / 'build').glob('*.so'))

    def broken():
        raise RuntimeError("the host GEMM executor does not build")
    monkeypatch.setattr(native, 'library', broken)
    with pytest.raises(RuntimeError, match='does not build'):
        npc.tensordot(a, b, axes)


def test_run_tasks_checks_its_arrays():
    out = torch.zeros(4, dtype=torch.float64)
    x = torch.ones(4, dtype=torch.float64)
    p = np.array([x.data_ptr()], np.int64)
    native.run_tasks(torch.float64, p, p, np.array([out.data_ptr()]),
                     np.array([[2, 2, 2]], np.int32), np.array([1], np.uint8))
    assert torch.equal(out, torch.full((4,), 2., dtype=torch.float64))
    with pytest.raises(ValueError):
        native.run_tasks(torch.float64, p, p, np.array([out.data_ptr()]),
                         np.array([[2, -1, 2]], np.int32),
                         np.array([0], np.uint8))
    with pytest.raises(ValueError):
        native.run_tasks(torch.float64, p, p, p, np.zeros((2, 3), np.int32),
                         np.array([1], np.uint8))
