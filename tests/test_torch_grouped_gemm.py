"""The port's grouped GEMM (plain version on the CPU) against the JAX kernel.

The plain PyTorch version is what the wrapper runs for CPU tensors; it is
held to ``pallas_gemm.reference_segsum`` in f64 (1e-12 relative: summation
order only) and to the Pallas kernel in interpret mode in f32 (1e-5
relative: f32 summation order).  The CUDA kernel itself runs only on the
card (``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from tenpy_tpu.linalg import pallas_gemm as pg
from tenpy_tpu_torch.linalg import grouped_gemm as gg

torch.set_num_threads(1)

# (Na, Nb, m, k, n, U, fan_in): tests/test_pallas_gemm.py's shapes, a ragged
# one and a high fan-in one
CASES = [(3, 4, 8, 8, 8, 2, 3), (6, 5, 16, 32, 24, 4, 3),
         (2, 2, 64, 8, 128, 1, 3), (3, 2, 1, 3, 5, 2, 3),
         (5, 6, 8, 16, 8, 2, 40)]


def _case(Na, Nb, m, k, n, U, fan_in, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((Na, m, k))
    b = rng.standard_normal((Nb, k, n))
    B = fan_in * U
    seg = np.sort(np.concatenate([np.arange(U),
                                  rng.integers(0, U, B - U)])).astype(np.int32)
    ia = rng.integers(0, Na, B).astype(np.int32)
    ib = rng.integers(0, Nb, B).astype(np.int32)
    seg_ptr = np.concatenate([[0], np.cumsum(np.bincount(seg, minlength=U))])
    return a, b, seg, ia, ib, seg_ptr.astype(np.int32)


def _port(a, b, seg_ptr, ia, ib, U, dtype):
    return gg.grouped_gemm_segsum(
        torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype),
        torch.from_numpy(seg_ptr), torch.from_numpy(ia),
        torch.from_numpy(ib), U).numpy()


@pytest.mark.parametrize('case', CASES)
def test_plain_vs_reference_f64(case):
    a, b, seg, ia, ib, seg_ptr = _case(*case, seed=1)
    U = case[5]
    n0 = gg.LAUNCHES
    out = _port(a, b, seg_ptr, ia, ib, U, torch.float64)
    assert gg.LAUNCHES == n0          # CPU tensors take the plain version
    ref = pg.reference_segsum(a, b, seg, ia, ib, U)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize('case', CASES)
def test_plain_vs_pallas_interpret_f32(case):
    a, b, seg, ia, ib, seg_ptr = _case(*case, seed=2)
    U = case[5]
    out = _port(a, b, seg_ptr, ia, ib, U, torch.float32)
    ref = np.asarray(pg.grouped_gemm_segsum(
        a.astype(np.float32), b.astype(np.float32), seg, ia, ib, U,
        interpret=True), np.float64)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_wrapper_rejects_bad_inputs():
    a, b, seg, ia, ib, seg_ptr = _case(3, 4, 8, 8, 8, 2, 3, seed=3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tp, tia, tib = (torch.from_numpy(x) for x in (seg_ptr, ia, ib))
    with pytest.raises(TypeError):
        gg.grouped_gemm_segsum(ta, tb, tp, tia.long(), tib, 2)
    with pytest.raises(TypeError):
        gg.grouped_gemm_segsum(ta, tb.float(), tp, tia, tib, 2)
    with pytest.raises(ValueError):
        gg.grouped_gemm_segsum(ta.transpose(1, 2), tb, tp, tia, tib, 2)
    with pytest.raises(ValueError):
        nc = torch.from_numpy(np.repeat(ia, 2))[::2]
        gg.grouped_gemm_segsum(ta, tb, tp, nc, tib, 2)
    with pytest.raises(ValueError):
        gg.grouped_gemm_segsum(ta, tb, tp, tia, tib, 3)
