"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``tenpy_tpu_torch``'s main path, the device-resident two-site iDMRG
sweep (``DeviceSweepEngine``) on the Fermi-Hubbard U=8 Ly=4 cylinder,
U(1)xU(1), at chi=256, from the committed exchange file
``tests/benchmark_data/hubbard_cyl_chi256_exchange.npz``, and holds it to the
JAX package's energies stored in that file.  Phases (any failure exits
nonzero):

1. device: card name and power limit, CUDA present, TF32 off;
2. build: the CUDA kernel library from ``tenpy_tpu_torch/csrc``;
3. kernel against its plain PyTorch version on the card, f64 and f32;
4. packed matvec at chi=256, CUDA against the CPU, plus the kernel against
   the plain version on every bucket GEMM of that matvec, and the batched
   SVD time of one split;
5. the main path: ``DeviceSweepEngine(...).run()`` on CUDA, 3 sweeps,
   with the kernel's launch count;
then a JSON line on the kernels and, last, ``{"ok": true, "device": ...}``.

Run from the root of a checkout: ``python3 chip_smoke.py``.
"""

import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from tenpy_tpu_torch import _build
from tenpy_tpu_torch.algorithms.mps_common import _matvec_2site_packed
from tenpy_tpu_torch.algorithms.packed_dmrg import DeviceSweepEngine
from tenpy_tpu_torch.linalg import grouped_gemm as gg
from tenpy_tpu_torch.linalg import packed as pk
from tenpy_tpu_torch.linalg import packed_split as ps
from tenpy_tpu_torch.networks import exchange

ROOT = os.path.dirname(os.path.abspath(__file__))
STATE = os.path.join(ROOT, 'tests', 'benchmark_data',
                     'hubbard_cyl_chi256_exchange.npz')
# the options of the JAX reference stored in the exchange file (checked);
# the seam cap of 60 makes the wrap updates converge (tests/torch_exchange.py)
OPTIONS = {'chi_max': 256, 'svd_min': 1e-10, 'lanczos_K': 10,
           'lanczos_K_seam': 60, 'n_sweeps': 3, 'cap_factor': 1.3,
           'backend': 'svd'}
KERNEL_SHAPES = [((64, 64, 64), 240), ((128, 128, 128), 240),
                 ((256, 1024, 256), 32), ((37, 129, 65), 50), ((1, 3, 5), 7)]
FAN_INS = (1, 3, 40)
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}   # summation order only


def log(*a):
    print(*a, flush=True)


def check(ok, msg):
    """A phase check that also holds under ``python -O``."""
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, reps=20):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def rel_err(x, ref):
    return float((x - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def packed_rel_err(p, ref):
    num = sum(float(((a.cpu() - b.cpu()) ** 2).sum())
              for a, b in zip(p.data, ref.data))
    den = sum(float((b.cpu() ** 2).sum()) for b in ref.data)
    return (num / max(den, 1e-300)) ** 0.5


def phase_device():
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this script measures the "
                           "card and does not run on the CPU")
    log(f"[1] nvidia-smi: {smi}")
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    log(f"[1] torch.backends.cuda.matmul.allow_tf32 = {tf32}")
    check(tf32 is False, "TF32 matmul must be off for the f32 comparisons")
    return smi


def phase_build():
    _, seconds, nvcc_log = _build.build()
    log(f"[2] kernel library built in {seconds:.2f} s")
    for line in nvcc_log.splitlines():
        if 'registers' in line or 'spill' in line:
            log(f"[2] ptxas: {line.strip()}")
    _build.library()


def random_case(m, k, n, B, fan_in, dtype, rng):
    U = max(1, B // fan_in)
    seg = np.sort(np.concatenate([np.arange(U), rng.integers(0, U, B - U)]))
    Na, Nb = max(1, B // 2), max(1, B // 2)
    dev = torch.device('cuda')
    a = torch.from_numpy(rng.standard_normal((Na, m, k))).to(dev, dtype)
    b = torch.from_numpy(rng.standard_normal((Nb, k, n))).to(dev, dtype)
    seg_ptr = np.concatenate([[0], np.cumsum(np.bincount(seg, minlength=U))])
    idx = [torch.from_numpy(x.astype(np.int32)).to(dev) for x in
           (seg_ptr, rng.integers(0, Na, B), rng.integers(0, Nb, B))]
    return (a, b, *idx, U)


def phase_kernel():
    rng = np.random.default_rng(0)
    max_abs_f64 = 0.
    for dtype in (torch.float64, torch.float32):
        for (m, k, n), B in KERNEL_SHAPES:
            for f in FAN_INS:
                args = random_case(m, k, n, B, f, dtype, rng)
                out = gg.grouped_gemm_segsum(*args)
                ref = gg.grouped_gemm_segsum_plain(*args)
                torch.cuda.synchronize()
                err = rel_err(out, ref)
                ms = cuda_ms(lambda: gg.grouped_gemm_segsum(*args))
                plain_ms = cuda_ms(lambda: gg.grouped_gemm_segsum_plain(*args))
                ok = err <= TOL[dtype] and torch.isfinite(out).all().item()
                log(f"[3] {str(dtype)[6:]} m,k,n={m},{k},{n} B={B} "
                    f"fan-in={f}: rel_err {err:.2e} kernel {ms:.4f} ms "
                    f"plain {plain_ms:.4f} ms {'ok' if ok else 'FAIL'}")
                check(ok, f"kernel disagrees with plain: {err:.2e}")
                if dtype == torch.float64:
                    max_abs_f64 = max(max_abs_f64,
                                      float((out - ref).abs().max()))
    return max_abs_f64


def phase_matvec(state):
    eng_c = DeviceSweepEngine(state, OPTIONS, 'cuda')
    eng_h = DeviceSweepEngine(state, OPTIONS, 'cpu')
    W0 = [e.Wp[0].replace_labels(['p', 'p*'], ['p0', 'p0*'])
          for e in (eng_c, eng_h)]
    W1 = [e.Wp[1].replace_labels(['p', 'p*'], ['p1', 'p1*'])
          for e in (eng_c, eng_h)]
    th = []
    for e in (eng_c, eng_h):
        C = ps.scale_bond(e.Bp[0], e.Sp[0], ps.scale_bond_plan(e.Bp[0], 'vL'))
        th.append(pk.tensordot(C.replace_labels(['p'], ['p0']),
                               e.Bp[1].replace_labels(['p'], ['p1']),
                               axes=(['vR'], ['vL'])))
    n0 = gg.LAUNCHES
    calls = []
    orig = pk.grouped_gemm_segsum

    def recording(*args):
        calls.append(args)
        return orig(*args)

    pk.grouped_gemm_segsum = recording
    try:
        out_c = _matvec_2site_packed(eng_c.LPp[0], eng_c.RPp[1], W0[0], W1[0],
                                     th[0])
    finally:
        pk.grouped_gemm_segsum = orig
    torch.cuda.synchronize()
    grew = gg.LAUNCHES - n0
    t0 = time.time()
    out_h = _matvec_2site_packed(eng_h.LPp[0], eng_h.RPp[1], W0[1], W1[1],
                                 th[1])
    cpu_s = time.time() - t0
    err = packed_rel_err(out_c, out_h)
    log(f"[4] chi=256 matvec CUDA vs CPU: rel_err {err:.2e} "
        f"({grew} kernel launches, {len(calls)} bucket GEMMs; "
        f"CPU matvec {cpu_s:.2f} s)")
    check(grew > 0 and err <= 1e-12, "packed matvec parity failed")
    for x in out_c.data:
        check(torch.isfinite(x).all(), "non-finite matvec output")

    # the kernel against the plain version at the main path's own shapes
    max_abs, max_rel = 0., 0.
    for args in calls:
        k_out = gg.grouped_gemm_segsum(*args)
        p_out = gg.grouped_gemm_segsum_plain(*args)
        max_abs = max(max_abs, float((k_out - p_out).abs().max()))
        max_rel = max(max_rel, rel_err(k_out, p_out))
    torch.cuda.synchronize()
    shapes = sorted({(a[0].shape[1], a[0].shape[2], a[1].shape[2])
                     for a in calls})
    ms = cuda_ms(lambda: [gg.grouped_gemm_segsum(*a) for a in calls])
    plain_ms = cuda_ms(lambda: [gg.grouped_gemm_segsum_plain(*a)
                                for a in calls])
    flops = sum(2 * a[3].numel() * a[0].shape[1] * a[0].shape[2]
                * a[1].shape[2] for a in calls)
    log(f"[4] matvec bucket GEMMs ({len(shapes)} distinct m,k,n from "
        f"{shapes[0]} to {shapes[-1]}; {flops / 1e9:.3f} GFLOP): kernel vs "
        f"plain max_abs_err {max_abs:.2e} max_rel_err {max_rel:.2e}; "
        f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms per matvec")
    check(max_rel <= TOL[torch.float64], "kernel disagrees at main shapes")

    # batched SVD of the split (cuSOLVER via torch.linalg.svd)
    plan = ps.split_plan(th[0], eng_c._bond(1), eng_c.qtotal_site[0])
    tb = plan.tables(torch.device('cuda'))
    flat = torch.cat([d.reshape(-1) for d in th[0].data]
                     + [th[0].data[0].new_zeros(1)])
    Ms = [flat[gidx].reshape(g.N, g.R, g.C)
          for g, (gidx, _) in zip(plan.groups, tb['groups'])]
    svd_ms = cuda_ms(lambda: [torch.linalg.svd(M, full_matrices=False)
                              for M in Ms], reps=5)
    split_ms = cuda_ms(lambda: ps.split_truncate(
        th[0], plan, OPTIONS['chi_max'], OPTIONS['svd_min'], 'svd',
        expand=True), reps=5)
    S_dev = torch.cat([torch.linalg.svd(M, full_matrices=False)[1].reshape(-1)
                       for M in Ms]).cpu()
    S_cpu = torch.cat([torch.linalg.svdvals(M.cpu()).reshape(-1)
                       for M in Ms])
    svd_err = float((S_dev - S_cpu).abs().max() / S_cpu.max())
    log(f"[4] split: {len(Ms)} SVD groups (N,R,C) "
        f"{[(g.N, g.R, g.C) for g in plan.groups]}")
    log(f"[4] batched SVD {svd_ms:.2f} ms per update, whole split "
        f"{split_ms:.2f} ms; singular values vs CPU rel_err {svd_err:.2e}")
    check(svd_err < 1e-12, "cuSOLVER singular values disagree with LAPACK")
    return max_abs, ms, plain_ms


def phase_main(state, ref):
    torch.cuda.reset_peak_memory_stats()
    eng = DeviceSweepEngine(state, OPTIONS, 'cuda')
    per_sweep = []
    orig_sweep = eng.sweep

    def counted_sweep():
        n0 = gg.LAUNCHES
        out = orig_sweep()
        per_sweep.append((gg.LAUNCHES - n0,
                          torch.cuda.max_memory_allocated()))
        return out

    eng.sweep = counted_sweep
    gg.LAUNCHES = 0                    # count the main path's launches only
    t0 = time.time()
    eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = gg.LAUNCHES
    st = eng.sweep_stats
    for i in range(len(st['E'])):
        log(f"[5] sweep {i + 1} ({st['mode'][i]}): {st['time'][i]:.2f} s "
            f"E={st['E'][i]:.12f} max_err={st['max_err'][i]:.3e} "
            f"lanczos_iters={sum(st['lanczos_iters'][i])} "
            f"flops_exec={st['flops_exec'][i]:.4e} "
            f"launches={per_sweep[i][0]} "
            f"max_memory_allocated={per_sweep[i][1] / 2**30:.3f} GiB")
    log(f"[5] run() wall {wall:.2f} s, kernel launches {launches}")
    check(launches > 0, "the main path never launched the kernel")
    check(np.isfinite(st['E']).all() and np.isfinite(st['max_err']).all(),
          "non-finite sweep energy or truncation error")
    for i, d in enumerate(eng.Sp):
        check(torch.isfinite(d).all(), f"non-finite S on bond {i}")

    n_ref = len(ref['sweep_E'])
    for i in range(n_ref):
        d = np.asarray(st['update_E0'][i]) - ref['update_E0'][i]
        log(f"[5] sweep {i + 1} per-update E0 - JAX: "
            + ' '.join(f'{x:+.2e}' for x in d))
    e0, e0_ref = st['update_E0'][0][0], float(ref['update_E0'][0][0])
    rel0 = abs(e0 - e0_ref) / abs(e0_ref)
    log(f"[5] first update E0 {e0:.12f} vs JAX {e0_ref:.12f}: rel {rel0:.2e}")
    check(rel0 <= 1e-10, "first update disagrees with JAX")
    for i in range(n_ref):
        rel = abs(st['E'][i] - ref['sweep_E'][i]) / abs(ref['sweep_E'][i])
        log(f"[5] sweep {i + 1} E {st['E'][i]:.12f} vs JAX "
            f"{ref['sweep_E'][i]:.12f}: rel {rel:.2e}")
        check(rel <= 1e-6, f"sweep {i + 1} energy disagrees with JAX")
    return launches


def main():
    smi = phase_device()
    phase_build()
    max_abs_synth = phase_kernel()
    state = exchange.load(STATE)
    ref = state.reference
    if json.loads(str(ref['options'])) != OPTIONS:
        raise RuntimeError("exchange file reference options differ")
    max_abs, ms, plain_ms = phase_matvec(state)
    launches = phase_main(state, ref)
    log(f"[6] kernel max_abs_err: synthetic f64 {max_abs_synth:.2e}, "
        f"main-path shapes {max_abs:.2e}")
    print(json.dumps({'kernels': [{
        'name': 'grouped_gemm_segsum', 'route': 'cuda',
        'source': 'tenpy_tpu_torch/csrc/grouped_gemm_segsum.cu',
        'replaces': 'tenpy_tpu/linalg/pallas_gemm.py:124',
        'launches': launches, 'max_abs_err': max_abs, 'ms': ms,
        'plain_ms': plain_ms}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
