"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``tenpy_tpu_torch``'s main path, the device-resident two-site iDMRG
sweep (``DeviceSweepEngine``) on the Fermi-Hubbard U=8 Ly=4 cylinder,
U(1)xU(1), at chi=256, and the chi ramp (``device_ramp``) to chi=256 from a
Neel product state.  The port builds the model, its MPO and the
environments itself; the committed exchange file
``tests/benchmark_data/hubbard_cyl_chi256_exchange.npz`` supplies the
chi=256 state (B and S) and the JAX package's values to hold the port to.
Phases (any failure exits nonzero):

1. device: card name and power limit, CUDA present, TF32 off;
2. build: the CUDA kernel library from ``tenpy_tpu_torch/csrc``;
3. the kernel against its plain PyTorch version (the table walker) on the
   card: f64, f32 and f64 under the f32 matmul mode, at synthetic shapes,
   the main path's own and two multi-bucket-pair tensordots (one of them
   all-thin) written into NaN-filled outputs;
4. packed matvec at chi=256, CUDA against the CPU; for each of its four
   tensordots the kernel against the plain version, with the kernel's
   (also with its tasks shuffled), the plain version's and the library's
   (``torch.bmm`` per bucket pair) times beside the bound; the batched SVD
   time of one split;
5. the main path: ``FermiHubbardModel``, the MPS of the exchange file and
   ``DeviceSweepEngine(psi, model, OPTIONS, 'cuda')``; its host setup (W,
   charge gauge, environments) held to the file's JAX values, then
   ``run()``, 3 sweeps, with the kernel's launches per sweep held to the
   tensordots run and the energies to JAX's;
6. the ramp: ``device_ramp`` from the Neel product state to chi=256, with
   per-stage times, launches and energies per site, held to the committed
   chi=256 state's energy per site;
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
from tenpy_tpu_torch.algorithms.packed_dmrg import DeviceSweepEngine, \
    device_ramp
from tenpy_tpu_torch.linalg import grouped_gemm as gg
from tenpy_tpu_torch.linalg import packed as pk
from tenpy_tpu_torch.linalg import packed_split as ps
from tenpy_tpu_torch.models.hubbard import FermiHubbardModel
from tenpy_tpu_torch.networks import exchange
from tenpy_tpu_torch.networks.mps import MPS

ROOT = os.path.dirname(os.path.abspath(__file__))
STATE = os.path.join(ROOT, 'tests', 'benchmark_data',
                     'hubbard_cyl_chi256_exchange.npz')
# the options of the JAX reference stored in the exchange file (checked);
# the seam cap of 60 makes the wrap updates converge (tests/torch_exchange.py)
OPTIONS = {'chi_max': 256, 'svd_min': 1e-10, 'lanczos_K': 10,
           'lanczos_K_seam': 60, 'n_sweeps': 3, 'cap_factor': 1.3,
           'backend': 'svd'}
MODEL = {'lattice': 'Square', 'Lx': 2, 'Ly': 4, 'bc_y': 'cylinder',
         'bc_MPS': 'infinite', 't': 1., 'U': 8., 'mu': 0.}
# the Neel state in MPS order: x=0 up,down,up,down; x=1 down,up,down,up
NEEL = ['up', 'down', 'up', 'down', 'down', 'up', 'down', 'up']
RAMP_OPTIONS = {'chi_max': 256, 'svd_min': 1e-10, 'lanczos_K': 10,
                'lanczos_K_seam': 60, 'sweeps_per_stage': 2, 'n_sweeps': 4,
                'backend': 'svd'}
# energy per site of the committed chi=256 state: (E[n] - E[n-1]) / (2 L)
# of the JAX sweeps stored with it (checked below).  The ramp's 4 sweeps at
# chi=256 start from its chi=128 stage and land 2.3e-4 above it, while the
# chi=128 -> 256 step moves the energy per site by 9.9e-4 (PERF.md): 5e-4
# tells chi=256 physics from chi=128 physics with room for the ramp's
# unconverged remainder
E_SITE_REF = -0.5241574
E_SITE_TOL = 5e-4
# the environments: JAX's come from its Arnoldi route, the port's from its
# GMRES builder (tests/test_torch_ramp.py measures 8.6e-13 on the CPU)
ENV_TOL = 1e-10
# (m, k, n), entries, fan-ins: synthetic shapes, then the main
# path's own (the MPO contractions' k = n = 1 rows of 4096 and 64, and the
# 32 and 8 x 16 sector blocks of the virtual-leg contractions)
KERNEL_SHAPES = [((64, 64, 64), 240, (1, 3, 40)),
                 ((128, 128, 128), 240, (1, 3, 40)),
                 ((256, 1024, 256), 32, (1, 3, 40)),
                 ((37, 129, 65), 50, (1, 3, 40)), ((1, 3, 5), 7, (1, 3, 40)),
                 ((4096, 1, 1), 2528, (10,)), ((64, 1, 1), 115120, (1, 3, 10)),
                 ((32, 32, 32), 664, (1, 3, 18)), ((8, 16, 8), 240, (1, 3, 18))]
# (data dtype, compute dtype): f64, f32, and f64 under matmul_mode('f32')
MODES = [(torch.float64, torch.float64), (torch.float32, torch.float32),
         (torch.float64, torch.float32)]
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}   # summation order only
SPIN_CYCLES = 10_000_000     # about 5 ms of the card's clock
# NVIDIA H100 SXM data sheet: HBM rate and peak rates (f64 tensor cores for
# f64 sums, f32 CUDA cores for f32 sums)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}


def log(*a):
    print(*a, flush=True)


def check(ok, msg):
    """A phase check that also holds under ``python -O``."""
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, reps=20):
    """Median device milliseconds of ``fn()`` over ``reps`` runs (CUDA
    events).  A spin on the card queued ahead of the first event keeps it
    busy while the host enqueues ``fn``'s launches, so the events bracket
    device time and not the host's launch overhead (a function that
    synchronises with the host inside is timed with its host time)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
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


def outs_err(outs, refs):
    """(max abs, max relative) difference of two lists of output buckets."""
    abs_e = max(float((o - r).abs().max()) if o.numel() else 0.
                for o, r in zip(outs, refs))
    scale = max(float(r.abs().max()) if r.numel() else 0. for r in refs)
    return abs_e, abs_e / max(scale, 1e-300)


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
        if 'registers' in line or 'spill' in line or 'error' in line:
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


def multi_group_case(dtype, rng, thin_only=False):
    """A whole-tensordot call: rows of output bucket 0 sum the entries of
    two bucket pairs (k = 32 and k = 8); bucket 1 is thin with k = n = 1,
    bucket 2 thin with k = 3, n = 5, bucket 3 a ragged block (k = 21) and
    bucket 4 gets no entry.  Pair p reads a bucket p and b bucket p.  With
    ``thin_only`` only the thin pairs have entries, so every bucket is thin
    (buckets 0, 3 and 4 unreached) and the thin kernel runs."""
    dev = torch.device('cuda')
    a_shapes = [(40, 32, 32), (40, 32, 8), (60, 64, 1), (30, 12, 3),
                (20, 24, 21)]
    b_shapes = [(30, 32, 32), (30, 8, 32), (10, 1, 1), (15, 3, 5),
                (12, 21, 40)]
    out_dims = [(50, 32, 32), (40, 64, 1), (30, 12, 5), (10, 24, 40),
                (25, 16, 16)]
    pairs = [(0, 0, 400), (0, 1, 300), (1, 2, 300), (2, 3, 90), (3, 4, 45)]
    if thin_only:
        pairs = pairs[2:4]
    a_bufs = [torch.from_numpy(rng.standard_normal(s)).to(dev, dtype)
              for s in a_shapes]
    b_bufs = [torch.from_numpy(rng.standard_normal(s)).to(dev, dtype)
              for s in b_shapes]
    cols, k_min = [], [np.inf] * len(out_dims)
    for so, pi, cnt in pairs:
        k = a_shapes[pi][2]
        k_min[so] = min(k_min[so], k)
        cols.append(np.stack([
            np.full(cnt, so), rng.integers(0, out_dims[so][0], cnt),
            np.full(cnt, pi), rng.integers(0, a_shapes[pi][0], cnt),
            np.full(cnt, pi), rng.integers(0, b_shapes[pi][0], cnt),
            np.full(cnt, k)]))
    cols = torch.from_numpy(np.concatenate(cols, axis=1)).to(dev)
    classes = [gg.shape_class(m, n, km) for (_, m, n), km
               in zip(out_dims, k_min)]
    return a_bufs, b_bufs, gg.build_tables(out_dims, classes, *cols)


def phase_kernel():
    """The kernel against the plain version (the table walker) on the card;
    returns the largest absolute f64 difference."""
    rng = np.random.default_rng(0)
    max_abs_f64 = 0.
    for dtype, compute in MODES:
        mode = f"{str(dtype)[6:]}/{str(compute)[6:]}"
        for (m, k, n), B, fans in KERNEL_SHAPES:
            for f in fans:
                a, b, seg_ptr, ia, ib, U = random_case(m, k, n, B, f, dtype,
                                                       rng)
                tables = gg.segsum_tables(a, b, seg_ptr, ia, ib, U)
                args = ([a], [b], tables, compute)
                out = gg.packed_contract(*args)
                ref = gg.packed_contract_plain(*args)
                torch.cuda.synchronize()
                abs_e, err = outs_err(out, ref)
                ok = err <= TOL[compute] and torch.isfinite(out[0]).all()
                if compute == dtype:
                    # the one-pair API: the same tables, so the same bits
                    api = gg.grouped_gemm_segsum(a, b, seg_ptr, ia, ib, U)
                    ok = ok and torch.equal(api, out[0])
                ms = cuda_ms(lambda: gg.packed_contract(*args))
                plain_ms = cuda_ms(lambda: gg.packed_contract_plain(*args))
                log(f"[3] {mode} m,k,n={m},{k},{n} B={B} fan-in={f} "
                    f"tasks={tables.tasks.shape[0]} "
                    f"{'thin' if tables.thin else 'any'} kernel: rel_err "
                    f"{err:.2e} kernel "
                    f"{ms:.4f} ms plain {plain_ms:.4f} ms "
                    f"{'ok' if ok else 'FAIL'}")
                check(ok, f"kernel disagrees with plain: {err:.2e}")
                if compute == torch.float64:
                    max_abs_f64 = max(max_abs_f64, abs_e)
        # several bucket pairs per output row and unreached buckets, written
        # into NaN-filled outputs: a row the kernel missed stays NaN
        for thin_only in (False, True):
            a_bufs, b_bufs, tables = multi_group_case(dtype, rng, thin_only)
            nan = [torch.full(d, float('nan'), dtype=dtype, device='cuda')
                   for d in tables.out_dims]
            out = gg.packed_contract(a_bufs, b_bufs, tables, compute, out=nan)
            ref = gg.packed_contract_plain(a_bufs, b_bufs, tables, compute)
            torch.cuda.synchronize()
            abs_e, err = outs_err(out, ref)
            unreached = [4, 0, 3] if thin_only else [4]
            ok = (err <= TOL[compute] and tables.thin == thin_only
                  and all(torch.isfinite(o).all() for o in out)
                  and not any(out[i].any() for i in unreached))
            log(f"[3] {mode} multi-group tensordot, "
                f"{'thin' if tables.thin else 'any'} kernel "
                f"({tables.tasks.shape[0]} tasks, {tables.entries.shape[0]} "
                f"entries, classes {sorted(set(tables.classes))}, unreached "
                f"buckets {unreached}): rel_err {err:.2e} "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"multi-group kernel disagrees with plain: {err:.2e}")
            if compute == torch.float64:
                max_abs_f64 = max(max_abs_f64, abs_e)
    return max_abs_f64


def contract_cost(args, groups):
    """(bytes, flops) a packed_contract call must move and compute: every
    operand bucket read once, every output written once, the least index
    of a block product (its a block, b block and output row: three int32),
    and 2 m k n per block product.  The kernel's own schedule (its task
    table and the rest of its entry rows) is not counted."""
    a_bufs, b_bufs, tables, compute = args
    size = a_bufs[0].element_size()
    out_dims = tables.out_dims
    nbytes = (sum(x.numel() for x in (*a_bufs, *b_bufs)) * size
              + sum(r * m * n for r, m, n in out_dims) * size
              + tables.entries.shape[0] * 3 * 4)
    flops = sum(2 * rows.numel() * out_dims[so][1] * k * out_dims[so][2]
                for so, _, _, k, rows, _, _ in groups)
    return nbytes, flops


def schedule_stats(args, groups):
    """What the kernel's schedule does beyond the bound's count: the operand
    bytes its tasks read, repeats included (each task reads its slice of
    every entry's A and B blocks, from L2 or HBM), the FLOPs its tiles
    execute (zero padding included), and the FLOPs a fixed 64 x 64 x 16
    tile per output block would execute."""
    a_bufs, _, tables, _ = args
    out_dims = tables.out_dims
    t, k = tables.tasks.long().cpu(), tables.entries[:, 4].long().cpu()
    k_pre = torch.cat([k.new_zeros(1), torch.cumsum(k, 0)])
    k_sum = k_pre[t[:, 6]] - k_pre[t[:, 5]]       # sum of k over its entries
    dims = torch.tensor([d[1:] for d in out_dims])
    m, n = dims[t[:, 1], 0], dims[t[:, 1], 1]
    thin = t[:, 0] == 0
    tile = torch.tensor([(0, 0)] + [gg.class_tile(c) for c in range(1, 10)])
    # rows x columns of the output a task covers
    rows = torch.minimum(tile[t[:, 0], 0], m - t[:, 3])
    cols = torch.minimum(tile[t[:, 0], 1], n - t[:, 4])
    elems = torch.minimum(torch.full_like(m, gg.THIN_TILE), m * n - t[:, 3])
    rows = torch.where(thin, (elems + n - 1) // n, rows)
    cols = torch.where(thin, n, cols)
    reads = int(((rows + cols) * k_sum).sum()) * a_bufs[0].element_size()
    # block tiles run whole, each entry's k rounded up to the chunk of 8
    k8_pre = torch.cat([k.new_zeros(1), torch.cumsum((k + 7) // 8 * 8, 0)])
    k_pad = k8_pre[t[:, 6]] - k8_pre[t[:, 5]]
    area = tile[t[:, 0], 0] * tile[t[:, 0], 1]
    executed = 2 * int(torch.where(thin, elems * k_sum, area * k_pad).sum())
    up = lambda x, q: -(-x // q) * q
    fixed = sum(2 * rows_g.numel() * up(out_dims[so][1], 64)
                * up(out_dims[so][2], 64) * up(k, 16)
                for so, _, _, k, rows_g, _, _ in groups)
    return reads, executed, fixed


def bound_ms(nbytes, flops, compute):
    """The card's least time for the work (ms) and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[compute] * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


MATVEC_STEPS = ['LP.theta over vR/vL', '.W0 over (wR,p0)', '.W1 over (wR,p1)',
                '.RP over (wR,vR)']


def to_cpu(p):
    """A CPU copy of a PackedArray."""
    return pk.PackedArray(p.legs, p.qtotal, p.get_leg_labels(), p.shapes,
                          p.qdatas, [d.cpu() for d in p.data], p.dtype,
                          'cpu')


def phase_matvec(eng_c):
    """The chi=256 matvec on the main path's engine (read only) and on a CPU
    copy of its operands."""
    ops_c = (eng_c.LPp[0], eng_c.RPp[1], eng_c.Wp[0], eng_c.Wp[1],
             eng_c.Bp[0], eng_c.Bp[1], eng_c.Sp[0])
    ops_h = [to_cpu(x) for x in ops_c[:-1]] + [ops_c[-1].cpu()]
    W0, W1, th = [], [], []
    for LP, RP, Wa, Wb, B0, B1, S0 in (ops_c, ops_h):
        W0.append(Wa.replace_labels(['p', 'p*'], ['p0', 'p0*']))
        W1.append(Wb.replace_labels(['p', 'p*'], ['p1', 'p1*']))
        C = ps.scale_bond(B0, S0, ps.scale_bond_plan(B0, 'vL'))
        th.append(pk.tensordot(C.replace_labels(['p'], ['p0']),
                               B1.replace_labels(['p'], ['p1']),
                               axes=(['vR'], ['vL'])))
    # record the kernel wrapper's calls of one matvec (one per tensordot)
    n0 = gg.LAUNCHES
    calls = []
    orig = pk.packed_contract

    def recording(*args):
        calls.append(args)
        return orig(*args)

    pk.packed_contract = recording
    try:
        out_c = _matvec_2site_packed(ops_c[0], ops_c[1], W0[0], W1[0], th[0])
    finally:
        pk.packed_contract = orig
    torch.cuda.synchronize()
    grew = gg.LAUNCHES - n0
    t0 = time.time()
    out_h = _matvec_2site_packed(ops_h[0], ops_h[1], W0[1], W1[1], th[1])
    cpu_s = time.time() - t0
    err = packed_rel_err(out_c, out_h)
    log(f"[4] chi=256 matvec CUDA vs CPU: rel_err {err:.2e} ({grew} kernel "
        f"launches for {len(calls)} tensordots; CPU matvec {cpu_s:.2f} s)")
    check(len(calls) == 4 and grew == 4 and err <= 1e-12,
          "packed matvec parity or launch count failed")
    for x in out_c.data:
        check(torch.isfinite(x).all(), "non-finite matvec output")

    # per tensordot: the kernel against the plain version, its time, the
    # library's (one torch.bmm per bucket pair on operands gathered
    # beforehand: the same multiply-adds without gather or sum) and the bound
    tot = {'ms': 0., 'plain_ms': 0., 'library_ms': 0., 'bytes': 0,
           'flops': 0, 'executed': 0, 'fixed': 0, 'max_abs': 0.}
    per_class = {}
    for step, args in zip(MATVEC_STEPS, calls):
        a_bufs, b_bufs, tables, compute = args
        out_dims, tasks = tables.out_dims, tables.tasks
        groups = gg.table_groups(tables)
        k_out = gg.packed_contract(*args)
        p_out = gg.packed_contract_plain(*args)
        torch.cuda.synchronize()
        abs_e, rel_e = outs_err(k_out, p_out)
        check(rel_e <= TOL[compute], f"kernel disagrees at {step}: {rel_e}")
        ms = cuda_ms(lambda: gg.packed_contract(*args))
        plain_ms = cuda_ms(lambda: gg.packed_contract_plain(*args), reps=5)
        gathered = [(a_bufs[ab].reshape(-1, out_dims[so][1], k)[ia],
                     b_bufs[bb].reshape(-1, k, out_dims[so][2])[ib])
                    for so, ab, bb, k, _, ia, ib in groups]
        library_ms = cuda_ms(lambda: [torch.bmm(A, B) for A, B in gathered])
        del gathered
        # the same tasks in a random order: what the schedule's locality in
        # L2 is worth (each output tile has one writer, so the same bits)
        perm = torch.randperm(tasks.shape[0], generator=torch.Generator(
            ).manual_seed(0)).to(tasks.device)
        shuffled = tables._replace(tasks=tasks[perm].contiguous())
        sh_args = (a_bufs, b_bufs, shuffled, compute)
        check(all(torch.equal(x, y) for x, y in
                  zip(gg.packed_contract(*sh_args), k_out)),
              f"task order changed the result at {step}")
        shuffled_ms = cuda_ms(lambda: gg.packed_contract(*sh_args))
        nbytes, flops = contract_cost(args, groups)
        reads, executed, fixed = schedule_stats(args, groups)
        b_ms, b_by = bound_ms(nbytes, flops, compute)
        classes = sorted(set(tasks[:, 0].tolist()))
        cls = ('thin' if tables.thin else
               'block' if 0 not in classes else 'mixed')
        c = per_class.setdefault(cls, [0., 0, 0])
        c[0] += ms
        c[1] += nbytes
        c[2] += flops
        log(f"[4] {step}: {cls} classes {classes}, {len(groups)} bucket "
            f"pairs, {tables.entries.shape[0]} entries, {tasks.shape[0]} "
            f"tasks; "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP; the tasks "
            f"read {reads / 1e6:.1f} MB of operands and execute "
            f"{executed / 1e9:.3f} GFLOP (a fixed 64x64x16 tile: "
            f"{fixed / 1e9:.2f} GFLOP); kernel "
            f"{ms:.4f} ms ({shuffled_ms:.4f} ms with its tasks shuffled), "
            f"plain {plain_ms:.3f} ms, library {library_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of bound; "
            f"rel_err {rel_e:.2e}")
        tot['ms'] += ms
        tot['plain_ms'] += plain_ms
        tot['library_ms'] += library_ms
        tot['bytes'] += nbytes
        tot['flops'] += flops
        tot['executed'] += executed
        tot['fixed'] += fixed
        tot['max_abs'] = max(tot['max_abs'], abs_e)
    tot['bound_ms'], tot['bound_by'] = bound_ms(tot['bytes'], tot['flops'],
                                                torch.float64)
    for cls, (ms, nbytes, flops) in sorted(per_class.items()):
        log(f"[4] {cls} class: {ms:.4f} ms per matvec, "
            f"{nbytes / ms / 1e6:.1f} GB/s, {flops / ms / 1e9:.3f} TFLOP/s")
    log(f"[4] matvec total: kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.3f} ms, library {tot['library_ms']:.4f} ms, "
        f"bound {tot['bound_ms']:.4f} ms ({tot['bound_by']}; "
        f"{tot['bytes'] / 1e6:.1f} MB, {tot['flops'] / 1e9:.3f} GFLOP), "
        f"{100 * tot['bound_ms'] / tot['ms']:.1f}% of bound; kernel vs plain "
        f"max_abs_err {tot['max_abs']:.2e}")
    log(f"[4] executed/useful FLOPs per matvec: the class tiles "
        f"{tot['executed'] / tot['flops']:.2f}x, a fixed 64x64x16 tile "
        f"{tot['fixed'] / tot['flops']:.1f}x")

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
    return tot


def phase_setup(flat):
    """The main path's engine: the port's model, the MPS of the exchange
    file, ``DeviceSweepEngine(psi, model, OPTIONS, 'cuda')``; returns it
    with the host seconds of the model and of the MPS."""
    t0 = time.time()
    model = FermiHubbardModel(dict(MODEL))
    t1 = time.time()
    psi = exchange.load_mps(flat, model.lat.mps_sites())
    t2 = time.time()
    eng = DeviceSweepEngine(psi, model, OPTIONS, 'cuda')
    t3 = time.time()
    log(f"[5] host setup: model and MPO {t1 - t0:.3f} s, MPS {t2 - t1:.3f} s, "
        f"engine {t3 - t2:.3f} s ("
        + ', '.join(f'{k} {v:.3f} s' for k, v in eng.setup_seconds.items())
        + f"); bonds chi {psi.chi}, layout {eng.bond[0].block_number} "
        f"sectors, capacity {int(eng.bond[0].slices[-1])}")
    return eng


def check_setup(eng, state):
    """The engine's MPO, gauge and environments against the JAX values of
    the exchange file."""
    check(eng.gauge is not None
          and np.array_equal(eng.gauge['k'], state.gauge['k'])
          and all(np.array_equal(a, b)
                  for a, b in zip(eng.gauge['o'], state.gauge['o'])),
          "charge gauge differs from JAX's")
    w_err = 0.
    for i in range(eng.L):
        p, q = eng.Wp[i], pk.pack(state.W[i], pad=False, device='cpu')
        check(p.shapes == q.shapes and p.qtotal == q.qtotal
              and all(np.array_equal(x, y)
                      for x, y in zip(p.qdatas, q.qdatas)),
              f"W[{i}] structure differs from JAX's")
        w_err = max(w_err, packed_rel_err(p, q))
    envs = [(eng.LPp[0], eng._pack_env(state.LP0, 0, 'L'))] + [
        (eng.RPp[i], eng._pack_env(state.RP[i], (i + 1) % eng.L, 'R'))
        for i in range(eng.L)]
    env_err = 0.
    for p, q in envs:
        check(p.shapes == q.shapes, "environment layout differs")
        scale = max(float(d.abs().max()) for d in q.data)
        env_err = max(env_err, max(float((x.cpu() - y.cpu()).abs().max())
                                   for x, y in zip(p.data, q.data)) / scale)
    log(f"[5] setup vs JAX: gauge k={[int(k) for k in eng.gauge['k']]} "
        f"and o equal, W "
        f"rel_err {w_err:.2e}, LP0/RP max rel_err {env_err:.2e}")
    check(w_err <= 1e-14, "W differs from JAX's")
    check(env_err <= ENV_TOL, "environments differ from JAX's")


def counting():
    """Count the tensordots run on the card (calls of ``packed_contract``
    with work) and the kernel launches per sweep, for every engine; returns
    ``(per_sweep, restore)``."""
    per_sweep = []
    orig_sweep = DeviceSweepEngine.sweep
    orig_contract = pk.packed_contract
    n_calls = [0]

    def counted_contract(*args):
        if args[2].tasks.shape[0] and args[0][0].is_cuda:
            n_calls[0] += 1
        return orig_contract(*args)

    def counted_sweep(self):
        n0, c0 = gg.LAUNCHES, n_calls[0]
        out = orig_sweep(self)
        per_sweep.append((gg.LAUNCHES - n0, n_calls[0] - c0,
                          torch.cuda.max_memory_allocated()))
        return out

    def restore():
        DeviceSweepEngine.sweep = orig_sweep
        pk.packed_contract = orig_contract

    DeviceSweepEngine.sweep = counted_sweep
    pk.packed_contract = counted_contract
    return per_sweep, restore


def phase_main(eng, ref):
    torch.cuda.reset_peak_memory_stats()
    per_sweep, restore = counting()
    gg.LAUNCHES = 0                    # count the main path's launches only
    try:
        t0 = time.time()
        eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        restore()
    launches = gg.LAUNCHES
    st = eng.sweep_stats
    for i in range(len(st['E'])):
        log(f"[5] sweep {i + 1} ({st['mode'][i]}): {st['time'][i]:.2f} s "
            f"E={st['E'][i]:.12f} max_err={st['max_err'][i]:.3e} "
            f"lanczos_iters={sum(st['lanczos_iters'][i])} "
            f"flops_exec={st['flops_exec'][i]:.4e} "
            f"launches={per_sweep[i][0]} tensordots={per_sweep[i][1]} "
            f"max_memory_allocated={per_sweep[i][2] / 2**30:.3f} GiB")
    log(f"[5] run() wall {wall:.2f} s, kernel launches {launches}")
    check(launches > 0, "the main path never launched the kernel")
    check(all(n == c for n, c, _ in per_sweep),
          "kernel launches per sweep differ from the tensordots run")
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


def phase_ramp():
    """``device_ramp`` from the Neel product state to chi=256."""
    model = FermiHubbardModel(dict(MODEL))
    psi = MPS.from_product_state(model.lat.mps_sites(), NEEL, bc='infinite')
    n_sites = 2 * model.lat.N_sites          # sites added per iDMRG sweep
    per_sweep, restore = counting()
    gg.LAUNCHES = 0                    # count the ramp's launches only
    try:
        t0 = time.time()
        eng = device_ramp(psi, model, dict(RAMP_OPTIONS), device='cuda')
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        restore()
    launches = gg.LAUNCHES
    st = eng.sweep_stats
    check(len(per_sweep) == len(st['E']), "sweeps counted twice or missed")
    e_site = {}
    for k, stage in enumerate(eng.stages):
        sw = range(stage['first_sweep'],
                   stage['first_sweep'] + stage['n_sweeps'])
        t = [st['time'][i] for i in sw]
        its = [sum(st['lanczos_iters'][i]) for i in sw]
        lau = [per_sweep[i][0] for i in sw]
        tds = [per_sweep[i][1] for i in sw]
        E = [st['E'][i] for i in sw]
        e_site[stage['chi']] = ((E[-1] - E[-2]) / n_sites if len(E) > 1
                                else float('nan'))
        log(f"[6] stage {k + 1} chi={stage['chi']}: {len(t)} sweeps, "
            f"s/sweep " + ' '.join(f'{x:.2f}' for x in t)
            + f", lanczos_iters {its}, launches {lau} (tensordots {tds}), "
            f"setup {stage['setup_s']:.3f} s"
            + (' (from_engine)' if k else ' (engine from the product state)')
            + f", E " + ' '.join(f'{x:.10f}' for x in E)
            + f", energy per site {e_site[stage['chi']]:.10f}, max_err "
            f"{max(st['max_err'][i] for i in sw):.2e}")
        check(all(n == c for n, c in zip(lau, tds)),
              f"stage {k + 1}: kernel launches differ from the tensordots")
    kept = [int((S > 0).sum()) for S in eng.Sp]
    chis = sorted(e_site)
    e_fin, e_prev = e_site[chis[-1]], e_site[chis[-2]]
    gap = abs(e_fin - e_prev)
    log(f"[6] device_ramp wall {wall:.2f} s, {len(st['E'])} sweeps, kernel "
        f"launches {launches}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; kept Schmidt "
        f"values per bond {kept}")
    log(f"[6] energy per site at chi={chis[-1]}: {e_fin:.10f}, committed "
        f"chi=256 state {E_SITE_REF}: diff {e_fin - E_SITE_REF:+.3e} "
        f"(tolerance {E_SITE_TOL:.1e}); chi={chis[-2]} -> {chis[-1]} gap "
        f"{gap:.3e}")
    check(launches > 0, "the ramp never launched the kernel")
    check(np.isfinite(st['E']).all() and
          all(torch.isfinite(S).all() for S in eng.Sp),
          "non-finite ramp energy or Schmidt values")
    check(min(kept) >= int(0.9 * RAMP_OPTIONS['chi_max']),
          f"a bond kept fewer than 0.9 chi_max Schmidt values: {kept}")
    check(abs(e_fin - E_SITE_REF) <= E_SITE_TOL,
          "ramp energy per site far from the committed state's")
    check(E_SITE_TOL < gap, "the tolerance does not resolve chi=128 -> 256")


def main():
    t_start = time.time()
    smi = phase_device()
    phase_build()
    max_abs_synth = phase_kernel()
    flat = exchange.load_flat(STATE)
    state = exchange.ExchangeState(flat)
    ref = state.reference
    if json.loads(str(ref['options'])) != OPTIONS:
        raise RuntimeError("exchange file reference options differ")
    e_site_ref = (ref['sweep_E'][-1] - ref['sweep_E'][-2]) / 16
    check(abs(e_site_ref - E_SITE_REF) < 1e-7,
          f"committed energy per site {e_site_ref} is not {E_SITE_REF}")
    eng = phase_setup(flat)
    check_setup(eng, state)
    mv = phase_matvec(eng)
    launches = phase_main(eng, ref)
    phase_ramp()
    log(f"[7] kernel max_abs_err: synthetic f64 {max_abs_synth:.2e}, "
        f"main-path shapes {mv['max_abs']:.2e}")
    # times, bound and library time: per chi=256 matvec (4 tensordots)
    print(json.dumps({'kernels': [{
        'name': 'packed_contract', 'route': 'cuda',
        'source': 'tenpy_tpu_torch/csrc/packed_contract.cu',
        'replaces': 'tenpy_tpu/linalg/pallas_gemm.py:124',
        'launches': launches, 'max_abs_err': mv['max_abs'], 'ms': mv['ms'],
        'plain_ms': mv['plain_ms'], 'bound_ms': mv['bound_ms'],
        'bound_by': mv['bound_by'], 'library_ms': mv['library_ms']}]}),
        flush=True)
    log(f"[7] chip_smoke wall {time.time() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
