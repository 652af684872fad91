"""Profile one steady iDMRG sweep of the PyTorch/CUDA port on one GPU.

Runs ``tenpy_tpu_torch``'s ``DeviceSweepEngine`` on the chi=256 Hubbard
cylinder of ``chip_smoke.py`` (its model, options and the state of its
exchange file, imported from it), set up by the port itself: sweep 1 with the subspace expansion and sweep 2 without it build
the host plans, sweep 3 (expansion off) is the steady sweep, timed, and
sweep 4 (the same work) runs under ``torch.profiler``.  Prints the card's
name and power limit, the sweep times, device time by kernel, the profiled
sweep's busy and idle share of its own wall time, the host's launch and
copy calls, and the profiler's table of the 40 costliest operations.

Run from the root of a checkout on a machine with a CUDA card:
``python3 profile_torch_sweep.py``.
"""

import json
import subprocess
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import MODEL, OPTIONS, STATE
from tenpy_tpu_torch.algorithms.packed_dmrg import DeviceSweepEngine
from tenpy_tpu_torch.linalg import grouped_gemm as gg
from tenpy_tpu_torch.models.hubbard import FermiHubbardModel
from tenpy_tpu_torch.networks import exchange


def timed_sweep(eng):
    """(wall seconds, kernel launches) of one sweep."""
    torch.cuda.synchronize()
    n0, t0 = gg.LAUNCHES, time.time()
    eng.sweep()
    torch.cuda.synchronize()
    return time.time() - t0, gg.LAUNCHES - n0


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0., -float('inf')
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script profiles the card")
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    flat = exchange.load_flat(STATE)
    if json.loads(str(flat['ref.options'])) != OPTIONS:
        raise RuntimeError("exchange file reference options differ")
    model = FermiHubbardModel(dict(MODEL))
    psi = exchange.load_mps(flat, model.lat.mps_sites())
    eng = DeviceSweepEngine(psi, model, OPTIONS, 'cuda')
    eng._cur_expand = True
    t1, _ = timed_sweep(eng)
    eng._cur_expand = False
    t2, _ = timed_sweep(eng)
    t3, n3 = timed_sweep(eng)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t4, launches = timed_sweep(eng)
    print(f"sweep times: {t1:.3f} s (expand, builds plans), {t2:.3f} s "
          f"(settle, builds plans), {t3:.3f} s (steady, unprofiled), "
          f"{t4:.3f} s (steady, profiled); packed_contract launches: "
          f"{n3} in sweep 3, {launches} in sweep 4", flush=True)

    dev_time, dev_count = defaultdict(float), defaultdict(int)
    host_count, host_time = defaultdict(int), defaultdict(float)
    intervals = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dt = e.time_range.end - e.time_range.start
            dev_time[e.name] += dt
            dev_count[e.name] += 1
            intervals.append((e.time_range.start, e.time_range.end))
        elif e.name.startswith('cuda'):
            host_count[e.name] += 1
            host_time[e.name] += e.time_range.end - e.time_range.start
    total = sum(dev_time.values())
    busy = busy_us(intervals)
    print(f"device time {total / 1e6:.4f} s, busy {busy / 1e6:.4f} s of the "
          f"profiled sweep's {t4:.3f} s: idle "
          f"{100 * (1 - busy / 1e6 / t4):.1f}% of it", flush=True)
    rows = sorted(dev_time.items(), key=lambda kv: -kv[1])
    for name, us in rows[:15]:
        print(f"  {us / 1e6:9.4f} s {100 * us / max(total, 1e-9):5.1f}% "
              f"{dev_count[name]:7d} x {us / dev_count[name]:9.2f} us  "
              f"{name[:90]}", flush=True)
    for name in sorted(host_count, key=lambda n: -host_count[n])[:8]:
        print(f"  host {name}: {host_count[name]} calls, "
              f"{host_time[name] / 1e6:.4f} s", flush=True)
    print(prof.key_averages().table(sort_by='self_device_time_total',
                                    row_limit=40), flush=True)
    print(json.dumps({'sweep_s': t3, 'profiled_sweep_s': t4,
                      'device_s': total / 1e6, 'busy_s': busy / 1e6,
                      'launches': launches,
                      'cudaLaunchKernel': host_count.get('cudaLaunchKernel',
                                                         0)}), flush=True)


if __name__ == '__main__':
    main()
