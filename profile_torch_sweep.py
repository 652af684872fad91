"""Profile one steady iDMRG sweep of the PyTorch/CUDA port on one GPU.

Runs ``tenpy_tpu_torch``'s ``DeviceSweepEngine`` on the chi=256 Hubbard
cylinder of ``chip_smoke.py`` (its model, options and the state of its
exchange file, imported from it), set up by the port itself: sweep 1 with
the subspace expansion and sweep 2 without it build the host plans, sweep
3 (expansion off) is the steady sweep, timed, and sweep 4 (the same work)
runs under ``torch.profiler``.  With ``--hofstadter`` the engine is instead
the complex128 one of ``chip_smoke.py`` phase 7 (the Hofstadter cylinder
ramped to chi=128 by ``device_ramp``), and its next sweeps (expansion off)
play the same parts.  Prints the card's name and power limit, the sweep
times, device time by kernel, the profiled sweep's busy and idle share of
its own wall time, the host's launch and copy calls, and the profiler's
table of the 40 costliest operations.

Run from the root of a checkout on a machine with a CUDA card:
``python3 profile_torch_sweep.py [--hofstadter]``.
"""

import argparse
import json
import subprocess
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import HOF_INIT, HOF_MODEL, HOF_OPTIONS, MODEL, OPTIONS, \
    STATE
from tenpy_tpu_torch.algorithms.packed_dmrg import DeviceSweepEngine, \
    device_ramp
from tenpy_tpu_torch.linalg import grouped_gemm as gg
from tenpy_tpu_torch.models.hofstadter import HofstadterFermions
from tenpy_tpu_torch.models.hubbard import FermiHubbardModel
from tenpy_tpu_torch.networks import exchange
from tenpy_tpu_torch.networks.mps import MPS


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


def hubbard_engine():
    """The chi=256 Hubbard engine after its two plan-building sweeps (one
    with the expansion, one without), and their seconds."""
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
    return eng, [t1, t2]


def hofstadter_engine():
    """The complex128 Hofstadter engine ramped to chi=128 (its plans are
    built by the ramp's last stage), and the ramp's seconds."""
    model = HofstadterFermions(dict(HOF_MODEL))
    psi = MPS.from_product_state(model.lat.mps_sites(), HOF_INIT,
                                 bc='infinite')
    t0 = time.time()
    eng = device_ramp(psi, model, dict(HOF_OPTIONS), 'cuda')
    torch.cuda.synchronize()
    eng._cur_expand = False
    return eng, [time.time() - t0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--hofstadter', action='store_true',
                    help='profile the complex128 Hofstadter engine at '
                         'chi=128 instead of the chi=256 Hubbard one')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script profiles the card")
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    eng, warm = hofstadter_engine() if args.hofstadter else hubbard_engine()
    t3, n3 = timed_sweep(eng)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t4, launches = timed_sweep(eng)
    print(f"warm-up {' '.join(f'{t:.3f}' for t in warm)} s "
          f"({'the ramp' if args.hofstadter else 'expand and settle sweeps'}"
          f", building the plans); steady sweep {t3:.3f} s (unprofiled), "
          f"{t4:.3f} s (profiled); packed_contract launches: {n3} in the "
          f"steady sweep, {launches} in the profiled one", flush=True)

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
