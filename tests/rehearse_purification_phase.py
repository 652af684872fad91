"""Rehearse the purification phase of ``chip_smoke.py`` on the CPU.

Runs the smoke's phase 13 with every device request sent to the CPU: 13a
the XX chain's purification (``L``, default the smoke's 32) in the smoke's
imaginary-time stages (``--stages 2,2,1``: others), held to the
Trotterized free-fermion energy; 13b the canonical ensemble with
conserved ancilla charges against exact diagonalization in the Sz=0
sector; 13c the time split, the steps and the crossover table.  It prints
what the smoke prints (chi and the truncation by stage, E(beta) against
free fermions, the card's update against the host's), from which the
smoke's beta, tolerances and times are predicted.  The engines on the CPU
take the host route (``--packed``: the card's route by the engine's
threshold rule, its packed tensordot through the kernel wrapper's plain
walker); the checks of launches fail here by design and are logged, not
raised::

    python tests/rehearse_purification_phase.py [L] [--packed] \\
        [--stages 2,2,2,1]
"""
import contextlib
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tenpy_tpu_torch.algorithms import mps_common as mc  # noqa: E402
from tenpy_tpu_torch.algorithms import purification  # noqa: E402
from tenpy_tpu_torch.linalg import packed as pk  # noqa: E402


def main(L=None, packed=False, stages=None):
    torch.set_num_threads(4)
    for name in ('synchronize', 'reset_peak_memory_stats'):
        setattr(torch.cuda, name, lambda *a: None)
    torch.cuda.max_memory_allocated = lambda *a: 0
    pk.checked_device = lambda d: torch.device('cpu')
    cs.profile = lambda **kw: contextlib.nullcontext()
    cs.device_time = lambda prof: (0., 0., 0., [])
    cs.measure_contractions = lambda calls, steps, tag, what: {'max_abs': 0.}

    def host_ms(fn, reps=5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps

    cs.cuda_ms = host_ms
    if L is not None:
        cs.PU_MODEL['L'] = L
        cs.PU_CROSS_BONDS = tuple(b for b in cs.PU_CROSS_BONDS if b < L)
    if stages is not None:
        cs.PU_STAGES = stages
    if packed:
        orig = purification.PurificationTEBD.route

        def route(eng, N):
            if eng.options.get('device_threshold', 'auto') == 'auto':
                eng.options['device_threshold'] = mc.DEVICE_SPLIT_THRESHOLD
            return orig(eng, N)

        purification.PurificationTEBD.route = route
    failed = []

    def check(ok, msg):
        if not ok:
            failed.append(msg)
            print('check failed:', msg, flush=True)

    cs.check = check
    t0 = time.time()
    cs.phase_purification('CPU rehearsal')
    print(f"rehearsal {time.time() - t0:.1f} s; failed checks: {failed}",
          flush=True)


if __name__ == '__main__':
    args = sys.argv[1:]
    stages = None
    if '--stages' in args:
        k = args.index('--stages')
        stages = tuple(float(x) for x in args[k + 1].split(','))
        del args[k:k + 2]
    pos = [a for a in args if not a.startswith('--')]
    main(int(pos[0]) if pos else None, '--packed' in args, stages)
