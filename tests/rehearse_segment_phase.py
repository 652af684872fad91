"""Rehearse the segment phase of ``chip_smoke.py`` on the CPU.

Runs the smoke's phase 15 with every device request sent to the CPU: the
S=1 chain's VUMPS stages of phase 14 (default chi 16, 32; the last one is
15a's state), 15a the two excitations of its segment in the Delta Sz = +1
sector, the card's projected eigensolve against the host's at the centre,
15b the TFI kink by ``TopologicalExcitations``.  It prints what the smoke
prints, from which the smoke's tolerances and the card's times are
predicted.  With ``--packed`` every update from ``DEVICE_LANCZOS_THRESHOLD``
up takes the card's route (the packed Lanczos through the kernel
wrapper's plain walker), as on the card; the kernel timing and the launch
checks fail here by design and are logged, not raised::

    python tests/rehearse_segment_phase.py [--chis 16,32] [--enlarge 16]
        [--chi-max 128] [--packed]
"""
import argparse
import contextlib
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tenpy_tpu_torch.algorithms import mps_common as mc  # noqa: E402
from tenpy_tpu_torch.linalg import packed as pk  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--chis', default='16,32',
                    help="phase 14's VUMPS stages (the last one is 15a's)")
    ap.add_argument('--enlarge', type=int, default=cs.SG_ENLARGE)
    ap.add_argument('--chi-max', type=int, default=128,
                    help="the segment DMRG's chi_max")
    ap.add_argument('--packed', action='store_true',
                    help="send the updates to the card's route")
    ap.add_argument('--threads', type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    for name in ('synchronize', 'reset_peak_memory_stats'):
        setattr(torch.cuda, name, lambda *a: None)
    torch.cuda.max_memory_allocated = lambda *a: 0
    pk.checked_device = lambda d: torch.device('cpu')
    cs.profile = lambda **kw: contextlib.nullcontext()
    cs.device_time = lambda prof: (0., 0., 0., [])
    cs.measure_contractions = lambda calls, steps, tag, what='matvec': {
        'max_abs': 0.}
    cs.EX_CHIS = tuple(int(c) for c in args.chis.split(','))
    cs.EX_CHI = cs.EX_CHIS[-1]
    cs.SG_ENLARGE = cs.SG_OP_SITE = args.enlarge
    for opts in (cs.SG_DMRG, cs.SG_TOPO_DMRG):
        opts['trunc_params']['chi_max'] = args.chi_max
    if args.packed:
        mc.use_device_lanczos = lambda params, device, N: \
            params.silent_get('device_K', None) != 0 and \
            N >= mc.DEVICE_LANCZOS_THRESHOLD
    failed = []

    def check(ok, msg):
        if not ok:
            failed.append(msg)
            print(f"CHECK FAILED (logged): {msg}", flush=True)

    cs.check = check
    t0 = time.time()
    model, states = cs.ex_ground_states('cpu rehearsal')
    print(f"VUMPS stages {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    cs.phase_segment('cpu rehearsal', model, states[cs.EX_CHI])
    print(f"rehearsal wall {time.time() - t0:.1f} s; {len(failed)} checks "
          f"failed: {failed}", flush=True)


if __name__ == '__main__':
    main()
