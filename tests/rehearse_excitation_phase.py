"""Rehearse the plane-wave excitation phase of ``chip_smoke.py`` on the CPU.

Runs the smoke's phase 14 with every device request sent to the CPU: the
S=1 chain's VUMPS stages (default the smoke's chi 32, 64, 128), 14a the
magnon dispersion at two momenta against the Haldane gap, 14b the TFI
dispersion through ``PlaneWaveExcitations``, JAX's charged-magnon gap and
the two sum methods, 14c the matvec by part and the card's route against
the host's by N.  It prints what the smoke prints, from which the smoke's
tolerances and the card's times are predicted.  The excitation solves on
the CPU take the host route (``--packed``: the card's route, through the
kernel wrapper's plain walker, for every solve); the checks of the card's
route and launches fail here by design and are logged, not raised::

    python tests/rehearse_excitation_phase.py [--chis 32,64,128] [--packed]
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
from tenpy_tpu_torch.algorithms import plane_wave_excitation as pwe  # noqa
from tenpy_tpu_torch.linalg import packed as pk  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--chis', default=','.join(map(str, cs.EX_CHIS)),
                    help='the VUMPS stages (the last one is 14a\'s)')
    ap.add_argument('--packed', action='store_true',
                    help='send every excitation solve to the card\'s route')
    ap.add_argument('--threads', type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    for name in ('synchronize', 'reset_peak_memory_stats'):
        setattr(torch.cuda, name, lambda *a: None)
    torch.cuda.max_memory_allocated = lambda *a: 0
    pk.checked_device = lambda d: torch.device('cpu')
    cs.profile = lambda **kw: contextlib.nullcontext()
    cs.device_time = lambda prof: (0., 0., 0., [])
    cs.measure_contractions = lambda calls, steps, tag, what: {'max_abs': 0.}
    cs.EX_CHIS = tuple(int(c) for c in args.chis.split(','))
    cs.EX_CHI = cs.EX_CHIS[-1]
    if args.packed:
        pwe.PlaneWaveExcitationEngine.route_for = lambda self, N: 'device'
    failed = []

    def check(ok, msg):
        if not ok:
            failed.append(msg)
            print(f"CHECK FAILED (logged): {msg}", flush=True)

    cs.check = check
    t0 = time.time()
    cs.phase_excitations('cpu rehearsal')
    print(f"rehearsal wall {time.time() - t0:.1f} s; {len(failed)} checks "
          f"failed: {failed}", flush=True)


if __name__ == '__main__':
    main()
