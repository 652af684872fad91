"""Rehearse the time-evolution phase of ``chip_smoke.py`` on the CPU.

Runs the smoke's phase 11 (the XX chain's ground state by
``minimal_DMRG.yml`` at chi 256, its dynamical correlation by
``minimal_SpectralSimulation.yml`` with two-site TDVP at chi 256 and
dt=0.05, one TDVP step by both routes, the crossover table) with every
device request sent to the CPU, at a cut length L (default 16, where chi
256 truncates nothing) and final time T (default the smoke's).  It prints
the largest deviation of C(t) from free fermions, which sets the smoke's
tolerance (``TE_C_TOL``: ten times this), and the CPU's seconds per TDVP
step and local evolutions and Krylov steps per update, from which the
card's times are predicted.  The engine on the CPU takes the host route
(``--packed``: the packed route, through the kernel wrapper's plain
walker); the checks of the card's route and launches fail here by design
and are logged, not raised::

    python tests/rehearse_time_evolution_phase.py 16 [T] [--packed]
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
from tenpy_tpu_torch.algorithms import tdvp  # noqa: E402
from tenpy_tpu_torch.linalg import packed as pk  # noqa: E402


def main(L, final_time=None, packed=False):
    torch.set_num_threads(4)
    for name in ('synchronize', 'reset_peak_memory_stats'):
        setattr(torch.cuda, name, lambda *a: None)
    torch.cuda.max_memory_allocated = lambda *a: 0
    pk.checked_device = lambda d: torch.device('cpu')
    cs.profile = lambda **kw: contextlib.nullcontext()
    cs.device_time = lambda prof: (0., 0., 0., [])
    cs.measure_contractions = lambda calls, steps, tag: {'max_abs': 0.}
    cs.TE_EXTRA_OVERRIDES = [f'model_params.L={L}']
    if final_time is not None:
        cs.TE_FINAL_TIME = final_time
    if packed:
        tdvp.TDVPEngine._use_device_evolution = lambda self, H: (
            type(H) in (mc.TwoSiteH, mc.OneSiteH)
            and H.N >= mc.DEVICE_EVOLUTION_THRESHOLD)
    failed = []

    def check(ok, msg):
        if not ok:
            failed.append(msg)
            print('check failed:', msg, flush=True)

    cs.check = check
    t0 = time.time()
    cs.phase_time_evolution('CPU rehearsal')
    print(f"rehearsal {time.time() - t0:.1f} s; failed checks: {failed}",
          flush=True)


if __name__ == '__main__':
    args = [a for a in sys.argv[1:] if not a.startswith('--')]
    main(int(args[0]) if args else 16,
         float(args[1]) if len(args) > 1 else None,
         '--packed' in sys.argv)
