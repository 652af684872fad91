"""Rehearse the TEBD phase of ``chip_smoke.py`` on the CPU.

Runs the smoke's phase 8 functions (the XXZ ground state by
``device_ramp``, the staged quench to ``chi``, the timed steps and JAX's
committed real-time case) with the engines on ``device='cpu'``, so every
packed tensordot takes the kernel's plain version, and with bucket
multiple 16.  A CPU run shows the control flow, the growth in stages and
the physics checks; its times are the CPU's, and its kernel-launch
checks, which need the card, are logged as failed instead of raised::

    python tests/rehearse_tebd_phase.py 512
"""
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tenpy_tpu_torch.algorithms import packed_dmrg, packed_tebd  # noqa: E402


def main(chi):
    torch.set_num_threads(4)
    cs.TEBD_CHI = chi
    for name in ('synchronize', 'reset_peak_memory_stats'):
        setattr(torch.cuda, name, lambda *a: None)
    torch.cuda.max_memory_allocated = lambda *a: 0
    cs.DeviceTEBDEngine = lambda psi, m, o, d: packed_tebd.DeviceTEBDEngine(
        psi, m, dict(o, multiple=16), 'cpu')
    cs.device_ramp = lambda psi, m, o, device: packed_dmrg.device_ramp(
        psi, m, dict(o, multiple=16), device='cpu')
    failed = []

    def check(ok, msg):
        if not ok:
            failed.append(msg)
            print('check failed:', msg, flush=True)

    cs.check = check
    t0 = time.time()
    psi = cs.phase_tebd_ground_state()
    cs.phase_tebd_quench(psi, 'CPU rehearsal')
    cs.phase_tebd_jax_case()
    print(f"rehearsal {time.time() - t0:.1f} s; failed checks: {failed}",
          flush=True)


if __name__ == '__main__':
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 512)
