"""Rehearse the host DMRG phase of ``chip_smoke.py`` on the CPU.

Runs the smoke's phase 9 (``dmrg.run`` on the open XX chain with every
two-site Lanczos update forced onto the packed Lanczos, the centre update
against the host Lanczos, the crossover of the two routes) at L=16 and
chi=64 with the engine on ``device='cpu'``, so every packed tensordot takes
the kernel's plain version.  A CPU run shows the control flow and the
physics checks; its times are the CPU's, and its kernel-launch checks,
which need the card, are logged as failed instead of raised; the profiled
sweep and the kernel's timing need the card and are left out::

    python tests/rehearse_host_dmrg_phase.py 16 64
"""
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tenpy_tpu_torch.algorithms import dmrg  # noqa: E402


class _NoProfile:
    def __init__(self, *a, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def events(self):
        return []


def main(L, chi):
    torch.set_num_threads(4)
    for name in ('synchronize', 'reset_peak_memory_stats'):
        setattr(torch.cuda, name, lambda *a: None)
    torch.cuda.max_memory_allocated = lambda *a: 0
    cs.XX_MODEL = dict(cs.XX_MODEL, L=L)
    cs.XX_OPTIONS = dict(cs.XX_OPTIONS, trunc_params=dict(
        cs.XX_OPTIONS['trunc_params'], chi_max=chi), chi_list={
        k: max(2, v * chi // 512) for k, v in cs.XX_OPTIONS[
            'chi_list'].items()})
    cs.XX_CROSS_BONDS = (2, 4, None)
    run = dmrg.run
    dmrg.run = lambda psi, m, o, **kw: run(psi, m, o, **dict(kw,
                                                              device='cpu'))
    cs.profile = _NoProfile
    cs.measure_contractions = lambda calls, steps, tag: {
        'max_abs': 0.}
    failed = []

    def check(ok, msg):
        if not ok:
            failed.append(msg)
            print('check failed:', msg, flush=True)

    cs.check = check
    t0 = time.time()
    cs.phase_host_dmrg('CPU rehearsal')
    print(f"rehearsal {time.time() - t0:.1f} s; failed checks: {failed}",
          flush=True)


if __name__ == '__main__':
    main(*(int(x) for x in sys.argv[1:3])) if len(sys.argv) > 2 \
        else main(16, 64)
