"""Rehearse the simulation phase of ``chip_smoke.py`` on the CPU.

Runs the smoke's phase 10 (the repo's ``minimal_DMRG.yml`` and
``sequential_chi_ramp.yml`` through ``console_main``, the stage files and
the resume) with every device request sent to the CPU, at a cut size: the
minimal file at L (default 16) and chi_max 32, the sequential ramp on the
XX chain at L with chi_max [chi/4, chi/2, chi] (default 64).  A CPU run
shows the control flow, the output files and the physics checks (energy
against free fermions, ``norm_test``, total Sz, ``max_chi`` per stage);
its times are the CPU's, and its checks of the card's route and kernel
launches, which need the card, are logged as failed instead of raised;
the kernel's timing needs the card and is left out::

    python tests/rehearse_simulation_phase.py 16 64
"""
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tenpy_tpu_torch.linalg import packed as pk  # noqa: E402


def main(L, chi):
    torch.set_num_threads(4)
    for name in ('synchronize', 'reset_peak_memory_stats'):
        setattr(torch.cuda, name, lambda *a: None)
    torch.cuda.max_memory_allocated = lambda *a: 0
    pk.checked_device = lambda d: torch.device('cpu')
    chis = [chi // 4, chi // 2, chi]
    cs.SIM_SEQ_CHIS = tuple(chis)
    cs.SIM_SEQ_OVERRIDES = [
        o.replace('L=64', f'L={L}').replace('[128, 256, 512]', str(chis))
        for o in cs.SIM_SEQ_OVERRIDES]
    cs.SIM_SEQ_PARAMS = cs.sim_params(cs.SIM_SEQ_PARAMS, [
        f'model_params.L={L}', f'algorithm_params.trunc_params.chi_max='
        f'{chis}'])
    run = cs.run_sim_file

    def run_small(has_yaml, path, params, overrides):
        if path == cs.SIM_MINIMAL_YML:
            overrides = overrides + [
                f'model_params.L={L}',
                'algorithm_params.trunc_params.chi_max=32']
        return run(has_yaml, path, params, overrides)

    cs.run_sim_file = run_small
    cs.measure_contractions = lambda calls, steps, tag: {'max_abs': 0.}
    failed = []

    def check(ok, msg):
        if not ok:
            failed.append(msg)
            print('check failed:', msg, flush=True)

    cs.check = check
    t0 = time.time()
    cs.phase_simulation('CPU rehearsal')
    print(f"rehearsal {time.time() - t0:.1f} s; failed checks: {failed}",
          flush=True)


if __name__ == '__main__':
    main(*(int(x) for x in sys.argv[1:3])) if len(sys.argv) > 2 \
        else main(16, 64)
