"""Phase 17a of ``chip_smoke.py`` (the x-k Hubbard cylinder to chi=256 by
``dmrg.run``'s engine with the card's Lanczos) from two checkouts in turns
on one card: A, B, B, A, each in its own process with two torch host
threads (as the smoke's worker D), printing each run's per-sweep lines
(seconds by part, the environments' and the split's included) and, where
the checkout has it, the executor check.  Two checkouts of two commits
(``git archive``) compare their host paths within one call::

    python3 compare_torch_xk.py <checkout A> <checkout B>
"""
import os
import subprocess
import sys
import time

RUN = ("import os, sys, torch; root = sys.argv[1]; sys.path.insert(0, root); "
       "os.chdir(root); import chip_smoke as cs; smi = cs.phase_device(); "
       "cs.phase_build(); torch.set_num_threads(2); cs.phase_mixed_xk(smi)")
KEEP = ('[17a] sweep', 'environment update', 'three tensordots', 'profiled')


def main(a, b):
    rc = 0
    for root in (a, b, b, a):
        t0 = time.time()
        res = subprocess.run([sys.executable, '-c', RUN, os.path.abspath(root)],
                             capture_output=True, text=True,
                             env=dict(os.environ, OMP_NUM_THREADS='2',
                                      MKL_NUM_THREADS='2'))
        print(f"=== {root}: rc {res.returncode}, {time.time() - t0:.1f} s",
              flush=True)
        for line in res.stdout.splitlines():
            if line.startswith(KEEP[0]) or any(k in line for k in KEEP[1:]):
                print(line, flush=True)
        if res.returncode:
            print(res.stdout[-2000:], res.stderr[-3000:], flush=True)
            rc = res.returncode
    return rc


if __name__ == '__main__':
    sys.exit(main(*sys.argv[1:3]))
