"""Rehearse the VUMPS phase of ``chip_smoke.py`` on the CPU.

Runs the smoke's phase 12 with every device request sent to the CPU: 12a
two-site VUMPS on the infinite XX chain ramped to ``chi`` (default the
smoke's 256) and the port's iDMRG at the same chi; 12b single-site VUMPS on
a Hofstadter state made here as phase 7 makes it (``device_ramp`` to
``hof_chi``, default 128, on the CPU); 12c ``minimal_DMRG.yml`` as VUMPS.
It prints what the smoke prints (energies against -1/pi, phase 7's energy
and the Heisenberg chain's, split errors, the time of each update by part:
the environment fixed point, the eigensolves, the polar decompositions and
the SVD), from which the smoke's tolerances and the card's times are
predicted.  The engines on the CPU take the host route (``--packed``: the
packed route, through the kernel wrapper's plain walker); the checks of
the card's route and launches fail here by design and are logged, not
raised::

    python tests/rehearse_vumps_phase.py [chi] [hof_chi] [--packed]
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
from tenpy_tpu_torch.algorithms import vumps  # noqa: E402
from tenpy_tpu_torch.algorithms.packed_dmrg import device_ramp  # noqa: E402
from tenpy_tpu_torch.linalg import packed as pk  # noqa: E402
from tenpy_tpu_torch.models.hofstadter import HofstadterFermions  # noqa
from tenpy_tpu_torch.networks.mps import MPS  # noqa: E402


def hofstadter_state(chi):
    """Phase 7's state at ``chi``: ``device_ramp`` from the product state,
    written back; and its energy per site as phase 7 reads it."""
    opts = dict(cs.HOF_OPTIONS, chi_max=chi)
    model = HofstadterFermions(dict(cs.HOF_MODEL))
    psi = MPS.from_product_state(model.lat.mps_sites(), cs.HOF_INIT,
                                 bc='infinite')
    t0 = time.time()
    eng = device_ramp(psi, model, opts, device='cpu')
    st = eng.sweep_stats
    stage = eng.stages[-1]
    last = stage['first_sweep'] + stage['n_sweeps'] - 1
    e7 = (st['E'][last] - st['E'][last - 1]) / (2 * eng.psi.L)
    print(f"Hofstadter state at chi={chi}: {time.time() - t0:.1f} s, energy "
          f"per site {e7!r}", flush=True)
    return eng.psi, model, e7


def main(chi=None, hof_chi=128, packed=False):
    torch.set_num_threads(4)
    for name in ('synchronize', 'reset_peak_memory_stats'):
        setattr(torch.cuda, name, lambda *a: None)
    torch.cuda.max_memory_allocated = lambda *a: 0
    pk.checked_device = lambda d: torch.device('cpu')
    cs.profile = lambda **kw: contextlib.nullcontext()
    cs.device_time = lambda prof: (0., 0., 0., [])
    cs.measure_contractions = lambda calls, steps, tag: {'max_abs': 0.}
    if chi is not None and chi != cs.VU_CHI:
        cs.VU_CHI = chi
        cs.VU_CHI_LIST = {k: min(c, chi)
                          for k, c in cs.VU_CHI_LIST.items()}
        cs.VU_OPTIONS['chi_list'] = cs.VU_CHI_LIST
        cs.VU_OPTIONS['trunc_params']['chi_max'] = chi
        cs.VU_DMRG_OPTIONS['trunc_params']['chi_max'] = chi
        cs.VU_DMRG_OPTIONS['chi_list'] = {
            k: min(c, chi) for k, c in cs.VU_DMRG_OPTIONS['chi_list'].items()}
    if packed:
        vumps.VUMPSEngine._use_device_lanczos = lambda self, eff: (
            eff.N >= mc.DEVICE_LANCZOS_THRESHOLD)
    failed = []

    def check(ok, msg):
        if not ok:
            failed.append(msg)
            print('check failed:', msg, flush=True)

    cs.check = check
    t0 = time.time()
    hof_state = hofstadter_state(hof_chi)
    t1 = time.time()
    cs.phase_vumps_real('CPU rehearsal')
    cs.phase_vumps_complex('CPU rehearsal', hof_state)
    print(f"rehearsal {time.time() - t1:.1f} s (and {t1 - t0:.1f} s for the "
          f"Hofstadter state); failed checks: {failed}", flush=True)


if __name__ == '__main__':
    args = [a for a in sys.argv[1:] if not a.startswith('--')]
    main(int(args[0]) if args else None,
         int(args[1]) if len(args) > 1 else 128, '--packed' in sys.argv)
