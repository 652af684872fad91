"""Phase 12a's infinite-XX ``dmrg.run`` by route and host thread count.

Runs the iDMRG reference of ``chip_smoke.py`` phase 12a (``VU_XX_MODEL``
from ``VU_XX_INIT`` with ``VU_DMRG_OPTIONS``: ``chi_list`` 32-64-128-256,
the density-matrix mixer, 20-30 sweeps) once per case and prints, per
case, every sweep's energy against -1/pi, the final energy and chi, the
norm test and the seconds, as one JSON line each.  The cases: on a card
(``--device cuda``) the two-site Lanczos on the host (``device_K=0``) and
by the engine's rule (the packed Lanczos from N=256 up), each at 8 and at
1 torch host threads; on the CPU (``--device cpu``) the host route at 8
and at 1 thread, and with ``--packed`` the card's route instead (every
two-site update on the packed Lanczos, ``device_K`` = 20, the card's
default of at most ``N_max`` = 20 steps, stopping by the host's rule,
through the kernel's plain version), at 8 threads.  A route
departs from the other where their sweep energies part on the same
input::

    python3 probe_idmrg_routes.py --device cuda
    python3 probe_idmrg_routes.py --device cpu [--packed]
"""
import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tenpy_tpu_torch.algorithms import dmrg  # noqa: E402
from tenpy_tpu_torch.models.xxz_chain import XXZChain  # noqa: E402
from tenpy_tpu_torch.networks.mps import MPS  # noqa: E402


def run_case(device, device_K, threads):
    torch.set_num_threads(threads)
    model = XXZChain(dict(cs.VU_XX_MODEL))
    psi = MPS.from_product_state(model.lat.mps_sites(), cs.VU_XX_INIT,
                                 bc='infinite')
    opts = copy.deepcopy(cs.VU_DMRG_OPTIONS)
    if device_K is not None:
        opts['lanczos_params'] = {'device_K': device_K}
    t0 = time.time()
    info = dmrg.run(psi, model, opts, device=device)
    if device == 'cuda':
        torch.cuda.synchronize()
    sec = time.time() - t0
    ss = info['sweep_statistics']
    route = 'host' if device_K == 0 or (device == 'cpu' and not device_K) \
        else 'card from N=256' if device_K is None else 'card, every update'
    return {'device': device, 'route': route, 'threads': threads,
            'seconds': sec, 'E_minus_exact': float(info['E']) - cs.VU_E_EXACT,
            'chi': list(psi.chi),
            'norm_test': float(np.max(psi.norm_test())),
            'sweeps': [int(x) for x in ss['sweep']],
            'sweep_E_minus_exact': [float(e) - cs.VU_E_EXACT
                                    for e in ss['E']],
            'sweep_chi': [int(x) for x in ss['max_chi']]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    ap.add_argument('--packed', action='store_true',
                    help="on the CPU: every update on the card's route")
    args = ap.parse_args(argv)
    if args.device == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device")
        print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
        cases = [(0, 8), (None, 8), (0, 1), (None, 1)]
    elif args.packed:
        cases = [(20, 8)]
    else:
        cases = [(None, 8), (None, 1)]
    for device_K, threads in cases:
        print(json.dumps(run_case(args.device, device_K, threads)),
              flush=True)


if __name__ == '__main__':
    main()
