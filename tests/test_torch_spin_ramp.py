"""The port of ``tests/test_packed_dmrg.py:329`` (``test_device_ramp_staged``).

``device_ramp`` on ``device='cpu'`` grows the S=1 Heisenberg chain (L=8,
finite) from ``tenpy_tpu``'s chi=4 host-DMRG state to chi=32 in stages and
reaches ``tenpy_tpu``'s host-DMRG energy at chi=32 within the original
test's 1e-6 relative (the staged layout rebuilds replace the mixer, so the
tail converges slightly slower than mixer DMRG at equal sweep counts).
The seed state and the host energy come from
``tests/benchmark_data/tebd_reference.npz``
(``python tests/torch_exchange.py --write-tebd``).
"""
import json

import numpy as np
import torch

from tenpy_tpu_torch.algorithms.packed_dmrg import device_ramp
from tenpy_tpu_torch.models.spins import SpinChain
from tenpy_tpu_torch.networks import exchange

import torch_exchange as tx
from test_torch_tebd import REF

torch.set_num_threads(1)


def test_device_ramp_staged():
    ref = exchange.load_flat(REF)
    params, options = json.loads(str(ref['options']))['ramp_spin']
    assert params == tx.RAMP_SPIN_PARAMS and options == tx.RAMP_SPIN_OPTIONS
    m = SpinChain(dict(params))
    psi = tx.load_state(ref, 'ramp_spin.psi0', m.lat.mps_sites())
    assert max(psi.chi) <= 4
    eng = device_ramp(psi, m, dict(options), device='cpu')
    psi.test_sanity()
    assert max(psi.chi) > 8           # grew past the seed layout
    E_dev = eng.sweep_stats['E'][-1]
    E_ref = float(ref['ramp_spin.E_host'])
    assert abs(E_dev - E_ref) < 1e-6 * max(1., abs(E_ref)), (E_dev, E_ref)
    assert [s['chi'] for s in eng.stages] == [8, 16, 32]
    assert np.isfinite(eng.sweep_stats['max_err']).all()
