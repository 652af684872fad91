"""Fermionic Haldane model on an infinite honeycomb cylinder (iDMRG), on the
PyTorch port.

The same demo as ``haldane.py`` beside it, through ``tenpy_tpu_torch``: the
half-filled Haldane model is a Chern insulator; iDMRG converges its ground
state on a cylinder, and the entanglement spectrum is printed resolved by
particle number.  The complex next-nearest-neighbour hopping makes the MPO
and the state complex128.  ``device`` is where the engine's packed Lanczos
may run: 'cpu' runs everything on the host, 'cuda' sends the two-site
eigensolves of effective Hamiltonians from the port's threshold up to the
card::

    python examples/chern_insulators/haldane_torch.py [cpu|cuda]
"""
import sys

import numpy as np

from tenpy_tpu_torch.algorithms import dmrg
from tenpy_tpu_torch.models.haldane import FermionicHaldaneModel
from tenpy_tpu_torch.networks.mps import MPS


def run(Ly=3, chi=32, device='cpu'):
    m = FermionicHaldaneModel({'Lx': 1, 'Ly': Ly, 'bc_MPS': 'infinite',
                               'bc_y': 'cylinder', 'conserve': 'N',
                               't1': -1., 'V': 0., 'mu': 0.})
    L = m.lat.N_sites
    fill = (['full', 'empty'] * L)[:L]          # half filling
    psi = MPS.from_product_state(m.lat.mps_sites(), fill, bc='infinite')
    eng = dmrg.TwoSiteDMRGEngine(psi, m, {
        'trunc_params': {'chi_max': chi, 'svd_min': 1e-10},
        'mixer': True, 'max_E_err': 1e-9, 'max_sweeps': 24}, device=device)
    E, _ = eng.run()
    print(f"Haldane cylinder Ly={Ly}: E/site = {E:.8f} chi={max(psi.chi)}")
    spec = psi.entanglement_spectrum(by_charge=True)[0]
    print("entanglement spectrum (charge, lowest levels):")
    for q, lev in spec:
        print(f"  N={q}: {np.sort(lev)[:4]}")
    n = np.mean(np.real(psi.expectation_value('N')))
    print(f"filling <N> = {n:.6f}")
    assert abs(n - 0.5) < 1e-6
    return E


if __name__ == '__main__':
    run(device=sys.argv[1] if len(sys.argv) > 1 else 'cpu')
