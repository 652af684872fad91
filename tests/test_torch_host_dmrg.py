"""The port's ``dmrg.run`` (two- and single-site engines, mixers, sweeps)
against ``tenpy_tpu``'s.

* The cases of ``tests/test_dmrg.py:76-184`` run through the port on the
  same models and start states: the transverse-field Ising chain against
  its free-fermion energy (``combine`` False and True), the Heisenberg
  chain against exact diagonalization, the density-matrix mixer,
  single-site DMRG from tenpy_tpu's random chi=32 state, single-site
  growth by the subspace expansion, an excited state by ``orthogonal_to``,
  and iDMRG on the Ising chain.  Each final energy is held to JAX's within
  1e-10 relative and to the exact value the JAX test uses; the per-sweep
  energies within 1e-9 and the Schmidt values within 1e-8.  JAX's values
  come from ``tests/benchmark_data/host_dmrg_reference.npz``, written by
  ``python tests/torch_exchange.py --write-host-dmrg``; no JAX engine runs
  here.
* The device route (the port of ``tests/test_packed.py:187``): on the
  state of that test's run (stored by the exporter), one two-site update
  forced onto the packed Lanczos with ``device='cpu'`` (the plain kernel),
  against the port's host Lanczos and against ``tenpy_tpu``'s
  ``_diag_device_lanczos`` on the same effective H;
  ``_use_device_lanczos`` against tenpy_tpu's rule with the port's own
  threshold; and ``dmrg.run(..., device='cuda')`` without ``device_K``
  routing its updates from the threshold up to the packed Lanczos.
* The XX chain at L=16, chi=64 against its free-fermion energy.
* ``device='cuda'`` raising without a card.
"""
import copy
import os

import numpy as np
import pytest
import scipy.integrate
import torch

from tenpy_tpu_torch.algorithms import dmrg
from tenpy_tpu_torch.algorithms import mps_common
from tenpy_tpu_torch.algorithms.dmrg import TwoSiteDMRGEngine
from tenpy_tpu_torch.linalg import np_conserved as npc
from tenpy_tpu_torch.linalg.krylov_based import LanczosGroundState
from tenpy_tpu_torch.models.xxz_chain import XXZChain
from tenpy_tpu_torch.networks import exchange
from tenpy_tpu_torch.networks.mps import MPS

import torch_exchange as tx

torch.set_num_threads(1)

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   'benchmark_data', 'host_dmrg_reference.npz')


@pytest.fixture(scope='module')
def ref():
    return exchange.load_flat(REF)


def e0_tfi_finite(L, J, g):
    """The open Ising chain's ground energy from free fermions
    (tests/test_dmrg.py:17)."""
    A = np.zeros((L, L))
    B = np.zeros((L, L))
    for i in range(L):
        A[i, i] = -2. * g
    for i in range(L - 1):
        A[i, i + 1] = A[i + 1, i] = -J
        B[i, i + 1] = -J
        B[i + 1, i] = J
    return -0.5 * np.sum(np.sqrt(np.abs(np.linalg.eigvalsh((A - B)
                                                           @ (A + B)))))


def e0_tfi_infinite(g):
    """The Ising chain's energy per site (tests/test_dmrg.py:171)."""
    return -scipy.integrate.quad(
        lambda k: np.sqrt(1. + g ** 2 - 2. * g * np.cos(k)) / np.pi, 0,
        np.pi)[0]


def e0_xx_finite(L, Jxx):
    """The open XX chain's ground energy (Sz = 0): the sum of the negative
    eigenvalues of the free-fermion hopping matrix."""
    t = np.diag(np.full(L - 1, Jxx / 2.), 1)
    w = np.linalg.eigvalsh(t + t.T)
    return float(np.sum(w[w < 0]))


def port_case(case, ref):
    model, psi, options = tx.host_dmrg_case(case, 'torch')
    if psi is None:      # single_site: tenpy_tpu's random start state
        psi = tx.load_state(ref, f'{case}.psi0', model.lat.mps_sites())
    return model, psi, options


def check_vs_jax(prefix, E, stats, psi, ref):
    E_ref = float(ref[f'{prefix}.E'])
    assert abs(E - E_ref) <= 1e-10 * abs(E_ref)
    sweep_E = np.asarray(stats['E'])
    assert sweep_E.shape == ref[f'{prefix}.sweep_E'].shape
    assert np.abs(sweep_E - ref[f'{prefix}.sweep_E']).max() <= 1e-9
    for i, S in enumerate(tx.sorted_S(psi)):
        S_ref = ref[f'{prefix}.S.{i}']
        assert S.shape == S_ref.shape
        assert np.abs(S - S_ref).max() <= 1e-8


# case: the exact energy and its tolerance, as in tests/test_dmrg.py
EXACT = {'tfi': (lambda ref: e0_tfi_finite(16, 1., 1.5), 1e-10),
         'tfi_combine': (lambda ref: e0_tfi_finite(16, 1., 1.5), 1e-10),
         'mixer': (lambda ref: float(ref['mixer.E_exact']), 1e-8),
         'single_site': (lambda ref: float(ref['single_site.E_exact']),
                         1e-6),
         'growth': (lambda ref: float(ref['growth.E_exact']), 1e-6),
         'idmrg': (lambda ref: e0_tfi_infinite(1.5), 1e-8)}


@pytest.mark.parametrize('case', list(EXACT))
def test_dmrg_run_vs_jax(case, ref):
    """``dmrg.run`` on a case of tests/test_dmrg.py: the port against
    JAX's run and against the exact energy."""
    model, psi, options = port_case(case, ref)
    info = dmrg.run(psi, model, options, device='cpu')
    exact, tol = EXACT[case]
    assert abs(info['E'] - exact(ref)) < tol
    check_vs_jax(case, info['E'], info['sweep_statistics'], psi, ref)
    assert max(np.max(psi.norm_test()), 0.) <= 1e-8
    if case == 'single_site':
        assert isinstance(info['bond_statistics'], dict)


@pytest.fixture(scope='module')
def ground(ref):
    """The Heisenberg L=8 ground state of tests/test_dmrg.py:98 by the
    port's ``TwoSiteDMRGEngine``."""
    model, psi, options = port_case('excited', ref)
    eng = TwoSiteDMRGEngine(psi, model, options, device='cpu')
    E, _ = eng.run()
    return model, psi, E, eng


def test_dmrg_vs_ed(ground, ref):
    model, psi, E, eng = ground
    assert abs(E - float(ref['excited.E_exact'])) < 1e-10
    check_vs_jax('excited.ground', E, eng.sweep_stats, psi, ref)
    assert abs(np.sum(psi.expectation_value('Sz'))) < 1e-8


def test_dmrg_excited_state(ground, ref):
    """An excited state orthogonal to the ground state
    (tests/test_dmrg.py:148)."""
    model, psi0, E0, _ = ground
    options = copy.deepcopy(tx.HOST_DMRG_CASES['excited'][4])
    psi1 = MPS.from_product_state(model.lat.mps_sites(), ['down', 'up'] * 4)
    eng1 = TwoSiteDMRGEngine(psi1, model, options, orthogonal_to=[psi0],
                             device='cpu')
    E1, _ = eng1.run()
    E_levels = ref['excited.E_levels']
    assert abs(E0 - E_levels[0]) < 1e-8
    assert abs(E1 - E_levels[1]) < 1e-6
    ov = abs(psi0.overlap(psi1))
    assert ov < 1e-5
    assert abs(ov - float(ref['excited.overlap'])) < 1e-8
    check_vs_jax('excited.first', E1, eng1.sweep_stats, psi1, ref)


def test_xx_chain_free_fermions():
    """The open XX chain (``XXZChain``, Jz = 0) at L=16 from the Neel state
    with a chi_list ramp to 64 against its free-fermion energy, with the
    options of ``chip_smoke.py`` phase 9 (``norm_tol``: the last sweep's
    bond-1 update leaves norm_test at 1.3e-10, above it, so the run ends
    canonicalized)."""
    L = 16
    model = XXZChain({'L': L, 'Jxx': 1., 'Jz': 0., 'hz': 0.,
                      'bc_MPS': 'finite'})
    psi = MPS.from_product_state(model.lat.mps_sites(), ['up', 'down'] * 8)
    info = dmrg.run(psi, model, {
        'trunc_params': {'chi_max': 64, 'svd_min': 1e-12},
        'chi_list': {0: 16, 2: 64}, 'mixer': False, 'max_E_err': 1e-11,
        'max_sweeps': 10, 'norm_tol': 1e-10}, device='cpu')
    assert abs(info['E'] - e0_xx_finite(L, 1.)) <= 1e-10
    assert np.max(psi.norm_test()) <= 1e-10
    assert abs(np.sum(psi.expectation_value('Sz'))) <= 1e-12


def _next_update(package, psi, model):
    """An engine of ``package`` on ``psi`` with the options of
    tests/test_packed.py:187 (the device route forced by ``device_K``),
    set up for the first update of a sweep: ``(engine, theta guess)``."""
    if package == 'jax':
        from tenpy_tpu.algorithms.dmrg import TwoSiteDMRGEngine as Eng
        kw = {}
    else:
        Eng, kw = TwoSiteDMRGEngine, {'device': 'cpu'}
    eng = Eng(psi, model, copy.deepcopy(tx.INTEGRATION_OPTIONS), **kw)
    for i0, move_right, upd in eng.get_sweep_schedule():
        eng.i0, eng.move_right, eng.update_LP_RP = i0, move_right, upd
        break
    eng._cache_optimize()
    theta = eng.prepare_update_local()
    assert eng._use_device_lanczos()
    return eng, theta


def test_device_route_vs_host_and_jax(ref):
    """The port of tests/test_packed.py:187: on tenpy_tpu's state after its
    run there (the infinite Hubbard chain, U(1)xU(1), chi=32), the next
    update's effective H, solved by the device route on the CPU (the
    packed Lanczos on the plain kernel, ``device_K`` = 30 with
    ``reortho``), against the port's host ``LanczosGroundState`` (to
    convergence, without ``reortho``) and
    against ``tenpy_tpu``'s ``_diag_device_lanczos`` from the same
    guess."""
    from tenpy_tpu.models.hubbard import FermiHubbardChain as JChain
    from tenpy_tpu_torch.models.hubbard import FermiHubbardChain
    model = FermiHubbardChain(dict(tx.INTEGRATION_MODEL))
    psi = tx.load_state(ref, 'integration.psi', model.lat.mps_sites())
    jmodel = JChain(dict(tx.INTEGRATION_MODEL))
    jpsi = tx.mps_to_jax(psi, jmodel.lat.mps_sites())
    eng, theta = _next_update('torch', psi, model)
    E_dev, th_dev, N_dev, _ = eng._diag_device_lanczos(theta)
    assert N_dev == 30
    E_host, th_host, _ = LanczosGroundState(
        eng.eff_H, theta, {'N_max': 30, 'P_tol': 1e-14}).run()
    assert abs(E_dev - E_host) <= 1e-10 * abs(E_host)
    ov = abs(complex(npc.inner(th_dev.conj(), th_host, axes='range')))
    assert abs(1. - ov) <= 1e-8
    assert abs(npc.norm(th_dev) - 1.) <= 1e-12

    import jax
    jax.config.update('jax_enable_x64', True)
    jeng, jtheta = _next_update('jax', jpsi, jmodel)
    assert np.abs(jtheta.to_ndarray() - theta.to_numpy()).max() <= 1e-12
    E_jax, th_jax, N_jax, _ = jeng._diag_device_lanczos(jtheta)
    assert int(N_jax) == N_dev
    assert abs(E_dev - E_jax) <= 1e-10 * abs(E_jax)
    ov = abs(np.vdot(np.asarray(th_jax.to_ndarray()), th_dev.to_numpy()))
    assert abs(1. - ov) <= 1e-8


def test_device_route_rule(monkeypatch):
    """``_use_device_lanczos`` keeps tenpy_tpu's rule where it applies:
    ``device_K = 0`` disables, > 0 forces (not with combined legs), off on
    the CPU; otherwise the port's own ``DEVICE_LANCZOS_THRESHOLD`` (256,
    the card's measured crossover) decides, during a ``chi_list`` ramp
    too.  (The engine's device is set to CUDA after construction for the
    rule alone; no update runs.)"""
    model, psi, _ = tx.host_dmrg_case('tfi', 'torch')
    opts = {'trunc_params': {'chi_max': 8}, 'mixer': False}

    def use(lp, combine=False, device=None, chi_list=None, sweeps=0):
        o = dict(copy.deepcopy(opts), combine=combine,
                 lanczos_params=dict(lp))
        if chi_list is not None:
            o['chi_list'] = chi_list
        eng = TwoSiteDMRGEngine(psi.copy(), model, o, device='cpu')
        if device is not None:
            eng.device = torch.device(device)
        eng.sweeps = sweeps
        eng.i0 = 7
        eng.prepare_update_local()
        return eng._use_device_lanczos()

    assert use({}) is False                              # the CPU
    assert use({'device_K': 0}) is False
    assert use({'device_K': 6}) is True
    assert use({'device_K': 6}, combine=True) is False
    assert use({'device_K': 0}, device='cuda') is False
    assert use({}, device='cuda') is False               # N = 4 < 256
    assert mps_common.DEVICE_LANCZOS_THRESHOLD == 256
    monkeypatch.setattr(mps_common, 'DEVICE_LANCZOS_THRESHOLD', 4)
    assert use({}, device='cuda') is True                # N = 4 at it
    # no chi_list exclusion: the ramp's updates go to the card as well
    assert use({}, device='cuda', chi_list={0: 4, 3: 8}, sweeps=3) is True
    assert use({}, device='cuda', chi_list={0: 4, 3: 8}, sweeps=4) is True
    monkeypatch.setattr(mps_common, 'DEVICE_LANCZOS_THRESHOLD', 5)
    assert use({}, device='cuda', chi_list={0: 4, 3: 8}, sweeps=3) is False


def test_device_route_default_in_run(monkeypatch):
    """``dmrg.run(..., device='cuda')`` with TeNPy's options and no
    ``device_K`` sends every two-site update with N at or above
    ``DEVICE_LANCZOS_THRESHOLD`` to the packed Lanczos, during its
    ``chi_list`` ramp too, and no other.  There is no card here: the
    engine is built as on one (``checked_device`` passes 'cuda' through),
    and the recorded device route runs its packed Lanczos on the CPU
    (the plain kernel).  The energy matches the host route's run."""
    L = 16
    model = XXZChain({'L': L, 'Jxx': 1., 'Jz': 0., 'hz': 0.,
                      'bc_MPS': 'finite'})
    options = {'trunc_params': {'chi_max': 32, 'svd_min': 1e-12},
               'chi_list': {0: 8, 2: 32}, 'mixer': False,
               'max_E_err': 1e-11, 'max_sweeps': 6}
    sites = model.lat.mps_sites()
    psi_h = MPS.from_product_state(sites, ['up', 'down'] * 8)
    E_host = dmrg.run(psi_h, model, copy.deepcopy(options),
                      device='cpu')['E']
    checked = dmrg.pk.checked_device
    monkeypatch.setattr(dmrg.pk, 'checked_device',
                        lambda d: torch.device('cuda') if d == 'cuda'
                        else checked(d))
    orig_diag, orig_dev = TwoSiteDMRGEngine.diag, \
        TwoSiteDMRGEngine._diag_device_lanczos
    sizes, on_card = [], []

    def diag(self, theta_guess):
        sizes.append((self.sweeps, self.eff_H.N))
        return orig_diag(self, theta_guess)

    def device_lanczos(self, theta_guess):
        on_card.append((self.sweeps, self.eff_H.N))
        self.device = torch.device('cpu')
        try:
            return orig_dev(self, theta_guess)
        finally:
            self.device = torch.device('cuda')

    monkeypatch.setattr(TwoSiteDMRGEngine, 'diag', diag)
    monkeypatch.setattr(TwoSiteDMRGEngine, '_diag_device_lanczos',
                        device_lanczos)
    psi = MPS.from_product_state(sites, ['up', 'down'] * 8)
    E = dmrg.run(psi, model, copy.deepcopy(options), device='cuda')['E']
    thr = mps_common.DEVICE_LANCZOS_THRESHOLD
    assert on_card == [x for x in sizes if x[1] >= thr]
    assert any(N == thr for _, N in on_card)
    assert any(sw < 2 for sw, _ in on_card)              # in the ramp
    assert abs(E - E_host) <= 1e-10 * abs(E_host)
    assert abs(E - e0_xx_finite(L, 1.)) <= 1e-10 * abs(E)


def test_dmrg_defaults_to_the_card():
    """Without ``device`` the engines and ``dmrg.run`` take the card, and
    raise where there is none (no fallback to the CPU)."""
    model, psi, options = tx.host_dmrg_case('tfi', 'torch')
    if torch.cuda.is_available():
        assert TwoSiteDMRGEngine(psi, model, options).device.type == 'cuda'
        return
    with pytest.raises(RuntimeError, match='no CUDA device'):
        TwoSiteDMRGEngine(psi, model, options)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        dmrg.run(psi, model, dict(options, active_sites=1))
