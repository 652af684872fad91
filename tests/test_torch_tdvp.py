"""The port's TDVP against ``tenpy_tpu``'s, exact evolution, and its route
to the card.

The cases of ``tests/test_tdvp.py:42,67`` (two-site TDVP to t=0.4 and
one-site TDVP after two two-site steps, on the Heisenberg chain L=6 from
the Neel state) run through the port on the CPU (``device='cpu'``): the
final state is held to ``tenpy_tpu``'s (dense vectors, 1e-10) and to the
exact evolution of the port's ``ExactDiag`` (``exp_H``), the energy to
JAX's (1e-10).  The local Krylov evolution: the host ``LanczosEvolution``
and the packed ``lanczos_evolve_packed`` (on CPU tensors: the kernel
wrapper's plain walker) on the two- and one-site effective H of the same
complex state are held to JAX's ``LanczosEvolution`` (1e-12), and with
``E_shift`` to JAX's result times ``exp(delta E_shift)``.  One
two-site TDVP step with the packed route forced (by patching the
engine's route rule in the test) is held to the host route.  JAX's values
come from ``tests/benchmark_data/time_evolution_reference.npz`` (``python
tests/torch_exchange.py --write-time-evolution``); no JAX runs here.
"""
import os

import numpy as np
import pytest
import torch

import torch_exchange as tx
from tenpy_tpu_torch.algorithms import mps_common as mc
from tenpy_tpu_torch.algorithms import tdvp
from tenpy_tpu_torch.algorithms.exact_diag import ExactDiag
from tenpy_tpu_torch.linalg import np_conserved as npc
from tenpy_tpu_torch.linalg import packed as pk
from tenpy_tpu_torch.linalg.krylov_based import LanczosEvolution
from tenpy_tpu_torch.networks import exchange
from tenpy_tpu_torch.networks.mpo import MPOEnvironment

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, 'tests', 'benchmark_data',
                   'time_evolution_reference.npz')
VIRT = ('vL', 'vR', 'vL*', 'vR*')


@pytest.fixture(scope='module')
def ref():
    return exchange.load_flat(REF)


def fidelity(a, b):
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


@pytest.mark.parametrize('case', ['tdvp_two', 'tdvp_one'])
def test_tdvp_vs_jax_and_exact(case, ref, tmp_path):
    """The final state within 1e-10 of JAX's and within JAX's test
    tolerance (1e-6) of exact evolution; the energy within 1e-10 of JAX's
    and conserved (1e-8)."""
    out = tx.te_case('torch', case, str(tmp_path))
    v, v_ref = out[f'{case}.v'], ref[f'{case}.v']
    assert 1. - fidelity(v, v_ref) < 1e-10
    assert abs(np.linalg.norm(v) - np.linalg.norm(v_ref)) < 1e-10
    E, E_ref = float(out[f'{case}.E']), float(ref[f'{case}.E'])
    assert abs(E - E_ref) < 1e-10
    model, _ = tx.heisenberg_model('torch', 6)
    ed = ExactDiag.from_H_mpo(model.H_MPO)
    t = 0.4 if case == 'tdvp_two' else 0.3
    exact = ed.exp_H(t).to_numpy() @ out[f'{case}.v0']
    assert 1. - fidelity(exact, v) < 1e-6
    v0 = out[f'{case}.v0']
    E0 = np.real(np.vdot(v0, ed.full_H.to_numpy() @ v0))
    assert abs(E - E0) < 1e-8


@pytest.fixture(scope='module')
def krylov_setup(ref):
    """The port's two- and one-site effective H of JAX's evolved state
    (bond 2), with its thetas."""
    model, _ = tx.heisenberg_model('torch', 6)
    sub = {k[len('krylov.'):]: v for k, v in ref.items()
           if k.startswith('krylov.')}
    psi = tx.load_state(sub, 'psi', model.lat.mps_sites())
    env = MPOEnvironment(psi, model.H_MPO, psi)
    return {2: (mc.TwoSiteH(env, 2), psi.get_theta(2, 2)),
            1: (mc.OneSiteH(env, 2), psi.get_theta(2, 1))}, sub


@pytest.mark.parametrize('n', [2, 1])
@pytest.mark.parametrize('k', range(len(tx.TE_KRYLOV_DELTAS)))
def test_krylov_evolution_vs_jax(n, k, krylov_setup):
    """``exp(delta H) theta`` by the host ``LanczosEvolution`` and by the
    packed evolution, each within 1e-12 of JAX's ``LanczosEvolution`` on
    the same complex state, with the same number of Krylov steps."""
    Hs, sub = krylov_setup
    H, theta = Hs[n]
    assert theta.dtype == torch.complex128
    np.testing.assert_allclose(theta.to_numpy(), sub[f'theta{n}'], rtol=0,
                               atol=1e-14)
    delta = tx.TE_KRYLOV_DELTAS[k]
    ref_v, ref_N = sub[f'evolved{n}.{k}'], int(sub[f'N{n}.{k}'])
    host, N = LanczosEvolution(H, theta, dict(tx.TE_KRYLOV)).run(
        delta, normalize=True)
    host = host.itranspose(theta.get_leg_labels()).to_numpy()
    assert N == ref_N
    assert np.max(np.abs(host - ref_v)) < 1e-12
    pack = lambda a: pk.pack(a, multiple=mc.BUCKET_MULTIPLE,
                             pad_labels=VIRT, device='cpu')
    W = [pk.pack(W, pad=False, device='cpu') for W in
         ([H.W0, H.W1] if n == 2 else [H.W0])]
    mv = mc._matvec_2site_packed if n == 2 else mc._matvec_1site_packed
    LPp, RPp = pack(H.LP), pack(H.RP)
    th_p, N_p = mc.lanczos_evolve_packed(
        lambda v: mv(LPp, RPp, *W, v), pack(theta), delta,
        N_max=tx.TE_KRYLOV['N_max'], P_tol=tx.TE_KRYLOV['P_tol'],
        normalize=True)
    assert N_p == ref_N
    packed = pk.unpack(th_p, orig_legs=theta.legs).to_numpy()
    assert np.max(np.abs(packed - ref_v)) < 1e-12


@pytest.mark.parametrize('n', [2, 1])
def test_krylov_evolution_E_shift(n, krylov_setup):
    """With ``E_shift`` the host ``LanczosEvolution``, the packed evolution
    and the TDVP engine's packed route all give JAX's
    ``exp(delta H) theta`` times ``exp(delta E_shift)`` (1e-12), in as many
    Krylov steps."""
    Hs, sub = krylov_setup
    H, theta = Hs[n]
    delta, shift = tx.TE_KRYLOV_DELTAS[0], 0.37
    ref_v = np.exp(delta * shift) * sub[f'evolved{n}.0']
    ref_N = int(sub[f'N{n}.0'])
    opts = dict(tx.TE_KRYLOV, E_shift=shift)
    host, N = LanczosEvolution(H, theta, opts).run(delta, normalize=True)
    assert N == ref_N
    host = host.itranspose(theta.get_leg_labels()).to_numpy()
    assert np.max(np.abs(host - ref_v)) < 1e-12
    W = [mc.pack_W(W, 'cpu') for W in ([H.W0, H.W1] if n == 2 else [H.W0])]
    mv = mc._matvec_2site_packed if n == 2 else mc._matvec_1site_packed
    LPp, RPp = mc.pack_virtual(H.LP, 'cpu'), mc.pack_virtual(H.RP, 'cpu')
    th_p, N_p = mc.lanczos_evolve_packed(
        lambda v: mv(LPp, RPp, *W, v), mc.pack_virtual(theta, 'cpu'), delta,
        N_max=opts['N_max'], P_tol=opts['P_tol'], E_shift=shift,
        normalize=True)
    assert N_p == ref_N
    packed = pk.unpack(th_p, orig_legs=theta.legs).to_numpy()
    assert np.max(np.abs(packed - ref_v)) < 1e-12
    model, _ = tx.heisenberg_model('torch', 6)
    psi = tx.load_state(sub, 'psi', model.lat.mps_sites())
    eng = tdvp.TwoSiteTDVPEngine(psi, model, {
        'dt': tx.TE_DT, 'lanczos_options': opts}, device='cpu')
    routed, N_e = eng._evolve_device(H, theta, delta)
    assert N_e == ref_N
    routed = routed.itranspose(theta.get_leg_labels()).to_numpy()
    assert np.max(np.abs(routed - ref_v)) < 1e-12


def test_matvec_1site_packed(krylov_setup):
    """The packed one-site matvec (three tensordots) against the host
    ``OneSiteH.matvec`` (1e-13)."""
    Hs, _ = krylov_setup
    H, theta = Hs[1]
    pack = lambda a: pk.pack(a, multiple=mc.BUCKET_MULTIPLE,
                             pad_labels=VIRT, device='cpu')
    out = mc._matvec_1site_packed(pack(H.LP), pack(H.RP),
                                  pk.pack(H.W0, pad=False, device='cpu'),
                                  pack(theta))
    host = H.matvec(theta)
    got = pk.unpack(out, orig_legs=[host.get_leg(lab) for lab in
                                    out.get_leg_labels()])
    assert npc.norm(got - host.itranspose(got.get_leg_labels())) < \
        1e-13 * npc.norm(host)


def _step(psi, model, forced, monkeypatch):
    if forced:
        monkeypatch.setattr(tdvp.TDVPEngine, '_use_device_evolution',
                            lambda self, H: type(H) in (mc.TwoSiteH,
                                                        mc.OneSiteH))
    eng = tdvp.TwoSiteTDVPEngine(psi, model, {
        'dt': tx.TE_DT, 'N_steps': 1, 'trunc_params': dict(tx.TE_TRUNC)},
        device='cpu')
    eng.run()
    monkeypatch.undo()
    return eng


def test_tdvp_packed_route_vs_host(monkeypatch):
    """One two-site TDVP step with every two- and one-site evolution on the
    packed route (on the CPU) against the host route, from the same
    evolved state: overlap 1 within 1e-12, the same truncation; by default
    the engine on the CPU takes the host route only."""
    model, _ = tx.heisenberg_model('torch', 6)
    psi = tx._neel(tx._TE('torch'), model)
    tdvp.TwoSiteTDVPEngine(psi, model, {
        'dt': tx.TE_DT, 'N_steps': 3, 'trunc_params': dict(tx.TE_TRUNC)},
        device='cpu').run()
    a, b = psi.copy(), psi.copy()
    host = _step(a, model, False, monkeypatch)
    dev = _step(b, model, True, monkeypatch)
    assert {r for _, _, r, _ in host.evolve_stats} == {'host'}
    assert {r for _, _, r, _ in dev.evolve_stats} == {'device'}
    assert len(dev.evolve_stats) == len(host.evolve_stats) == 2 * 5 + 2 * 4
    assert [s[3] for s in dev.evolve_stats] == \
        [s[3] for s in host.evolve_stats]
    ov = abs(complex(a.overlap(b)))
    assert abs(ov - 1.) < 1e-12
    assert a.chi == b.chi


def test_tdvp_device_default_raises():
    """The engines run on the card by default and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model, _ = tx.heisenberg_model('torch', 6)
    psi = tx._neel(tx._TE('torch'), model)
    for cls in (tdvp.TwoSiteTDVPEngine, tdvp.SingleSiteTDVPEngine):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            cls(psi, model, {'dt': tx.TE_DT})
