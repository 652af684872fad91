"""The port's packed Lanczos against ``_lanczos_K_2site_packed_impl`` (JAX).

Same effective Hamiltonian (site 3 of the S=1 Heisenberg chain of
tests/test_packed_dmrg.py), packed by each package.  Both branches: the
fixed-K loop and the ``P_tol`` early-exit loop (with and without reortho).
E0 to 1e-12 relative and the same iteration count (f64, summation order
only); the Ritz vector, up to sign, to 1e-9 (an eigenvector of a K x K
tridiagonal matrix is fixed only to the eigenvalue gap).

The packed ground-state Lanczos of any effective H
(``lanczos_ground_packed``, VUMPS's route to the card) on the zero-, one-
and two-site effective H of the port's own XX chain against the host
``LanczosGroundState`` on the same H: E0 to 1e-12, ``|<host|packed>|`` to
1 - 1e-10; its two-site form bit for bit the two-site Lanczos.  The
environments of a bond matrix S (a UniformMPS's C) by
``MPOTransferMatrix`` and by the GMRES builder against JAX's (1e-10, from
``tests/benchmark_data/vumps_reference.npz``).
"""
import numpy as np
import pytest
import torch

from tenpy_tpu.algorithms.mps_common import (
    _lanczos_K_2site_packed_impl as jax_lanczos)
from tenpy_tpu.linalg import packed as jpk
from tenpy_tpu.networks.mpo import MPOEnvironment
from tenpy_tpu_torch.algorithms import dmrg
from tenpy_tpu_torch.algorithms import mps_common as mc
from tenpy_tpu_torch.algorithms.mps_common import (
    _lanczos_K_2site_packed_impl, _matvec_2site_packed)
from tenpy_tpu_torch.linalg import np_conserved as npc
from tenpy_tpu_torch.linalg import packed as pk
from tenpy_tpu_torch.linalg.krylov_based import LanczosGroundState
from tenpy_tpu_torch.models.xxz_chain import XXZChain
from tenpy_tpu_torch.networks import exchange
from tenpy_tpu_torch.networks.mpo import MPOEnvironment as PortEnvironment
from tenpy_tpu_torch.networks.mps import MPS

from test_packed_dmrg import _ramped_state
import torch_exchange as tx
from torch_exchange import to_host

torch.set_num_threads(1)

VIRT = ('vL', 'vR', 'vL*', 'vR*')


@pytest.fixture(scope='module')
def effH():
    m, psi, _ = _ramped_state(L=8, chi=24, sweeps=3)
    i0 = 3
    env = MPOEnvironment(psi, m.H_MPO, psi)
    host = [env.get_LP(i0).transpose(['vR*', 'wR', 'vR']),
            env.get_RP(i0 + 1).transpose(['wL', 'vL', 'vL*']),
            m.H_MPO.get_W(i0).transpose(['wL', 'wR', 'p', 'p*']),
            m.H_MPO.get_W(i0 + 1).transpose(['wL', 'wR', 'p', 'p*']),
            psi.get_theta(i0, 2).itranspose(['vL', 'p0', 'p1', 'vR'])]
    out = {}
    for name, pkg, conv, kw in (('jax', jpk, lambda a: a, {}),
                                ('port', pk, to_host, {'device': 'cpu'})):
        LP, RP, W0, W1, th = (conv(a) for a in host)
        out[name] = (
            pkg.pack(LP, multiple=16, pad_labels=VIRT, **kw),
            pkg.pack(RP, multiple=16, pad_labels=VIRT, **kw),
            pkg.pack(W0, pad=False, **kw).replace_labels(['p', 'p*'],
                                                         ['p0', 'p0*']),
            pkg.pack(W1, pad=False, **kw).replace_labels(['p', 'p*'],
                                                         ['p1', 'p1*']),
            pkg.pack(th, multiple=16, pad_labels=VIRT, **kw))
    return out


def _assert_same_up_to_sign(p, q, tol):
    x = np.concatenate([d.numpy().ravel() for d in p.data])
    y = np.concatenate([np.asarray(d).ravel() for d in q.data])
    sign = 1. if x @ y >= 0 else -1.
    assert np.abs(x - sign * y).max() <= tol


@pytest.mark.parametrize('K, P_tol, reortho', [(10, 0., False),
                                               (30, 1e-12, False),
                                               (30, 1e-12, True)])
def test_lanczos_vs_jax(effH, K, P_tol, reortho):
    jE, jth, jN, jres = jax_lanczos(*effH['jax'], K, P_tol, 2, reortho)
    pE, pth, pN, pres = _lanczos_K_2site_packed_impl(*effH['port'], K, P_tol,
                                                     2, reortho)
    assert isinstance(pN, int) and pN == int(jN)
    assert P_tol == 0. or pN < K          # the early exit was taken
    assert abs(pE - float(jE)) <= 1e-12 * abs(float(jE))
    _assert_same_up_to_sign(pth, jth, 1e-9)
    assert abs(float(pk.norm(pth)) - 1.) <= 1e-12


def test_lanczos_exact_E_f32_vs_jax(effH):
    """``exact_E`` with f32 matvecs: the f64 Rayleigh quotient of the
    f32-iterated Ritz vector.  Against JAX to 1e-9 relative: the two f32
    GEMM paths round differently (2e-7), which moves the Ritz vector by
    that much and its Rayleigh quotient quadratically less."""
    jE, _, _, _ = jax_lanczos(*effH['jax'], 10, matvec_mode='f32',
                              exact_E=True)
    pE64, _, _, _ = _lanczos_K_2site_packed_impl(*effH['port'], 10)
    pE, pth, _, _ = _lanczos_K_2site_packed_impl(
        *effH['port'], 10, matvec_mode='f32', exact_E=True)
    assert abs(pE - float(jE)) <= 1e-9 * abs(float(jE))
    assert pE >= pE64 - 1e-12              # variational
    assert abs(pE - pE64) < 1e-8
    LP, RP, W0, W1, _ = effH['port']
    hw = _matvec_2site_packed(LP, RP, W0, W1, pth)
    assert abs(pE - float(pk.inner(pth.conj(), hw))) <= 1e-12 * abs(pE)


@pytest.fixture(scope='module')
def xx_env():
    """The environments of the port's XX chain (L=10, Sz, chi 16)."""
    m = XXZChain({'L': 10, 'Jxx': 1., 'Jz': 0., 'hz': 0.,
                  'bc_MPS': 'finite', 'conserve': 'Sz'})
    psi = MPS.from_product_state(m.lat.mps_sites(), ['up', 'down'] * 5)
    dmrg.run(psi, m, {'trunc_params': {'chi_max': 16, 'svd_min': 1e-12},
                      'max_sweeps': 4}, device='cpu')
    return psi, PortEnvironment(psi, m.H_MPO, psi)


@pytest.mark.parametrize('n', [0, 1, 2])
def test_packed_ground_state_vs_host(xx_env, n):
    """The packed Lanczos of the zero-, one- and two-site effective H at
    the chain's centre from a perturbed guess against the host
    ``LanczosGroundState`` on the same H (both run to convergence)."""
    psi, env = xx_env
    i0 = 5
    if n == 0:
        eff = mc.ZeroSiteH(env, i0)
        th = psi.get_theta(i0, 1)
        guess = npc.tensordot(th, psi.get_B(i0, 'B').conj(),
                              axes=[['p0', 'vR'], ['p*', 'vR*']])
        guess.ireplace_label('vL*', 'vR')
    else:
        eff = (mc.OneSiteH if n == 1 else mc.TwoSiteH)(env, i0)
        guess = psi.get_theta(i0, n)
    guess = guess.itranspose(eff.acts_on)
    rng = np.random.default_rng(n)
    guess = guess + 0.1 * npc.Array.from_func(
        lambda shape: rng.standard_normal(shape), guess.legs,
        qtotal=guess.qtotal, labels=guess.get_leg_labels())
    assert eff.N >= 64
    E_h, th_h, _ = LanczosGroundState(eff, guess, {
        'N_max': 80, 'P_tol': 1e-30, 'N_min': 80}).run()
    ops = eff.pack_operands('cpu')
    assert len(ops) == {0: 2, 1: 3, 2: 4}[n]
    E_p, th_p, N_p, _ = mc.lanczos_ground_packed(
        eff.packed_matvec, ops, mc.pack_virtual(guess, 'cpu'), 80, 1e-15)
    th_p = pk.unpack(th_p, orig_legs=[guess.get_leg(lbl)
                                      for lbl in th_p.get_leg_labels()])
    assert abs(E_p - E_h) <= 1e-12 * abs(E_h)
    ov = abs(complex(npc.inner(th_h.conj(), th_p, axes='range')))
    assert 1. - ov <= 1e-10


def test_two_site_general_lanczos_is_the_two_site_one(effH):
    """``lanczos_ground_packed`` with the two-site matvec gives the two-site
    Lanczos's numbers bit for bit (fixed K and early exit)."""
    ops, th = effH['port'][:4], effH['port'][4]
    for K, P_tol in ((10, 0.), (30, 1e-12)):
        a = _lanczos_K_2site_packed_impl(*ops, th, K, P_tol)
        b = mc.lanczos_ground_packed(_matvec_2site_packed, ops, th, K, P_tol)
        assert a[0] == b[0] and a[2] == b[2] and a[3] == b[3]
        assert all(torch.equal(x, y) for x, y in zip(a[1].data, b[1].data))


def test_matrix_S_environments_vs_jax():
    """A UniformMPS whose ``get_SL`` is the bond matrix C: the Arnoldi
    environments and energies of ``MPOTransferMatrix.find_init_LP_RP``, and
    the GMRES builder's (AL and AR stored as the MPS's forms), against
    JAX's on the same state (1e-10)."""
    ref = exchange.load_flat(tx.VUMPS_REF)
    out = tx.vumps_case('torch', 'envs', ref)
    for key in ('tm.LP', 'tm.RP', 'builder.LP', 'builder.RP'):
        scale = np.abs(ref[f'envs.{key}']).max()
        assert np.abs(out[f'envs.{key}'] - ref[f'envs.{key}']).max() \
            <= 1e-10 * scale, key
    assert np.allclose(out['envs.tm.Es'], ref['envs.tm.Es'], rtol=0,
                       atol=1e-10)
    assert abs(complex(out['envs.tm.E0']) - complex(ref['envs.tm.E0'])) \
        <= 1e-10
    for name in ('LP', 'RP'):
        assert abs(float(out[f'envs.builder.E_{name}'])
                   - float(ref[f'envs.builder.E_{name}'])) <= 1e-10
    # both routes find the same fixed point
    assert np.abs(out['envs.builder.LP'] - out['envs.tm.LP']).max() <= 1e-9
    assert abs(float(out['envs.builder.E_LP'])
               - float(out['envs.tm.Es'][1])) <= 1e-10
