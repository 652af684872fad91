"""The port's packed Lanczos against ``_lanczos_K_2site_packed_impl`` (JAX).

Same effective Hamiltonian (site 3 of the S=1 Heisenberg chain of
tests/test_packed_dmrg.py), packed by each package.  Both branches: the
fixed-K loop and the ``P_tol`` early-exit loop (with and without reortho).
E0 to 1e-12 relative and the same iteration count (f64, summation order
only); the Ritz vector, up to sign, to 1e-9 (an eigenvector of a K x K
tridiagonal matrix is fixed only to the eigenvalue gap).
"""
import numpy as np
import pytest
import torch

from tenpy_tpu.algorithms.mps_common import (
    _lanczos_K_2site_packed_impl as jax_lanczos)
from tenpy_tpu.linalg import packed as jpk
from tenpy_tpu.networks.mpo import MPOEnvironment
from tenpy_tpu_torch.algorithms.mps_common import (
    _lanczos_K_2site_packed_impl, _matvec_2site_packed)
from tenpy_tpu_torch.linalg import packed as pk

from test_packed_dmrg import _ramped_state
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
