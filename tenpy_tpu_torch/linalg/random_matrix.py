"""Random matrix ensembles (GOE, GUE, CRE, COE, CUE, close to 1) for
random states and gates.

Port of ``tenpy_tpu/linalg/random_matrix.py``, in numpy on the host with
numpy ``Generator`` s, so that one seed gives both packages the same
matrices bit for bit.  They fill the charge blocks of
``Array.from_func`` (the random unitaries of
:class:`~tenpy_tpu_torch.algorithms.tebd.RandomUnitaryEvolution`).
"""

from __future__ import annotations

import numpy as np

__all__ = ['box', 'standard_normal_complex', 'GOE', 'GUE', 'CRE', 'COE', 'CUE',
           'O_close_1', 'U_close_1']

_rng = np.random.default_rng()


def box(size, W=1., rng=None):
    """Uniform in [-W, W]."""
    rng = rng or _rng
    return rng.uniform(-W, W, size=size)


def standard_normal_complex(size, rng=None):
    rng = rng or _rng
    return rng.standard_normal(size) + 1j * rng.standard_normal(size)


def GOE(size, rng=None):
    """Gaussian orthogonal ensemble: (A + A^T)/2, A iid N(0,1)."""
    rng = rng or _rng
    A = rng.standard_normal(size)
    return (A + A.T) * 0.5


def GUE(size, rng=None):
    """Gaussian unitary ensemble: (A + A^dagger)/2, A iid complex normal."""
    A = standard_normal_complex(size, rng)
    return (A + A.conj().T) * 0.5


def CRE(size, rng=None):
    """Circular real ensemble: Haar-random orthogonal matrix."""
    rng = rng or _rng
    A = rng.standard_normal(size)
    Q, R = np.linalg.qr(A)
    return Q * np.sign(np.diagonal(R))


def COE(size, rng=None):
    """Circular orthogonal ensemble: U^T U with U from CUE."""
    U = CUE(size, rng)
    return U.T @ U


def CUE(size, rng=None):
    """Circular unitary ensemble: Haar-random unitary matrix."""
    A = standard_normal_complex(size, rng)
    Q, R = np.linalg.qr(A)
    d = np.diagonal(R)
    return Q * (d / np.abs(d))


def O_close_1(size, a=0.01, rng=None):
    """Orthogonal matrix close to the identity: expm(a * antisymmetric)."""
    import scipy.linalg
    rng = rng or _rng
    A = rng.standard_normal(size)
    return scipy.linalg.expm(a * 0.5 * (A - A.T))


def U_close_1(size, a=0.01, rng=None):
    """Unitary matrix close to the identity: expm(i a * hermitian)."""
    import scipy.linalg
    H = GUE(size, rng)
    return scipy.linalg.expm(1j * a * H)
