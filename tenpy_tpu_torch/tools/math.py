"""Math helpers on numpy arrays.

Port of ``tenpy_tpu/tools/math.py``: the entropy of a probability
distribution (which :meth:`~tenpy_tpu_torch.networks.mps.MPS.
entanglement_entropy` calls), the dense matrix of a linear operator,
integer helpers, scipy's ARPACK eigensolvers with a dense route for small
matrices, the sign of a permutation, and QR/RQ decompositions that keep
only the linearly independent columns (rows).
"""

from __future__ import annotations

import numpy as np

__all__ = ['matvec_to_array', 'entropy', 'gcd', 'gcd_array', 'lcm', 'speigs',
           'speigsh', 'perm_sign', 'qr_li', 'rq_li']


def matvec_to_array(H):
    """The dense matrix of a linear operator ``H`` with ``H.dim``, an
    optional ``H.dtype`` and ``H.matvec`` on flat numpy vectors: column
    ``i`` is ``H.matvec(e_i)``."""
    X = np.eye(H.dim, dtype=getattr(H, 'dtype', np.float64))
    return np.stack([np.asarray(H.matvec(X[:, i])) for i in range(H.dim)],
                    axis=1)


def entropy(p, n=1):
    """Renyi entropy of order ``n`` of a probability distribution ``p``
    (``n=1``: von Neumann); entries at or below 1e-30 are dropped."""
    p = np.asarray(p)
    p = p[p > 1e-30]
    if n == 1:
        return -np.inner(p, np.log(p))
    if n == np.inf:
        return -np.log(np.max(p))
    return np.log(np.sum(p ** n)) / (1. - n)


def gcd(a, b):
    """The greatest common divisor of two integers (non-negative)."""
    a, b = abs(int(a)), abs(int(b))
    while b:
        a, b = b, a % b
    return a


def gcd_array(a):
    """The greatest common divisor of every entry of ``a``."""
    a = np.asarray(a).ravel()
    if len(a) == 0:
        raise ValueError("empty array")
    res = abs(int(a[0]))
    for x in a[1:]:
        res = gcd(res, x)
    return res


def lcm(a, b):
    """The least common multiple of two integers (0 if both are 0)."""
    g = gcd(a, b)
    return abs(int(a) * int(b)) // g if g else 0


def _dense_eig(A, k, which, hermitian):
    """The ``k`` eigenpairs of a small matrix by ``which``, densely."""
    import scipy.sparse
    from .misc import argsort
    if scipy.sparse.issparse(A):
        A = A.toarray()
    W, V = np.linalg.eigh(A) if hermitian else np.linalg.eig(A)
    keep = argsort(W, which)[:k]
    return W[keep], V[:, keep]


def speigs(A, k, *args, **kwargs):
    """``scipy.sparse.linalg.eigs``; for ``k >= dim - 1``, where ARPACK
    refuses, the dense eigendecomposition's ``k`` eigenpairs by ``which``
    ('LM' by default)."""
    import scipy.sparse.linalg
    if k >= A.shape[0] - 1:
        return _dense_eig(A, k, kwargs.get('which', 'LM'), False)
    return scipy.sparse.linalg.eigs(A, k, *args, **kwargs)


def speigsh(A, k, *args, **kwargs):
    """``scipy.sparse.linalg.eigsh``, with the dense route of
    :func:`speigs` for ``k >= dim - 1``."""
    import scipy.sparse.linalg
    if k >= A.shape[0] - 1:
        which = kwargs.get('which', 'LM')
        which = {'LM': 'm>', 'SM': 'm<', 'LA': '>', 'SA': '<'}.get(which,
                                                                   which)
        return _dense_eig(A, k, which, True)
    return scipy.sparse.linalg.eigsh(A, k, *args, **kwargs)


def perm_sign(p):
    """The sign (+1 or -1) of the permutation ``p``."""
    p = list(p)
    sign = 1
    for i in range(len(p)):
        while p[i] != i:
            j = p[i]
            p[i], p[j] = p[j], p[i]
            sign = -sign
    return sign


def qr_li(A, cutoff=1e-15):
    """``A = Q R`` keeping only the linearly independent columns of ``Q``:
    a column-pivoted economic QR whose diagonal entries of ``R`` at or
    below ``cutoff`` times the largest are dropped, with the pivoting of
    ``R``'s columns undone."""
    import scipy.linalg
    A = np.asarray(A)
    q, r, piv = scipy.linalg.qr(A, mode='economic', pivoting=True)
    d = np.abs(np.diagonal(r))
    keep = d > cutoff * (d[0] if len(d) else 1.)
    inv = np.empty_like(piv)
    inv[piv] = np.arange(len(piv))
    return q[:, keep], r[keep, :][:, inv]


def rq_li(A, cutoff=1e-15):
    """``A = R Q`` with linearly independent rows of ``Q`` (the
    :func:`qr_li` of the flipped adjoint)."""
    q, r = qr_li(np.asarray(A)[::-1, ::-1].T.conj(), cutoff)
    return r[::-1, ::-1].T.conj(), q[::-1, ::-1].T.conj()
