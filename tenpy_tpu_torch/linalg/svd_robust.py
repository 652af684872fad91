"""Robust dense SVD: gesdd, retried with gesvd where it fails.

Port of ``tenpy_tpu/linalg/svd_robust.py`` (the reference's
``tenpy/linalg/svd_robust.py``).  LAPACK's divide-and-conquer ``gesdd``
is fast but can fail to converge on ill-conditioned matrices; the slower
QR-iteration ``gesvd`` then usually succeeds.  Here ``gesdd`` is
``torch.linalg.svd`` itself (MKL's ``gesdd`` for a CPU tensor, cuSOLVER
for a CUDA one), and the retry runs ``gesvd``: cuSOLVER's
(``driver='gesvd'``) for a CUDA tensor, LAPACK's through scipy for a CPU
tensor (torch has no CPU driver choice).  A failure is a
``torch.linalg.LinAlgError`` or NaN among the singular values.  Every
blockwise SVD of :func:`~tenpy_tpu_torch.linalg.np_conserved.svd` goes
through :func:`svd`.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

__all__ = ['svd']


def svd(a, full_matrices=True, compute_uv=True, overwrite_a=False,
        check_finite=True, lapack_driver='gesdd', warn=True):
    """``(U, S, Vh)`` (or ``S`` alone without ``compute_uv``) of a matrix
    (or a batch), with scipy's signature: a torch tensor gives torch
    tensors on its device, anything else numpy arrays.

    ``lapack_driver='gesdd'`` tries ``torch.linalg.svd`` first and, where
    it fails, warns (with ``warn``) and retries with ``gesvd``;
    ``'gesvd'`` runs ``gesvd`` at once.  ``check_finite`` raises a
    ``ValueError`` on a non-finite input; ``overwrite_a`` is accepted and
    has no effect (the input is never written)."""
    as_numpy = not isinstance(a, torch.Tensor)
    t = torch.from_numpy(np.asarray(a)) if as_numpy else a
    if lapack_driver not in ('gesdd', 'gesvd'):
        raise ValueError(f"unknown lapack_driver {lapack_driver!r}")
    if check_finite and not bool(torch.isfinite(t).all()):
        raise ValueError("array must not contain infs or NaNs")
    res = None
    if lapack_driver == 'gesdd':
        try:
            res = _torch_svd(t, full_matrices, compute_uv, None)
        except torch.linalg.LinAlgError:
            res = None
        if res is not None and bool(torch.isnan(res[1]).any()):
            res = None
        if res is None and warn:
            warnings.warn("svd (gesdd) did not converge: retrying with gesvd",
                          stacklevel=2)
    if res is None:
        res = _gesvd(t, full_matrices, compute_uv)
    if as_numpy:
        res = tuple(None if x is None else x.numpy() for x in res)
    return res if compute_uv else res[1]


def _torch_svd(t, full_matrices, compute_uv, driver):
    if compute_uv:
        return torch.linalg.svd(t, full_matrices=full_matrices, driver=driver)
    return None, torch.linalg.svdvals(t, driver=driver), None


def _gesvd(t, full_matrices, compute_uv):
    """The QR-iteration SVD: cuSOLVER's on the card, LAPACK's (scipy) on
    the host."""
    if t.device.type == 'cuda':
        return _torch_svd(t, full_matrices, compute_uv, 'gesvd')
    import scipy.linalg
    res = scipy.linalg.svd(t.resolve_conj().numpy(),
                           full_matrices=full_matrices, compute_uv=compute_uv,
                           lapack_driver='gesvd')
    if not compute_uv:
        return None, torch.from_numpy(np.asarray(res)), None
    return tuple(torch.from_numpy(np.asarray(x)) for x in res)
