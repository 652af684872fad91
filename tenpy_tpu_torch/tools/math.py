"""Math helpers: the entropy of a probability distribution.

Port of ``entropy`` from ``tenpy_tpu/tools/math.py``, which
:meth:`~tenpy_tpu_torch.networks.mps.MPS.entanglement_entropy` calls.
"""

from __future__ import annotations

import numpy as np

__all__ = ['entropy']


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
