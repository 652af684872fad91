"""Linear operators acting on :class:`~.np_conserved.Array` vectors.

Port of ``NpcLinearOperator`` from ``tenpy_tpu/linalg/sparse.py``; the
scipy bridge (``FlatLinearOperator``) is not ported.
"""

from __future__ import annotations

__all__ = ['NpcLinearOperator']


class NpcLinearOperator:
    """Base class: a linear operator on Arrays (``dtype``, ``matvec``)."""

    dtype = None
    acts_on = None

    def matvec(self, vec):
        raise NotImplementedError("subclass must implement matvec")
