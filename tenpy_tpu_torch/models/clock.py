r"""The q-state quantum clock model.

Port of ``ClockModel`` and ``ClockChain`` from
``tenpy_tpu/models/clock.py``:
``H = -J sum (X_i X^dag_j + h.c.) - g sum (Z_i + Z^dag_i)``.
"""

from __future__ import annotations

from .lattice import Chain
from .model import CouplingMPOModel, NearestNeighborModel
from ..networks.site import ClockSite

__all__ = ['ClockModel', 'ClockChain']


class ClockModel(CouplingMPOModel):
    """The q-state clock model.  Options: ``q`` (2), ``J`` (1.), ``g``
    (1.), ``conserve`` ('Z'), and the lattice options of
    :class:`~tenpy_tpu_torch.models.model.CouplingMPOModel`."""

    def init_sites(self, model_params):
        q = model_params.get('q', 2, int)
        conserve = model_params.get('conserve', 'Z')
        return ClockSite(q=q, conserve='Z' if conserve == 'best'
                         else conserve)

    def init_terms(self, model_params):
        J = model_params.get('J', 1., 'real_or_array')
        g = model_params.get('g', 1., 'real_or_array')
        for u in range(len(self.lat.unit_cell)):
            self.add_onsite(-g, u, 'Z', plus_hc=True)
        for u1, u2, dx in self.lat.pairs['nearest_neighbors']:
            self.add_coupling(-J, u1, 'X', u2, 'Xhc', dx, plus_hc=True)


class ClockChain(ClockModel, NearestNeighborModel):
    """The clock model on a chain (with ``H_bond``)."""

    default_lattice = Chain
    force_default_lattice = True
