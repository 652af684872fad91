r"""The t-J model.

Port of ``tJModel`` and ``tJChain`` from ``tenpy_tpu/models/tj_model.py``:
``H = -t sum (c^dag_{s,i} c_{s,j} + h.c.) + J sum (S_i . S_j - n_i n_j /
4)`` without double occupancy (``SpinHalfHoleSite``).
"""

from __future__ import annotations

from .lattice import Chain
from .model import CouplingMPOModel, NearestNeighborModel
from ..networks.site import SpinHalfHoleSite

__all__ = ['tJModel', 'tJChain']


class tJModel(CouplingMPOModel):
    """The t-J model.  Options: ``t`` (1.), ``J`` (0.3), ``cons_N`` ('N'),
    ``cons_Sz`` ('Sz'), and the lattice options of
    :class:`~tenpy_tpu_torch.models.model.CouplingMPOModel`."""

    def init_sites(self, model_params):
        return SpinHalfHoleSite(cons_N=model_params.get('cons_N', 'N'),
                                cons_Sz=model_params.get('cons_Sz', 'Sz'))

    def init_terms(self, model_params):
        t = model_params.get('t', 1., 'real_or_array')
        J = model_params.get('J', 0.3, 'real_or_array')
        for u1, u2, dx in self.lat.pairs['nearest_neighbors']:
            self.add_coupling(-t, u1, 'Cdu', u2, 'Cu', dx, plus_hc=True)
            self.add_coupling(-t, u1, 'Cdd', u2, 'Cd', dx, plus_hc=True)
            self.add_coupling(J / 2., u1, 'Sp', u2, 'Sm', dx, plus_hc=True)
            self.add_coupling(J, u1, 'Sz', u2, 'Sz', dx)
            self.add_coupling(-J / 4., u1, 'Ntot', u2, 'Ntot', dx)


class tJChain(tJModel, NearestNeighborModel):
    """The t-J model on a chain (with ``H_bond``)."""

    default_lattice = Chain
    force_default_lattice = True
