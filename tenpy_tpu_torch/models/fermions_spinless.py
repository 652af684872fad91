r"""Spinless fermions with hopping, chemical potential and interaction.

Port of ``FermionModel`` and ``FermionChain`` from
``tenpy_tpu/models/fermions_spinless.py``:
``H = -J sum (c^dag_i c_j + h.c.) + V sum n_i n_j - mu sum n_i``.
"""

from __future__ import annotations

from .lattice import Chain
from .model import CouplingMPOModel, NearestNeighborModel
from ..networks.site import FermionSite

__all__ = ['FermionModel', 'FermionChain']


class FermionModel(CouplingMPOModel):
    r"""Spinless fermions on any lattice (Jordan-Wigner strings inserted).

    Options: ``J`` (1.), ``V`` (0.), ``mu`` (0.), ``conserve`` ('N'), and
    the lattice options of
    :class:`~tenpy_tpu_torch.models.model.CouplingMPOModel`.
    """

    def init_sites(self, model_params):
        conserve = model_params.get('conserve', 'N')
        return FermionSite(conserve='N' if conserve == 'best' else conserve)

    def init_terms(self, model_params):
        J = model_params.get('J', 1., 'real_or_array')
        V = model_params.get('V', 0., 'real_or_array')
        mu = model_params.get('mu', 0., 'real_or_array')
        for u in range(len(self.lat.unit_cell)):
            self.add_onsite(-mu, u, 'N')
        for u1, u2, dx in self.lat.pairs['nearest_neighbors']:
            self.add_coupling(-J, u1, 'Cd', u2, 'C', dx, plus_hc=True)
            self.add_coupling(V, u1, 'N', u2, 'N', dx)


class FermionChain(FermionModel, NearestNeighborModel):
    """Spinless fermions on a chain (with ``H_bond``)."""

    default_lattice = Chain
    force_default_lattice = True
