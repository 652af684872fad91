r"""The Fermi-Hubbard model.

Port of ``FermiHubbardModel`` and ``FermiHubbardChain`` from
``tenpy_tpu/models/hubbard.py``: the same terms, added in the same order,
give the same MPO.
"""

from __future__ import annotations

import numpy as np

from .lattice import Chain
from .model import CouplingMPOModel, NearestNeighborModel
from ..networks.site import SpinHalfFermionSite

__all__ = ['FermiHubbardModel', 'FermiHubbardChain']


class FermiHubbardModel(CouplingMPOModel):
    r"""Fermi-Hubbard: ``H = -t sum (c^dag_{s,i} c_{s,j} + h.c.)
    + U sum n_up n_down + V sum n_i n_j - mu sum n``.

    Options: ``t`` (1.), ``U`` (0.), ``V`` (0.), ``mu`` (0.),
    ``cons_N`` ('N'), ``cons_Sz`` ('Sz'), and the lattice options of
    :class:`~tenpy_tpu_torch.models.model.CouplingMPOModel`.
    """

    def init_sites(self, model_params):
        cons_N = model_params.get('cons_N', 'N')
        cons_Sz = model_params.get('cons_Sz', 'Sz')
        return SpinHalfFermionSite(cons_N=cons_N, cons_Sz=cons_Sz)

    def init_terms(self, model_params):
        t = model_params.get('t', 1., 'real_or_array')
        U = model_params.get('U', 0., 'real_or_array')
        V = model_params.get('V', 0., 'real_or_array')
        mu = model_params.get('mu', 0., 'real_or_array')
        for u in range(len(self.lat.unit_cell)):
            self.add_onsite(-mu, u, 'Ntot')
            self.add_onsite(U, u, 'NuNd')
        for u1, u2, dx in self.lat.pairs['nearest_neighbors']:
            self.add_coupling(-t, u1, 'Cdu', u2, 'Cu', dx, plus_hc=True)
            self.add_coupling(-t, u1, 'Cdd', u2, 'Cd', dx, plus_hc=True)
            if np.any(np.asarray(V) != 0.):
                self.add_coupling(V, u1, 'Ntot', u2, 'Ntot', dx)


class FermiHubbardChain(FermiHubbardModel, NearestNeighborModel):
    """The Fermi-Hubbard model on a chain (with ``H_bond``)."""

    default_lattice = Chain
    force_default_lattice = True
