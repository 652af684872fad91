r"""The Bose- and Fermi-Hubbard models.

Port of ``BoseHubbardModel``, ``BoseHubbardChain``, ``FermiHubbardModel``,
``FermiHubbardChain`` and ``FermiHubbardModel2`` from
``tenpy_tpu/models/hubbard.py``: the same terms, added in the same order,
give the same MPO.  ``DipolarBoseHubbardChain`` is not ported (it needs
``DipolarChargeInfo``).
"""

from __future__ import annotations

import numpy as np

from .lattice import Chain
from .model import CouplingMPOModel, NearestNeighborModel
from ..networks.site import (BosonSite, FermionSite, SpinHalfFermionSite,
                             spin_half_species)

__all__ = ['BoseHubbardModel', 'BoseHubbardChain', 'FermiHubbardModel',
           'FermiHubbardChain', 'FermiHubbardModel2']


class BoseHubbardModel(CouplingMPOModel):
    r"""Bose-Hubbard: ``H = -t sum (b^dag_i b_j + h.c.) + U/2 sum n(n-1)
    + V sum n_i n_j - mu sum n``.

    Options: ``t`` (1.), ``U`` (0.), ``V`` (0.), ``mu`` (0.), ``n_max``
    (3), ``filling`` (0.5), ``conserve`` ('N'), and the lattice options of
    :class:`~tenpy_tpu_torch.models.model.CouplingMPOModel`.
    """

    def init_sites(self, model_params):
        n_max = model_params.get('n_max', 3, int)
        filling = model_params.get('filling', 0.5, 'real')
        conserve = model_params.get('conserve', 'N')
        return BosonSite(Nmax=n_max, conserve='N' if conserve == 'best'
                         else conserve, filling=filling)

    def init_terms(self, model_params):
        t = model_params.get('t', 1., 'real_or_array')
        U = model_params.get('U', 0., 'real_or_array')
        V = model_params.get('V', 0., 'real_or_array')
        mu = model_params.get('mu', 0., 'real_or_array')
        for u in range(len(self.lat.unit_cell)):
            self.add_onsite(-np.asarray(mu) - np.asarray(U) / 2., u, 'N')
            self.add_onsite(np.asarray(U) / 2., u, 'NN')
        for u1, u2, dx in self.lat.pairs['nearest_neighbors']:
            self.add_coupling(-t, u1, 'Bd', u2, 'B', dx, plus_hc=True)
            self.add_coupling(V, u1, 'N', u2, 'N', dx)


class BoseHubbardChain(BoseHubbardModel, NearestNeighborModel):
    """The Bose-Hubbard model on a chain (with ``H_bond``)."""

    default_lattice = Chain
    force_default_lattice = True


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


class FermiHubbardModel2(CouplingMPOModel):
    r"""The :class:`FermiHubbardModel` on two
    :class:`~tenpy_tpu_torch.networks.site.FermionSite` species (up and
    down) of a
    :class:`~tenpy_tpu_torch.models.lattice.MultiSpeciesLattice`, in place
    of one ``SpinHalfFermionSite``; the same options.
    """

    def init_sites(self, model_params):
        return spin_half_species(FermionSite,
                                 cons_N=model_params.get('cons_N', 'N'),
                                 cons_Sz=model_params.get('cons_Sz', 'Sz'))

    def init_terms(self, model_params):
        t = model_params.get('t', 1., 'real_or_array')
        U = model_params.get('U', 0., 'real_or_array')
        V = model_params.get('V', 0., 'real_or_array')
        mu = model_params.get('mu', 0., 'real_or_array')
        for u in range(len(self.lat.unit_cell)):
            self.add_onsite(-mu, u, 'N')
        for u1, u2, dx in self.lat.pairs['onsite_up-down']:
            self.add_coupling(U, u1, 'N', u2, 'N', dx)
        for u1, u2, dx in self.lat.pairs['nearest_neighbors_diag']:
            self.add_coupling(-t, u1, 'Cd', u2, 'C', dx, plus_hc=True)
        if np.any(np.asarray(V) != 0.):
            for u1, u2, dx in self.lat.pairs['nearest_neighbors_all-all']:
                self.add_coupling(V, u1, 'N', u2, 'N', dx)
