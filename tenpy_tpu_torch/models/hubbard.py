r"""The Bose- and Fermi-Hubbard models.

Port of ``BoseHubbardModel``, ``BoseHubbardChain``, ``FermiHubbardModel``,
``FermiHubbardChain``, ``FermiHubbardModel2`` and
``DipolarBoseHubbardChain`` from ``tenpy_tpu/models/hubbard.py``: the same
terms, added in the same order, give the same MPO.
"""

from __future__ import annotations

import numpy as np

from .lattice import Chain
from .model import CouplingMPOModel, NearestNeighborModel
from ..networks.site import (BosonSite, FermionSite, SpinHalfFermionSite,
                             spin_half_species)

__all__ = ['BoseHubbardModel', 'BoseHubbardChain', 'FermiHubbardModel',
           'FermiHubbardChain', 'FermiHubbardModel2',
           'DipolarBoseHubbardChain']


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


class DipolarBoseHubbardChain(CouplingMPOModel):
    r"""The dipole-conserving Bose-Hubbard chain:
    ``H = -t sum_i (b^dag_i b^2_{i+1} b^dag_{i+2} + h.c.)
    - t4 sum_i (b^dag_i b_{i+1} b_{i+2} b^dag_{i+3} + h.c.)
    + U/2 sum_i n_i (n_i - 1) - mu sum_i n_i``.

    Options: ``L`` (64), ``Nmax`` (2), ``conserve`` ('best': 'dipole'),
    ``t`` (1.), ``t4`` (0.), ``U`` (1.), ``mu`` (0.), ``bc_MPS``
    ('finite'), ``bc``.
    """

    def init_lattice(self, model_params):
        L = model_params.get('L', 64)
        Nmax = model_params.get('Nmax', 2)
        conserve = model_params.get('conserve', 'best')
        if conserve == 'best':
            conserve = 'dipole'
        bc_MPS = model_params.get('bc_MPS', 'finite')
        bc = model_params.get('bc', 'periodic' if bc_MPS in (
            'infinite', 'segment') else 'open')
        return Chain(L, BosonSite(Nmax=Nmax, conserve=conserve), bc=bc,
                     bc_MPS=bc_MPS)

    def init_terms(self, model_params):
        U = model_params.get('U', 1., 'real_or_array')
        t = model_params.get('t', 1., 'real_or_array')
        t4 = model_params.get('t4', 0., 'real_or_array')
        mu = model_params.get('mu', 0., 'real_or_array')
        self.add_multi_coupling(
            -t, [('Bd', 0, 0), ('B', 1, 0), ('B', 1, 0), ('Bd', 2, 0)],
            plus_hc=True)
        if np.any(np.asarray(t4) != 0.):
            self.add_multi_coupling(
                -t4, [('Bd', 0, 0), ('B', 1, 0), ('B', 2, 0), ('Bd', 3, 0)],
                plus_hc=True)
        self.add_onsite(U / 2., 0, 'NN')
        self.add_onsite(-np.asarray(mu) - U / 2., 0, 'N')
