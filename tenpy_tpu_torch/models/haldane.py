r"""The Haldane Chern-insulator models on the honeycomb lattice.

Port of ``FermionicHaldaneModel`` and ``BosonicHaldaneModel`` from
``tenpy_tpu/models/haldane.py``: nearest-neighbour hopping ``t1`` and the
complex next-nearest-neighbour hopping ``t2``, with opposite chirality on
the two sublattices; the same terms, added in the same order, give the
same (complex) MPO.
"""

from __future__ import annotations

import numpy as np

from .lattice import Honeycomb
from .model import CouplingMPOModel
from ..networks.site import BosonSite, FermionSite

__all__ = ['FermionicHaldaneModel', 'BosonicHaldaneModel']


class _HaldaneModel(CouplingMPOModel):
    """The terms of both Haldane models, on the creation and annihilation
    operators ``_create`` and ``_annihilate`` of their site."""

    default_lattice = Honeycomb

    def init_terms(self, model_params):
        t1 = model_params.get('t1', -1., 'real_or_array')
        t2 = model_params.get('t2', 0.1 * abs(np.asarray(t1).flat[0])
                              * np.exp(1j * np.pi / 2.))
        mu = model_params.get('mu', 0., 'real_or_array')
        V = model_params.get('V', 0., 'real_or_array')
        cd, c = self._create, self._annihilate
        for u in (0, 1):
            self.add_onsite(-mu, u, 'N')
        for u1, u2, dx in self.lat.pairs['nearest_neighbors']:
            self.add_coupling(t1, u1, cd, u2, c, dx, plus_hc=True)
            if np.any(np.asarray(V) != 0.):
                self.add_coupling(V, u1, 'N', u2, 'N', dx)
        for u1, u2, dx in self.lat.pairs['next_nearest_neighbors']:
            self.add_coupling(t2 if u1 == 0 else np.conj(t2), u1, cd, u2, c,
                              dx, plus_hc=True)


class FermionicHaldaneModel(_HaldaneModel):
    r"""Spinless fermions on the honeycomb lattice with Haldane's complex
    next-nearest-neighbour hopping.

    Options: ``t1`` (-1.), ``t2`` (``0.1 |t1| i``), ``mu`` (0.), ``V``
    (0.), ``conserve`` ('N'), and the lattice options of
    :class:`~tenpy_tpu_torch.models.model.CouplingMPOModel`.
    """

    _create, _annihilate = 'Cd', 'C'

    def init_sites(self, model_params):
        return FermionSite(conserve=model_params.get('conserve', 'N'))


class BosonicHaldaneModel(_HaldaneModel):
    r"""The Haldane model of hard-core bosons (``BosonSite`` with
    ``Nmax=1``); options as :class:`FermionicHaldaneModel`."""

    _create, _annihilate = 'Bd', 'B'

    def init_sites(self, model_params):
        return BosonSite(Nmax=1, conserve=model_params.get('conserve', 'N'))
