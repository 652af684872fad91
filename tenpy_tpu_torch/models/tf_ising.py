r"""The transverse-field Ising model.

Port of ``TFIModel`` and ``TFIChain`` from ``tenpy_tpu/models/tf_ising.py``:
``H = -J sum sigma^x_i sigma^x_j - g sum sigma^z_i``.  With the default
``conserve='parity'`` the sites carry the Z_2 charge of the spin-flip
symmetry (a :class:`~tenpy_tpu_torch.linalg.charges.ChargeInfo` with
``mod`` 2).
"""

from __future__ import annotations

from .lattice import Chain
from .model import CouplingMPOModel, NearestNeighborModel
from ..networks.site import SpinHalfSite

__all__ = ['TFIModel', 'TFIChain']


class TFIModel(CouplingMPOModel):
    r"""Transverse-field Ising on a lattice.

    Options: ``J`` (1.), ``g`` (1.), ``conserve`` ('parity' | 'None' |
    'best' = 'parity'), and the lattice options of
    :class:`~tenpy_tpu_torch.models.model.CouplingMPOModel`.
    """

    def init_sites(self, model_params):
        conserve = model_params.get('conserve', 'parity')
        if conserve == 'best':
            conserve = 'parity'
        return SpinHalfSite(conserve=conserve)

    def init_terms(self, model_params):
        J = model_params.get('J', 1., 'real_or_array')
        g = model_params.get('g', 1., 'real_or_array')
        for u in range(len(self.lat.unit_cell)):
            self.add_onsite(-g, u, 'Sigmaz')
        for u1, u2, dx in self.lat.pairs['nearest_neighbors']:
            self.add_coupling(-J, u1, 'Sigmax', u2, 'Sigmax', dx)


class TFIChain(TFIModel, NearestNeighborModel):
    """The transverse-field Ising model on a chain (with ``H_bond``)."""

    default_lattice = Chain
    force_default_lattice = True
