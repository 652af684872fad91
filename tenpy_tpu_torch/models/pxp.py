r"""The PXP model of Rydberg atoms in the blockade regime.

Port of ``PXPChain`` from ``tenpy_tpu/models/pxp.py``:
``H = Omega sum P_{i-1} X_i P_{i+1}`` with ``P`` the projector on 'down',
a three-site multi-coupling.
"""

from __future__ import annotations

import numpy as np

from .lattice import Chain
from .model import CouplingMPOModel
from ..networks.site import SpinHalfSite

__all__ = ['PXPChain']


class PXPChain(CouplingMPOModel):
    """The PXP chain.  Options: ``Omega`` (1.), and the lattice options of
    :class:`~tenpy_tpu_torch.models.model.CouplingMPOModel`."""

    default_lattice = Chain
    force_default_lattice = True

    def init_sites(self, model_params):
        site = SpinHalfSite(conserve=None)
        site.add_op('P0', np.array([[0., 0.], [0., 1.]]), permute_dense=True)
        return site

    def init_terms(self, model_params):
        Omega = model_params.get('Omega', 1., 'real_or_array')
        self.add_multi_coupling(Omega, [('P0', [-1], 0), ('Sigmax', [0], 0),
                                        ('P0', [1], 0)])
