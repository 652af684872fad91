r"""The AKLT chain.

Port of ``AKLTChain`` from ``tenpy_tpu/models/aklt.py``:
``H = sum J [S_i . S_j + (S_i . S_j)^2 / 3]`` for spin 1, without the
constant ``2/3 J`` per bond of the reference library.
"""

from __future__ import annotations

import numpy as np

from .lattice import Chain
from .model import CouplingMPOModel, NearestNeighborModel
from ..networks.site import SpinSite

__all__ = ['AKLTChain']


class AKLTChain(CouplingMPOModel, NearestNeighborModel):
    """The AKLT spin-1 chain (its ground state an MPS of bond dimension 2).
    Options: ``J`` (1.), ``conserve`` ('Sz'), and the lattice options of
    :class:`~tenpy_tpu_torch.models.model.CouplingMPOModel`."""

    default_lattice = Chain
    force_default_lattice = True

    def init_sites(self, model_params):
        return SpinSite(S=1., conserve=model_params.get('conserve', 'Sz'))

    def init_terms(self, model_params):
        J = model_params.get('J', 1., 'real_or_array')
        for u1, u2, dx in self.lat.pairs['nearest_neighbors']:
            self.add_coupling(J / 2., u1, 'Sp', u2, 'Sm', dx, plus_hc=True)
            self.add_coupling(J, u1, 'Sz', u2, 'Sz', dx)
        # (S.S)^2 with S.S = Sz Sz + (Sp Sm + Sm Sp) / 2: every product of
        # two of its three terms
        ops = [('Sz', 'Sz', 1.), ('Sp', 'Sm', 0.5), ('Sm', 'Sp', 0.5)]
        J3 = np.asarray(J) / 3.
        for u1, u2, dx in self.lat.pairs['nearest_neighbors']:
            for a1, b1, c1 in ops:
                for a2, b2, c2 in ops:
                    self.add_coupling(
                        J3 * c1 * c2,
                        u1, self.lat.unit_cell[u1].multiply_op_names([a1, a2]),
                        u2, self.lat.unit_cell[u2].multiply_op_names([b1, b2]),
                        dx)
