r"""Kitaev's toric code.

Port of ``DualSquare`` and ``ToricCode`` from
``tenpy_tpu/models/toric_code.py``: spins on the bonds of a square
lattice, ``H = -Jv sum_v A_v - Jp sum_p B_p`` with the star
``A_v = prod sigma^x`` and the plaquette ``B_p = prod sigma^z``, each a
four-site multi-coupling.
"""

from __future__ import annotations

import numpy as np

from .lattice import Lattice
from .model import CouplingMPOModel
from ..networks.site import SpinHalfSite

__all__ = ['DualSquare', 'ToricCode']


class DualSquare(Lattice):
    """The bonds of a square lattice as sites (unit cell: the horizontal
    and the vertical edge)."""

    dim = 2

    def __init__(self, Lx, Ly, site, **kwargs):
        kwargs.setdefault('positions', np.array([[0.5, 0.], [0., 0.5]]))
        super().__init__([Lx, Ly], [site, site], **kwargs)


class ToricCode(CouplingMPOModel):
    """The toric code.  Options: ``Jv`` (1.), ``Jp`` (1.), ``conserve``
    ('parity'), and the lattice options of
    :class:`~tenpy_tpu_torch.models.model.CouplingMPOModel`."""

    default_lattice = DualSquare
    force_default_lattice = True

    def init_sites(self, model_params):
        return SpinHalfSite(conserve=model_params.get('conserve', 'parity'))

    def init_terms(self, model_params):
        Jv = model_params.get('Jv', 1., 'real_or_array')
        Jp = model_params.get('Jp', 1., 'real_or_array')
        self.add_multi_coupling(-np.asarray(Jv), [
            ('Sigmax', [0, 0], 0), ('Sigmax', [0, 0], 1),
            ('Sigmax', [-1, 0], 0), ('Sigmax', [0, -1], 1)])
        self.add_multi_coupling(-np.asarray(Jp), [
            ('Sigmaz', [0, 0], 0), ('Sigmaz', [1, 0], 1),
            ('Sigmaz', [0, 1], 0), ('Sigmaz', [0, 0], 1)])
