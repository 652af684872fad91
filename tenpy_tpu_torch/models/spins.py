r"""General spin-S models.

Port of ``SpinModel``, ``SpinChain`` and ``DipolarSpinChain`` from
``tenpy_tpu/models/spins.py``: the same terms, added in the same order,
give the same MPO and bond Hamiltonians.
"""

from __future__ import annotations

import numpy as np

from .lattice import Chain
from .model import CouplingMPOModel, NearestNeighborModel
from ..networks.site import SpinSite

__all__ = ['SpinModel', 'SpinChain', 'DipolarSpinChain']


class SpinModel(CouplingMPOModel):
    r"""Anisotropic spin-S model on a lattice:
    ``H = sum Jx Sx Sx + Jy Sy Sy + Jz Sz Sz - hx Sx - hy Sy - hz Sz
    + D Sz^2 + E (Sx^2 - Sy^2)``.

    Options: ``S`` (0.5), ``conserve`` ('best': 'Sz' where the terms allow
    it, else 'parity'), ``Jx, Jy, Jz`` (1.), ``hx, hy, hz`` (0.),
    ``D, E`` (0.), and the lattice options of
    :class:`~tenpy_tpu_torch.models.model.CouplingMPOModel`.
    """

    def init_sites(self, model_params):
        S = model_params.get('S', 0.5)
        conserve = model_params.get('conserve', 'best')
        if conserve == 'best':
            Jx = model_params.silent_get('Jx', 1.)
            Jy = model_params.silent_get('Jy', 1.)
            hx = model_params.silent_get('hx', 0.)
            hy = model_params.silent_get('hy', 0.)
            E = model_params.silent_get('E', 0.)
            if np.allclose(Jx, Jy) and np.all(np.asarray(hx) == 0.) and \
                    np.all(np.asarray(hy) == 0.) and \
                    np.all(np.asarray(E) == 0.):
                conserve = 'Sz'
            else:
                conserve = 'parity'
        return SpinSite(S=S, conserve=conserve)

    def init_terms(self, model_params):
        Jx = model_params.get('Jx', 1., 'real_or_array')
        Jy = model_params.get('Jy', 1., 'real_or_array')
        Jz = model_params.get('Jz', 1., 'real_or_array')
        hx = model_params.get('hx', 0., 'real_or_array')
        hy = model_params.get('hy', 0., 'real_or_array')
        hz = model_params.get('hz', 0., 'real_or_array')
        D = model_params.get('D', 0., 'real_or_array')
        E = model_params.get('E', 0., 'real_or_array')
        for u in range(len(self.lat.unit_cell)):
            if np.any(np.asarray(hx) != 0.):
                self.add_onsite(-hx, u, 'Sx')
            if np.any(np.asarray(hy) != 0.):
                self.add_onsite(-hy, u, 'Sy')
            self.add_onsite(-hz, u, 'Sz')
            if np.any(np.asarray(D) != 0.):
                self.add_onsite(D, u, 'Sz Sz')
            if np.any(np.asarray(E) != 0.):
                # E (Sx^2 - Sy^2) = E/2 (Sp Sp + Sm Sm)
                self.add_onsite(0.5 * np.asarray(E), u, 'Sp Sp')
                self.add_onsite(0.5 * np.asarray(E), u, 'Sm Sm')
        # Jx Sx Sx + Jy Sy Sy = (Jx+Jy)/4 (Sp Sm + Sm Sp)
        #                       + (Jx-Jy)/4 (Sp Sp + Sm Sm)
        Jx = np.asarray(Jx)
        Jy = np.asarray(Jy)
        for u1, u2, dx in self.lat.pairs['nearest_neighbors']:
            self.add_coupling((Jx + Jy) / 4., u1, 'Sp', u2, 'Sm', dx,
                              plus_hc=True)
            if np.any((Jx - Jy) != 0.):
                self.add_coupling((Jx - Jy) / 4., u1, 'Sp', u2, 'Sp', dx,
                                  plus_hc=True)
            self.add_coupling(Jz, u1, 'Sz', u2, 'Sz', dx)


class SpinChain(SpinModel, NearestNeighborModel):
    """The spin-S model on a chain (with ``H_bond``)."""

    default_lattice = Chain
    force_default_lattice = True


class DipolarSpinChain(CouplingMPOModel):
    r"""The dipole-conserving spin-S chain:
    ``H = -J3 sum_i (S^+_i (S^-_{i+1})^2 S^+_{i+2} + h.c.)
    - J4 sum_i (S^+_i S^-_{i+1} S^-_{i+2} S^+_{i+3} + h.c.)``.

    Both terms conserve the total Sz and its dipole moment
    ``sum_i i Sz_i``; ``conserve='dipole'`` (the default, 'best') makes
    both charges of the sites.  Options: ``L`` (64), ``S`` (1),
    ``conserve``, ``J3`` (1.), ``J4`` (0.), ``bc_MPS`` ('finite'; infinite
    bc with dipole conservation raises, as in ``tenpy_tpu``), ``bc``.
    """

    def init_lattice(self, model_params):
        L = model_params.get('L', 64)
        S = model_params.get('S', 1)
        conserve = model_params.get('conserve', 'best')
        if conserve == 'best':
            conserve = 'dipole'
        bc_MPS = model_params.get('bc_MPS', 'finite')
        bc = model_params.get('bc', 'periodic' if bc_MPS in (
            'infinite', 'segment') else 'open')
        return Chain(L, SpinSite(S=S, conserve=conserve), bc=bc,
                     bc_MPS=bc_MPS)

    def init_terms(self, model_params):
        J3 = model_params.get('J3', 1., 'real_or_array')
        J4 = model_params.get('J4', 0., 'real_or_array')
        self.add_multi_coupling(
            -J3, [('Sp', 0, 0), ('Sm', 1, 0), ('Sm', 1, 0), ('Sp', 2, 0)],
            plus_hc=True)
        if np.any(np.asarray(J4) != 0.):
            self.add_multi_coupling(
                -J4, [('Sp', 0, 0), ('Sm', 1, 0), ('Sm', 2, 0),
                      ('Sp', 3, 0)], plus_hc=True)
