r"""Spin chains with next-nearest-neighbour couplings.

Port of ``SpinChainNNN2`` (the couplings at distance 1 and 2 of one
chain) and ``SpinChainNNN`` (two sites grouped into one, so that every
coupling is nearest-neighbour) from ``tenpy_tpu/models/spins_nnn.py``.
"""

from __future__ import annotations

import numpy as np

from .lattice import Chain
from .model import CouplingMPOModel, NearestNeighborModel
from ..networks.site import GroupedSite, SpinSite

__all__ = ['SpinChainNNN', 'SpinChainNNN2']


def _couplings(model_params):
    get = model_params.get
    return [np.asarray(get(k, 1., 'real_or_array'))
            for k in ('Jx', 'Jy', 'Jz', 'Jxp', 'Jyp', 'Jzp')]


class SpinChainNNN2(CouplingMPOModel):
    r"""Anisotropic couplings at distance 1 (``Jx, Jy, Jz``) and 2
    (``Jxp, Jyp, Jzp``) on a chain, and a field ``hz``.

    Options: ``S`` (0.5), ``conserve`` ('best': 'Sz' where the couplings
    allow it, else 'parity'), the couplings (1.), ``hz`` (0.), and the
    lattice options of
    :class:`~tenpy_tpu_torch.models.model.CouplingMPOModel`.
    """

    default_lattice = Chain
    force_default_lattice = True

    def init_sites(self, model_params):
        S = model_params.get('S', 0.5)
        conserve = model_params.get('conserve', 'best')
        if conserve == 'best':
            get = model_params.silent_get
            conserve = 'Sz' if (np.allclose(get('Jx', 1.), get('Jy', 1.))
                                and np.allclose(get('Jxp', 1.),
                                                get('Jyp', 1.))) \
                else 'parity'
        return SpinSite(S=S, conserve=conserve)

    def init_terms(self, model_params):
        Jx, Jy, Jz, Jxp, Jyp, Jzp = _couplings(model_params)
        hz = model_params.get('hz', 0., 'real_or_array')
        self.add_onsite(-hz, 0, 'Sz')
        for J_x, J_y, J_z, dx in [(Jx, Jy, Jz, [1]), (Jxp, Jyp, Jzp, [2])]:
            self.add_coupling((J_x + J_y) / 4., 0, 'Sp', 0, 'Sm', dx,
                              plus_hc=True)
            if np.any((J_x - J_y) != 0.):
                self.add_coupling((J_x - J_y) / 4., 0, 'Sp', 0, 'Sp', dx,
                                  plus_hc=True)
            self.add_coupling(J_z, 0, 'Sz', 0, 'Sz', dx)


class SpinChainNNN(SpinChainNNN2, NearestNeighborModel):
    r"""The couplings of :class:`SpinChainNNN2` on a chain of
    :class:`~tenpy_tpu_torch.networks.site.GroupedSite` s of two spins, so
    that every coupling is nearest-neighbour (with ``H_bond``)."""

    def init_sites(self, model_params):
        site = SpinChainNNN2.init_sites(self, model_params)
        return GroupedSite([site, site], charges='same')

    def init_terms(self, model_params):
        Jx, Jy, Jz, Jxp, Jyp, Jzp = _couplings(model_params)
        hz = model_params.get('hz', 0., 'real_or_array')
        self.add_onsite(-hz, 0, 'Sz0')
        self.add_onsite(-hz, 0, 'Sz1')
        # distance 1: subsites 0-1 in a cell and 1-0 across cells;
        # distance 2: equal subsites of neighbouring cells
        for Ja, Jb, Jc, pairs in [
                (Jx, Jy, Jz, [('0', '1', [0]), ('1', '0', [1])]),
                (Jxp, Jyp, Jzp, [('0', '0', [1]), ('1', '1', [1])])]:
            for sa, sb, dx in pairs:
                self.add_coupling((Ja + Jb) / 4., 0, 'Sp' + sa, 0, 'Sm' + sb,
                                  dx, plus_hc=True)
                if np.any((Ja - Jb) != 0.):
                    self.add_coupling((Ja - Jb) / 4., 0, 'Sp' + sa, 0,
                                      'Sp' + sb, dx, plus_hc=True)
                self.add_coupling(Jc, 0, 'Sz' + sa, 0, 'Sz' + sb, dx)
