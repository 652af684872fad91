r"""The Hofstadter models: particles on a square lattice in a flux.

Port of ``gauge_hopping``, ``HofstadterFermions`` and ``HofstadterBosons``
from ``tenpy_tpu/models/hofstadter.py``: the same hopping phases, added in
the same order, give the same (complex) MPO.
"""

from __future__ import annotations

import numpy as np

from .lattice import Square
from .model import CouplingMPOModel
from ..networks.site import BosonSite, FermionSite

__all__ = ['gauge_hopping', 'HofstadterFermions', 'HofstadterBosons']


def gauge_hopping(model_params, Lx, Ly):
    """Hopping amplitudes ``(hop_x, hop_y)``, each of shape ``(Lx, Ly)``.

    The flux per plaquette is ``phi = phi_p / phi_q`` (option ``phi``,
    default ``(1, 3)``).  Gauge ``'landau_x'``: the y hoppings carry the
    phase ``exp(2 pi i phi x)``; ``'landau_y'``: the x hoppings carry
    ``exp(-2 pi i phi y)``."""
    gauge = model_params.get('gauge', 'landau_x', str)
    phi_p, phi_q = model_params.get('phi', (1, 3))
    phi = 2. * np.pi * phi_p / phi_q
    Jx = model_params.get('Jx', 1., 'real')
    Jy = model_params.get('Jy', 1., 'real')
    if gauge == 'landau_x':
        x = np.arange(Lx)
        hop_x = -Jx * np.ones((Lx, Ly))
        hop_y = -Jy * np.exp(1.j * phi * x)[:, None] * np.ones((Lx, Ly))
    elif gauge == 'landau_y':
        y = np.arange(Ly)
        hop_x = -Jx * np.exp(-1.j * phi * y)[None, :] * np.ones((Lx, Ly))
        hop_y = -Jy * np.ones((Lx, Ly))
    else:
        raise ValueError(f"unknown gauge {gauge!r}")
    return hop_x, hop_y


class HofstadterFermions(CouplingMPOModel):
    r"""Spinless fermions in a magnetic field:
    ``H = sum (t_{ij} c^dag_i c_j + h.c.) - mu sum n + v sum n_i n_j``.

    Options: ``phi`` ((1, 3)), ``Jx``, ``Jy`` (1.), ``mu``, ``v`` (0.),
    ``conserve`` ('N'), ``gauge`` ('landau_x'), and the lattice options of
    :class:`~tenpy_tpu_torch.models.model.CouplingMPOModel`.
    """

    default_lattice = Square

    def init_sites(self, model_params):
        return FermionSite(conserve=model_params.get('conserve', 'N'))

    def init_terms(self, model_params):
        Lx, Ly = self.lat.Ls
        hop_x, hop_y = gauge_hopping(model_params, Lx, Ly)
        mu = model_params.get('mu', 0., 'real_or_array')
        v = model_params.get('v', 0., 'real_or_array')
        self.add_onsite(-mu, 0, 'N')
        dx_x, dx_y = np.array([1, 0]), np.array([0, 1])
        shape_x, _ = self.lat.coupling_shape(dx_x)
        shape_y, _ = self.lat.coupling_shape(dx_y)
        self.add_coupling(hop_x[:shape_x[0], :shape_x[1]], 0, 'Cd', 0, 'C',
                          dx_x, plus_hc=True)
        self.add_coupling(hop_y[:shape_y[0], :shape_y[1]], 0, 'Cd', 0, 'C',
                          dx_y, plus_hc=True)
        if np.any(np.asarray(v) != 0.):
            self.add_coupling(v, 0, 'N', 0, 'N', dx_x)
            self.add_coupling(v, 0, 'N', 0, 'N', dx_y)


class HofstadterBosons(CouplingMPOModel):
    r"""Bosons in a magnetic field:
    ``H = sum (t_{ij} b^dag_i b_j + h.c.) + U/2 sum n(n-1) - mu sum n``.

    Options: ``Nmax`` (3), ``U`` (0.), and those of
    :class:`HofstadterFermions` but ``v``.
    """

    default_lattice = Square

    def init_sites(self, model_params):
        return BosonSite(Nmax=model_params.get('Nmax', 3, int),
                         conserve=model_params.get('conserve', 'N'))

    def init_terms(self, model_params):
        Lx, Ly = self.lat.Ls
        hop_x, hop_y = gauge_hopping(model_params, Lx, Ly)
        mu = model_params.get('mu', 0., 'real_or_array')
        U = model_params.get('U', 0., 'real_or_array')
        self.add_onsite(-np.asarray(mu) - np.asarray(U) / 2., 0, 'N')
        self.add_onsite(np.asarray(U) / 2., 0, 'NN')
        dx_x, dx_y = np.array([1, 0]), np.array([0, 1])
        shape_x, _ = self.lat.coupling_shape(dx_x)
        shape_y, _ = self.lat.coupling_shape(dx_y)
        self.add_coupling(hop_x[:shape_x[0], :shape_x[1]], 0, 'Bd', 0, 'B',
                          dx_x, plus_hc=True)
        self.add_coupling(hop_y[:shape_y[0], :shape_y[1]], 0, 'Bd', 0, 'B',
                          dx_y, plus_hc=True)
