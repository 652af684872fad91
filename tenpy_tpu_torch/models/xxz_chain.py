r"""The spin-1/2 XXZ chain.

Port of ``XXZChain`` and ``XXZChain2`` from
``tenpy_tpu/models/xxz_chain.py``:
``H = Jxx/2 (Sp Sm + Sm Sp) + Jz Sz Sz - hz Sz``, with Sz conserved.
"""

from __future__ import annotations

from .lattice import Chain
from .model import CouplingMPOModel, NearestNeighborModel
from ..networks.site import SpinHalfSite

__all__ = ['XXZChain', 'XXZChain2']


class XXZChain(CouplingMPOModel, NearestNeighborModel):
    r"""The XXZ chain with Sz conservation.

    Options: ``Jxx`` (1.), ``Jz`` (1.), ``hz`` (0.), ``sort_charge``
    (True: the site's basis sorted by charge, 'down' first), ``L``,
    ``bc_MPS``.
    """

    default_lattice = Chain
    force_default_lattice = True

    def init_sites(self, model_params):
        sort_charge = model_params.get('sort_charge', True, bool)
        return SpinHalfSite(conserve='Sz', sort_charge=sort_charge)

    def init_terms(self, model_params):
        Jxx = model_params.get('Jxx', 1., 'real_or_array')
        Jz = model_params.get('Jz', 1., 'real_or_array')
        hz = model_params.get('hz', 0., 'real_or_array')
        self.add_onsite(-hz, 0, 'Sz')
        for u1, u2, dx in self.lat.pairs['nearest_neighbors']:
            self.add_coupling(Jxx * 0.5, u1, 'Sp', u2, 'Sm', dx, plus_hc=True)
            self.add_coupling(Jz, u1, 'Sz', u2, 'Sz', dx)


class XXZChain2(XXZChain):
    """The same Hamiltonian as :class:`XXZChain` (TeNPy builds it through
    its generic spin model; ``tenpy_tpu`` and the port keep it as an
    alias)."""
