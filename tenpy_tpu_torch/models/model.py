r"""Model base classes and the coupling DSL.

Port of ``Model``, ``NearestNeighborModel`` (its ``calc_H_bond``),
``MPOModel``, ``CouplingModel`` and ``CouplingMPOModel`` from
``tenpy_tpu/models/model.py``, for models built from on-site terms and
two-site couplings.  A model is a lattice plus Hamiltonian terms, compiled
to an MPO through :class:`~tenpy_tpu_torch.networks.mpo.MPOGraph`.
Multi-site couplings, exponentially decaying couplings and the external
flux helpers are not ported.
"""

from __future__ import annotations

import copy

import numpy as np

from .lattice import Lattice, get_lattice, Chain
from ..linalg import np_conserved as npc
from ..networks import mpo
from ..networks.terms import OnsiteTerms, CouplingTerms, order_combine_term
from ..tools.misc import to_array
from ..tools.params import asConfig

__all__ = ['Model', 'NearestNeighborModel', 'MPOModel', 'CouplingModel',
           'CouplingMPOModel']


class Model:
    """Base class for models: a lattice plus a Hamiltonian."""

    def __init__(self, lattice):
        self.lat = lattice

    def copy(self):
        return copy.copy(self)

    def update_time_parameter(self, new_time):
        """The model re-built from its options with ``time`` set to
        ``new_time`` (for a Hamiltonian that depends on time)."""
        options = self.options.as_dict() if hasattr(self, 'options') else {}
        options['time'] = new_time
        return self.__class__(options)

    def extract_segment(self, first=0, last=None, enlarge=None):
        """A shallow copy on the segment of
        :meth:`~tenpy_tpu_torch.models.lattice.Lattice.extract_segment`
        (subclasses cut their Hamiltonian to it)."""
        cp = self.copy()
        cp.lat = self.lat.extract_segment(first, last, enlarge)
        return cp


class NearestNeighborModel(Model):
    """Model with ``H_bond``: ``H_bond[i]`` acts on sites ``(i-1, i)``."""

    def __init__(self, lattice, H_bond):
        Model.__init__(self, lattice)
        self.H_bond = list(H_bond)

    def extract_segment(self, first=0, last=None, enlarge=None):
        cp = super().extract_segment(first, last, enlarge)
        first, last = cp.lat.segment_first_last
        L = len(self.H_bond)
        cp.H_bond = [self.H_bond[i % L] for i in range(first, last + 1)]
        return cp

    def bond_energies(self, psi):
        """``<psi|H_bond[i]|psi>`` per bond (the L-1 inner bonds for
        finite bc, all L for infinite bc)."""
        E = []
        L = psi.L
        for i in (range(1, L) if psi.finite else range(L)):
            h = self.H_bond[i % L]
            if h is None:
                E.append(0.)
                continue
            theta = psi.get_theta(i - 1, 2)
            h_th = npc.tensordot(h, theta, axes=[['p0*', 'p1*'],
                                                 ['p0', 'p1']])
            val = npc.tensordot(theta.conj(), h_th,
                                axes=[['vL*', 'p0*', 'p1*', 'vR*'],
                                      ['vL', 'p0', 'p1', 'vR']])
            E.append(float(np.real(complex(val))))
        return np.array(E)


class MPOModel(Model):
    """Model with an MPO Hamiltonian ``H_MPO``."""

    def __init__(self, lattice, H_MPO):
        Model.__init__(self, lattice)
        self.H_MPO = H_MPO

    def extract_segment(self, first=0, last=None, enlarge=None):
        cp = super().extract_segment(first, last, enlarge)
        first, last = cp.lat.segment_first_last
        cp.H_MPO = self.H_MPO.extract_segment(first, last)
        return cp


class CouplingModel(Model):
    """The term DSL: :meth:`add_onsite`, :meth:`add_coupling`."""

    def __init__(self, lattice, explicit_plus_hc=False):
        Model.__init__(self, lattice)
        self.explicit_plus_hc = explicit_plus_hc
        self.onsite_terms = {}       # category -> OnsiteTerms
        self.coupling_terms = {}     # category -> CouplingTerms

    def _get_onsite(self, category):
        if category not in self.onsite_terms:
            self.onsite_terms[category] = OnsiteTerms(self.lat.N_sites)
        return self.onsite_terms[category]

    def _get_coupling(self, category):
        if category not in self.coupling_terms:
            self.coupling_terms[category] = CouplingTerms(self.lat.N_sites)
        return self.coupling_terms[category]

    def all_onsite_terms(self):
        total = OnsiteTerms(self.lat.N_sites)
        for ot in self.onsite_terms.values():
            total += ot
        return total

    def all_coupling_terms(self):
        total = CouplingTerms(self.lat.N_sites)
        for ct in self.coupling_terms.values():
            total += ct
        return total

    def add_onsite(self, strength, u, opname, category=None, plus_hc=False):
        r"""Add ``sum_x strength[x] * opname`` on every site of unit-cell
        index ``u``."""
        if self.explicit_plus_hc:
            if plus_hc:
                plus_hc = False   # the MPO adds the h.c. implicitly
            else:
                strength = strength / 2.
        strength = to_array(strength, self.lat.Ls)
        if not np.any(strength != 0.):
            return
        category = category or f"{opname}_{u}"
        ot = self._get_onsite(category)
        idx, lat_idx = self.lat.mps_lat_idx_fix_u(u)
        site = self.lat.unit_cell[u]
        if not site.valid_opname(opname):
            raise ValueError(f"unknown onsite op {opname!r}")
        for i, lat in zip(idx, lat_idx):
            ot.add_onsite_term(strength[tuple(lat)], int(i), opname)
        if plus_hc:
            hc = site.get_hc_op_name(opname)
            if hc != opname:
                self.add_onsite(np.conj(strength), u, hc,
                                category=category + '_hc')
            else:
                for i, lat in zip(idx, lat_idx):
                    ot.add_onsite_term(np.conj(strength[tuple(lat)]), int(i),
                                       opname)

    def add_coupling(self, strength, u1, op1, u2, op2, dx, op_string=None,
                     category=None, plus_hc=False):
        r"""Add ``sum_x strength[x] op1_{u1,x} op2_{u2,x+dx}``.

        Jordan-Wigner strings are inserted when both operators are
        fermionic; ``plus_hc`` adds the hermitian conjugate couplings."""
        if self.explicit_plus_hc:
            if plus_hc:
                plus_hc = False
            else:
                strength = np.asarray(strength) / 2.
        dx = np.atleast_1d(np.asarray(dx, int))
        if len(dx) < self.lat.dim:
            dx = np.concatenate([dx, np.zeros(self.lat.dim - len(dx), int)])
        mps_i, mps_j, lat_idx, coupling_shape = \
            self.lat.possible_couplings(u1, u2, dx)
        if min(coupling_shape) == 0:
            return   # no coupling fits (dx beyond an open boundary)
        strength = to_array(strength, coupling_shape)
        category = category or f"{op1}_{u1}-{op2}_{u2}-{tuple(dx)}"
        sites = self.lat.mps_sites()
        ct = self._get_coupling(category)
        for i, j, lat in zip(mps_i, mps_j, lat_idx):
            s = strength[tuple(lat)]
            if s == 0.:
                continue
            term, sign = order_combine_term([(op1, int(i)), (op2, int(j))],
                                            sites)
            if len(term) == 1:
                self._get_onsite(category).add_onsite_term(
                    s * sign, term[0][1], term[0][0])
                continue
            i0 = term[0][1]
            if not 0 <= i0 < self.lat.N_sites:   # infinite bc: into the cell
                shift = (i0 % self.lat.N_sites) - i0
                term = [(op, x + shift) for op, x in term]
            ct.add_coupling_term(*ct.coupling_term_handle_JW(
                s * sign, term, sites, op_string))
        if plus_hc:
            hc1 = self.lat.unit_cell[u1].get_hc_op_name(op1)
            hc2 = self.lat.unit_cell[u2].get_hc_op_name(op2)
            self.add_coupling(np.conj(strength), u2, hc2, u1, hc1, -dx,
                              op_string=op_string, category=category + '_hc')

    def calc_H_MPO(self, tol_zero=1e-15):
        """Compile all terms to an MPO."""
        ot = self.all_onsite_terms()
        ct = self.all_coupling_terms()
        ot.remove_zeros(tol_zero)
        ct.remove_zeros(tol_zero)
        sites = self.lat.mps_sites()
        bc = 'infinite' if self.lat.bc_MPS == 'infinite' else 'finite'
        H = mpo.MPOGraph.from_terms([ot, ct], sites, bc).build_MPO()
        H.max_range = max(ot.max_range(), ct.max_range())
        H.explicit_plus_hc = self.explicit_plus_hc
        return H

    def calc_H_bond(self, tol_zero=1e-15):
        """Bond operators ``H_bond[i]`` on sites ``(i-1, i)`` (nearest
        neighbour couplings only)."""
        if self.explicit_plus_hc:
            raise NotImplementedError("calc_H_bond with explicit_plus_hc is "
                                      "not ported")
        sites = self.lat.mps_sites()
        ct = self.all_coupling_terms()
        ct.remove_zeros(tol_zero)
        ot = self.all_onsite_terms()
        ot.remove_zeros(tol_zero)
        H_bond = ct.to_nn_bond_Arrays(sites)
        return ot.add_to_nn_bond_Arrays(H_bond, sites,
                                        self.lat.bc_MPS == 'finite')


class CouplingMPOModel(CouplingModel, MPOModel):
    """Template: init_lattice -> init_sites -> init_terms -> H_MPO.

    Subclasses override :meth:`init_sites` and :meth:`init_terms`.
    Options: ``lattice`` (name or class), ``bc_MPS``, ``bc_x``/``bc_y``,
    ``L``/``Lx``/``Ly``, ``order``, ``explicit_plus_hc``.
    """

    default_lattice = Chain
    force_default_lattice = False

    def __init__(self, model_params):
        self.name = self.__class__.__name__
        self.options = model_params = asConfig(model_params, self.name)
        self.explicit_plus_hc = model_params.get('explicit_plus_hc', False,
                                                 bool)
        lat = self.init_lattice(model_params)
        CouplingModel.__init__(self, lat, self.explicit_plus_hc)
        self.init_terms(model_params)
        self.init_H_from_terms()

    def init_H_from_terms(self):
        """Compile the terms into ``H_MPO`` (and ``H_bond`` for a
        :class:`NearestNeighborModel`)."""
        if self.options.get('sort_mpo_legs', False, bool):
            raise NotImplementedError("sort_mpo_legs is not ported")
        MPOModel.__init__(self, self.lat, self.calc_H_MPO())
        if isinstance(self, NearestNeighborModel):
            self.H_bond = self.calc_H_bond()

    def init_lattice(self, model_params):
        """The lattice from the options."""
        lat = model_params.get('lattice', self.default_lattice)
        if isinstance(lat, Lattice):
            return lat
        if isinstance(lat, str):
            lat = get_lattice(lat)
        bc_MPS = model_params.get('bc_MPS', 'finite', str)
        sites = self.init_sites(model_params)
        bc_x = model_params.get('bc_x', 'periodic' if bc_MPS == 'infinite'
                                else 'open', str)
        dim = getattr(lat, 'dim', 1)
        if dim == 1:
            args = (model_params.get('L', 2, int), sites)
            bc = [bc_x]
        elif dim == 2:
            args = (model_params.get('Lx', 2, int),
                    model_params.get('Ly', 2, int), sites)
            bc_y = model_params.get('bc_y', 'cylinder', str)
            bc = [bc_x, 'periodic' if bc_y == 'cylinder' else 'open']
        else:
            raise ValueError("unsupported lattice dimension")
        return lat(*args, bc=bc, bc_MPS=bc_MPS,
                   order=model_params.get('order', 'default', str))

    def init_sites(self, model_params):
        """The local Hilbert space (override in subclasses)."""
        raise NotImplementedError("subclass must implement init_sites")

    def init_terms(self, model_params):
        """Add the Hamiltonian terms (override in subclasses)."""
