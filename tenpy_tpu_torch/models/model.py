r"""Model base classes and the coupling DSL.

Port of ``Model``, ``NearestNeighborModel`` (its ``calc_H_bond``),
``MPOModel``, ``CouplingModel`` and ``CouplingMPOModel`` from
``tenpy_tpu/models/model.py``: on-site terms, two-site and multi-site
couplings, exponentially decaying couplings, local terms given by
lattice indices, the external-flux phases of coupling strengths,
``explicit_plus_hc``, ``sort_mpo_legs`` and the conversions between
``H_bond`` and ``H_MPO`` (``NearestNeighborModel.from_MPOModel`` and
``calc_H_MPO_from_bond``, ``MPOModel.calc_H_bond_from_MPO``).  A model is
a lattice plus Hamiltonian terms, compiled to an MPO through
:class:`~tenpy_tpu_torch.networks.mpo.MPOGraph`.
"""

from __future__ import annotations

import copy

import numpy as np

from .lattice import Lattice, MultiSpeciesLattice, get_lattice, Chain
from ..linalg import np_conserved as npc
from ..networks import mpo
from ..networks.terms import (OnsiteTerms, CouplingTerms, MultiCouplingTerms,
                              ExponentiallyDecayingTerms, order_combine_term)
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

    @classmethod
    def from_MPOModel(cls, mpo_model):
        """The model with the bond terms of a nearest-neighbour MPO
        (:meth:`MPOModel.calc_H_bond_from_MPO`)."""
        return cls(mpo_model.lat, mpo_model.calc_H_bond_from_MPO())

    def calc_H_MPO_from_bond(self, tol_zero=1e-15):
        """An MPO of the bond terms: each ``H_bond[i]`` split by an SVD into
        a sum of products of one-site operators, one MPO bond state per
        singular value above ``tol_zero`` (relative)."""
        sites = self.lat.mps_sites()
        L = len(sites)
        graph = mpo.MPOGraph(sites, 'finite' if self.lat.bc_MPS in (
            'finite', 'segment') else 'infinite')
        for i, h in enumerate(self.H_bond):
            if h is None:
                continue
            i0 = (i - 1) % L
            h2 = h.combine_legs([['p0', 'p0*'], ['p1', 'p1*']],
                                qconj=[+1, -1])
            U, S, VH = npc.svd(h2, inner_labels=['vR', 'vL'])
            S = np.asarray(S)
            for k in np.nonzero(S > tol_zero * max(S.max(), 1e-300))[0]:
                mask = np.zeros(len(S), bool)
                mask[k] = True
                u_k = U.copy(deep=False).iproject([mask], [1]).squeeze([1])
                v_k = VH.copy(deep=False).iproject([mask], [0]).squeeze([0])
                opL = u_k.split_legs([0]).iset_leg_labels(['p', 'p*']) * S[k]
                opR = v_k.split_legs([0]).iset_leg_labels(['p', 'p*'])
                key = ('bond', i, int(k))
                graph.add(i0, 'IdL', key, opL, 1., check_op=False)
                graph.add(i0 + 1, key, 'IdR', opR, 1., check_op=False)
        graph.add_missing_IdL_IdR()
        return graph.build_MPO()

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

    def calc_H_bond_from_MPO(self, tol_zero=1e-15):
        """The nearest-neighbour bond terms of ``H_MPO`` (``max_range`` at
        most 1): the coupling channels through the bond states other than
        IdL and IdR, and each on-site term (``W[IdL, IdR]``) half on each
        adjacent bond (whole at the ends of a finite chain)."""
        H = self.H_MPO
        L = H.L
        sites = self.lat.mps_sites()
        finite = H.finite
        H_bond = [None] * L
        for i1 in range(1 if finite else 0, L):
            i0 = (i1 - 1) % L
            W0 = H.get_W(i0).transpose(['wL', 'wR', 'p', 'p*']).to_numpy()
            W1 = H.get_W(i1).transpose(['wL', 'wR', 'p', 'p*']).to_numpy()
            IdL0, IdR0 = H.get_IdL(i0), H.get_IdR(i0)
            IdL_mid, IdR1 = H.get_IdL(i1), H.get_IdR(i1)
            d0, d1 = W0.shape[2], W1.shape[3]
            h = np.zeros((d0, d0, d1, d1), dtype=np.result_type(W0, W1))
            for a in range(W0.shape[1]):
                if a in (IdR0, IdL_mid):
                    continue
                h += np.einsum('pq,rs->pqrs', W0[IdL0, a], W1[a, IdR1])
            w0 = 1. if (finite and i0 == 0) else 0.5
            w1 = 1. if (finite and i1 == L - 1) else 0.5
            h += w0 * np.einsum('pq,rs->pqrs', W0[IdL0, IdR0], np.eye(d1))
            h += w1 * np.einsum('pq,rs->pqrs', np.eye(d0), W1[IdL_mid, IdR1])
            legs = [sites[i0].leg, sites[i0].leg.conj(), sites[i1].leg,
                    sites[i1].leg.conj()]
            H_bond[i1] = npc.Array.from_ndarray(
                h, legs, labels=['p0', 'p0*', 'p1', 'p1*'],
                warn_wrong_sector=False)
        return H_bond


class CouplingModel(Model):
    """The term DSL: :meth:`add_onsite`, :meth:`add_coupling`,
    :meth:`add_multi_coupling`, :meth:`add_exponentially_decaying_coupling`,
    :meth:`add_local_term` and their single-term forms."""

    def __init__(self, lattice, explicit_plus_hc=False):
        Model.__init__(self, lattice)
        self.explicit_plus_hc = explicit_plus_hc
        self.onsite_terms = {}       # category -> OnsiteTerms
        self.coupling_terms = {}     # category -> (Multi)CouplingTerms
        self.exp_decaying_terms = ExponentiallyDecayingTerms(
            lattice.N_sites)

    def _get_onsite(self, category):
        if category not in self.onsite_terms:
            self.onsite_terms[category] = OnsiteTerms(self.lat.N_sites)
        return self.onsite_terms[category]

    def _get_coupling(self, category, multi=False):
        ct = self.coupling_terms.get(category)
        if ct is None:
            cls = MultiCouplingTerms if multi else CouplingTerms
            ct = self.coupling_terms[category] = cls(self.lat.N_sites)
        elif multi and not isinstance(ct, MultiCouplingTerms):
            new = MultiCouplingTerms(self.lat.N_sites)
            new += ct
            ct = self.coupling_terms[category] = new
        return ct

    def all_onsite_terms(self):
        total = OnsiteTerms(self.lat.N_sites)
        for ot in self.onsite_terms.values():
            total += ot
        return total

    def all_coupling_terms(self):
        multi = any(isinstance(ct, MultiCouplingTerms)
                    for ct in self.coupling_terms.values())
        total = (MultiCouplingTerms if multi else CouplingTerms)(
            self.lat.N_sites)
        for ct in self.coupling_terms.values():
            total += ct
        return total

    def _halve_for_hc(self, strength, plus_hc):
        """With ``explicit_plus_hc`` the MPO adds the h.c. of every term:
        ``(strength / 2, False)`` for a term without ``plus_hc`` (so that it
        is not counted twice), ``(strength, False)`` for one with it."""
        if not self.explicit_plus_hc:
            return strength, plus_hc
        return (strength, False) if plus_hc else \
            (np.asarray(strength) / 2., False)

    def add_onsite(self, strength, u, opname, category=None, plus_hc=False):
        r"""Add ``sum_x strength[x] * opname`` on every site of unit-cell
        index ``u``."""
        strength, plus_hc = self._halve_for_hc(strength, plus_hc)
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
        strength, plus_hc = self._halve_for_hc(strength, plus_hc)
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

    def add_onsite_term(self, strength, i, op, category=None,
                        plus_hc=False):
        """Add ``strength * op`` on MPS site ``i``."""
        strength, plus_hc = self._halve_for_hc(strength, plus_hc)
        ot = self._get_onsite(category or op)
        ot.add_onsite_term(strength, i, op)
        if plus_hc:
            ot.add_onsite_term(np.conj(strength), i,
                               self.lat.mps_sites()[i].get_hc_op_name(op))

    def add_coupling_term(self, strength, i, j, op_i, op_j, op_string='Id',
                          category=None, plus_hc=False):
        """Add ``strength * op_i_i op_string ... op_j_j`` on MPS sites
        ``i < j`` (no Jordan-Wigner strings inserted)."""
        strength, plus_hc = self._halve_for_hc(strength, plus_hc)
        ct = self._get_coupling(category or f"{op_i}_i {op_j}_j")
        ct.add_coupling_term(strength, i, j, op_i, op_j, op_string)
        if plus_hc:
            sites = self.lat.mps_sites()
            ct.add_coupling_term(
                np.conj(strength), i, j,
                sites[i % len(sites)].get_hc_op_name(op_i),
                sites[j % len(sites)].get_hc_op_name(op_j), op_string)

    def add_multi_coupling(self, strength, ops, category=None,
                           plus_hc=False):
        r"""Add ``sum_x strength[x] prod_k op_k`` with ``ops = [(opname,
        dx, u), ...]``: each operator on unit-cell index ``u`` at offset
        ``dx``; the Jordan-Wigner strings of fermionic operators are
        inserted."""
        strength, plus_hc = self._halve_for_hc(strength, plus_hc)
        ops = [(op, np.concatenate([
            np.atleast_1d(np.asarray(dx, int)),
            np.zeros(self.lat.dim - len(np.atleast_1d(dx)), int)]), u)
            for op, dx, u in ops]
        mps_ijkl, lat_idx, coupling_shape = \
            self.lat.possible_multi_couplings(ops)
        if min(coupling_shape) == 0:
            return   # no coupling fits (dx beyond an open boundary)
        strength = to_array(strength, coupling_shape)
        category = category or 'multi_' + '_'.join(op for op, _, _ in ops)
        sites = self.lat.mps_sites()
        ct = self._get_coupling(category, multi=True)
        opnames = [op for op, _, _ in ops]
        for ijkl, lat in zip(mps_ijkl, lat_idx):
            s = strength[tuple(lat)]
            if s == 0.:
                continue
            term, sign = order_combine_term(
                list(zip(opnames, (int(x) for x in ijkl))), sites)
            i0 = term[0][1]
            if not 0 <= i0 < self.lat.N_sites:
                shift = (i0 % self.lat.N_sites) - i0
                term = [(op, x + shift) for op, x in term]
            if len(term) == 1:
                self._get_onsite(category).add_onsite_term(
                    s * sign, term[0][1], term[0][0])
            elif len(term) == 2:
                ct.add_coupling_term(*ct.coupling_term_handle_JW(
                    s * sign, term, sites))
            else:
                ct.add_multi_coupling_term(*ct.multi_coupling_term_handle_JW(
                    s * sign, term, sites))
        if plus_hc:
            hc_ops = [(self.lat.unit_cell[u].get_hc_op_name(op), dx, u)
                      for op, dx, u in reversed(ops)]
            self.add_multi_coupling(np.conj(strength), hc_ops,
                                    category=category + '_hc')

    def add_multi_coupling_term(self, strength, ijkl, ops_ijkl,
                                op_string='Id', category=None,
                                plus_hc=False):
        """Add ``strength * prod_k ops_ijkl[k]`` on the ascending MPS sites
        ``ijkl`` (no Jordan-Wigner strings inserted)."""
        ct = self._get_coupling(category or 'multi_' + '_'.join(ops_ijkl),
                                multi=True)
        ct.add_multi_coupling_term(strength, ijkl, ops_ijkl, op_string)
        if plus_hc:
            sites = self.lat.mps_sites()
            ct.add_multi_coupling_term(
                np.conj(strength), ijkl,
                [sites[i % len(sites)].get_hc_op_name(op)
                 for op, i in zip(ops_ijkl, ijkl)], op_string)

    def add_exponentially_decaying_coupling(self, strength, lambda_, op_i,
                                            op_j, subsites=None,
                                            subsites_start=None,
                                            op_string=None, plus_hc=False):
        r"""Add ``strength sum_{i<j} lambda_^{j-i} op_i op_j`` over the MPS
        sites ``subsites`` (``i`` in ``subsites_start``), one MPO bond
        state per term; fermionic operators get the ``JW`` string."""
        sites = self.lat.mps_sites()
        if op_string is None:
            need_i = sites[0].op_needs_JW(op_i)
            need_j = sites[0].op_needs_JW(op_j)
            if need_i and need_j:
                op_string = 'JW'
                op_i = sites[0].multiply_op_names([op_i, 'JW'])
            elif need_i or need_j:
                raise ValueError("only one op needs JW?")
            else:
                op_string = 'Id'
        edt = self.exp_decaying_terms
        edt.add_exponentially_decaying_coupling(
            strength, lambda_, op_i, op_j, subsites, subsites_start,
            op_string)
        if plus_hc:
            edt.add_exponentially_decaying_coupling(
                np.conj(strength), np.conj(lambda_),
                sites[0].get_hc_op_name(op_i), sites[0].get_hc_op_name(op_j),
                subsites, subsites_start, op_string)

    def add_local_term(self, strength, term, category=None, plus_hc=False):
        """Add one term ``[(op, lat_idx), ...]`` given by lattice
        indices."""
        sites = self.lat.mps_sites()
        term, sign = order_combine_term(
            [(op, int(self.lat.lat2mps_idx(idx))) for op, idx in term],
            sites)
        category = category or 'local'
        if len(term) == 1:
            self._get_onsite(category).add_onsite_term(strength * sign,
                                                       term[0][1], term[0][0])
        elif len(term) == 2:
            ct = self._get_coupling(category)
            ct.add_coupling_term(*ct.coupling_term_handle_JW(
                strength * sign, term, sites))
        else:
            ct = self._get_coupling(category, multi=True)
            ct.add_multi_coupling_term(*ct.multi_coupling_term_handle_JW(
                strength * sign, term, sites))

    def coupling_strength_add_ext_flux(self, strength, dx, phase):
        """The coupling strengths of offset ``dx`` with ``exp(i phase[a])``
        on the couplings that wrap around the periodic axis ``a >= 1``."""
        dx = np.asarray(dx, int)
        coupling_shape, _ = self.lat.coupling_shape(dx)
        strength = to_array(strength, coupling_shape).astype(complex)
        for a in range(1, self.lat.dim):
            if self.lat.bc[a] or phase[a] == 0 or dx[a] == 0:
                continue
            La = self.lat.Ls[a]
            idx = [slice(None)] * len(coupling_shape)
            idx[a] = slice(La - dx[a], La) if dx[a] > 0 else slice(0, -dx[a])
            strength[tuple(idx)] = strength[tuple(idx)] * np.exp(1j *
                                                                 phase[a])
        return strength

    def calc_H_MPO(self, tol_zero=1e-15):
        """Compile all terms to an MPO."""
        ot = self.all_onsite_terms()
        ct = self.all_coupling_terms()
        ot.remove_zeros(tol_zero)
        ct.remove_zeros(tol_zero)
        terms = [ot, ct]
        edt = self.exp_decaying_terms
        if not edt.is_empty:
            terms.append(edt)
        sites = self.lat.mps_sites()
        bc = 'infinite' if self.lat.bc_MPS == 'infinite' else 'finite'
        H = mpo.MPOGraph.from_terms(terms, sites, bc).build_MPO()
        H.max_range = max(ot.max_range(), ct.max_range(),
                          0 if edt.is_empty else edt.max_range())
        H.explicit_plus_hc = self.explicit_plus_hc
        return H

    def calc_H_bond(self, tol_zero=1e-15):
        """Bond operators ``H_bond[i]`` on sites ``(i-1, i)`` (nearest
        neighbour couplings only); with ``explicit_plus_hc`` each bond
        operator plus its hermitian conjugate."""
        sites = self.lat.mps_sites()
        ct = self.all_coupling_terms()
        ct.remove_zeros(tol_zero)
        ot = self.all_onsite_terms()
        ot.remove_zeros(tol_zero)
        if not self.exp_decaying_terms.is_empty:
            raise ValueError("exp. decaying terms have no bond "
                             "representation")
        H_bond = ot.add_to_nn_bond_Arrays(ct.to_nn_bond_Arrays(sites), sites,
                                          self.lat.bc_MPS == 'finite')
        if self.explicit_plus_hc:
            for i, h in enumerate(H_bond):
                if h is None:
                    continue
                hd = h.conj().itranspose(['p0', 'p0*', 'p1', 'p1*'])
                hd.iset_leg_labels(['p0*', 'p0', 'p1*', 'p1'])
                hd.itranspose(['p0', 'p0*', 'p1', 'p1*'])
                hd.legs = h.legs
                H_bond[i] = h._binary(hd, lambda a, b: a + b)
        return H_bond


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
        """Compile the terms into ``H_MPO`` (its virtual legs sorted by
        charge with the option ``sort_mpo_legs``) and ``H_bond`` for a
        :class:`NearestNeighborModel`."""
        H_MPO = self.calc_H_MPO()
        if self.options.get('sort_mpo_legs', False, bool):
            H_MPO.sort_legcharges()
        MPOModel.__init__(self, self.lat, H_MPO)
        if isinstance(self, NearestNeighborModel):
            self.H_bond = self.calc_H_bond()

    def init_lattice(self, model_params):
        """The lattice from the options.  Where :meth:`init_sites` returns
        ``(species_sites, species_names)``, a
        :class:`~tenpy_tpu_torch.models.lattice.MultiSpeciesLattice` of
        them on the lattice."""
        lat = model_params.get('lattice', self.default_lattice)
        if isinstance(lat, Lattice):
            return lat
        if isinstance(lat, str):
            lat = get_lattice(lat)
        bc_MPS = model_params.get('bc_MPS', 'finite', str)
        sites = self.init_sites(model_params)
        species = None
        if isinstance(sites, tuple) and len(sites) == 2 and \
                isinstance(sites[1], (list, tuple)) and sites[1] and \
                all(isinstance(n, str) for n in sites[1]):
            species = (list(sites[0]), list(sites[1]))
            sites = species[0][0]
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
        lat = lat(*args, bc=bc, bc_MPS=bc_MPS,
                  order=model_params.get('order', 'default', str))
        if species is not None:
            lat = MultiSpeciesLattice(lat, *species)
        return lat

    def init_sites(self, model_params):
        """The local Hilbert space (override in subclasses)."""
        raise NotImplementedError("subclass must implement init_sites")

    def init_terms(self, model_params):
        """Add the Hamiltonian terms (override in subclasses)."""
