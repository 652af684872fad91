r"""Matrix product operators: MPO, the MPOGraph compiler, MPO environments.

Port of the part of ``tenpy_tpu/networks/mpo.py`` that the engines' host
side runs: :class:`MPO` with :meth:`MPO.from_grids`,
:meth:`MPO.expectation_value` and :meth:`MPO.variance`, its application to
an MPS (:meth:`MPO.apply`: :meth:`MPO.apply_naively`,
:meth:`MPO.apply_zipup` or variational) and the W_I / W_II approximations
of ``exp(-dt H)`` (:meth:`MPO.make_U`), the :class:`MPOGraph` compiler of a model's
terms, :class:`MPOEnvironment` with ``full_contraction``, and
:class:`MPOTransferMatrix`: the converged infinite-bc environments of
:meth:`MPOTransferMatrix.find_init_LP_RP`, by the channel-wise GMRES
construction of :mod:`~tenpy_tpu_torch.networks.mpo_env_builder`
(``method='auto'``) or by the Arnoldi eigensolver of the transfer matrix
over a :class:`~tenpy_tpu_torch.linalg.sparse.FlatLinearOperator`
(``method='arnoldi'``, and where GMRES does not apply).

Conventions (as in ``tenpy_tpu``): W tensors have labels ``wL, wR, p, p*``
with ``qconj=+1`` (wL) / ``-1`` (wR); ``IdL[b]`` / ``IdR[b]`` index the
"only identities to the left/right" state on bond ``b`` (or None).
"""

from __future__ import annotations

import logging

import numpy as np

from ..linalg import np_conserved as npc
from ..linalg.charges import LegCharge, QTYPE
from ..linalg.sparse import FlatLinearOperator, _np_dtype
from ..linalg.truncation import TruncationError, svd_theta
from .mps import BaseEnvironment

logger = logging.getLogger(__name__)

__all__ = ['MPO', 'MPOGraph', 'MPOEnvironment', 'MPOTransferMatrix',
           'grid_insert_ops']


class MPO:
    """Matrix product operator with IdL/IdR bookkeeping.

    Parameters
    ----------
    sites : list of Site
    Ws : list of Array
        Tensors with labels ``wL, wR, p, p*``.
    bc : 'finite' | 'segment' | 'infinite'
    IdL, IdR : list of {int | None}
        Indices of the IdL/IdR states on each of the L+1 bonds.
    max_range : int | None
    explicit_plus_hc : bool
    """

    _valid_bc = ('finite', 'segment', 'infinite')

    def __init__(self, sites, Ws, bc='finite', IdL=None, IdR=None,
                 max_range=None, explicit_plus_hc=False):
        self.sites = list(sites)
        self.chinfo = self.sites[0].leg.chinfo
        self.dtype = npc.result_type(*[W.dtype for W in Ws])
        self._W = [W.copy(deep=False).itranspose(['wL', 'wR', 'p', 'p*'])
                   for W in Ws]
        self.IdL = self._get_Id(IdL, len(sites))
        self.IdR = self._get_Id(IdR, len(sites))
        self.bc = bc
        self.max_range = max_range
        self.explicit_plus_hc = explicit_plus_hc
        if bc not in self._valid_bc:
            raise ValueError(f"invalid bc {bc!r}")
        self.test_sanity()

    def save_hdf5(self, hdf5_saver, h5gr, subpath):
        """The reference layout (the port groups no sites: ``grouped``
        1)."""
        hdf5_saver.save(self.sites, subpath + 'sites')
        hdf5_saver.save(self.chinfo, subpath + 'chinfo')
        hdf5_saver.save(self._W, subpath + 'tensors')
        hdf5_saver.save(list(self.IdL), subpath + 'index_identity_left')
        hdf5_saver.save(list(self.IdR), subpath + 'index_identity_right')
        hdf5_saver.save(self.bc, subpath + 'boundary_condition')
        hdf5_saver.save(self.max_range, subpath + 'max_range')
        h5gr.attrs['grouped'] = 1
        h5gr.attrs['explicit_plus_hc'] = self.explicit_plus_hc
        h5gr.attrs['L'] = self.L

    @classmethod
    def from_hdf5(cls, hdf5_loader, h5gr, subpath):
        obj = cls.__new__(cls)
        hdf5_loader.memorize_load(h5gr, obj)
        obj.sites = list(hdf5_loader.load(subpath + 'sites'))
        obj.chinfo = hdf5_loader.load(subpath + 'chinfo')
        obj._W = list(hdf5_loader.load(subpath + 'tensors'))
        obj.IdL = list(hdf5_loader.load(subpath + 'index_identity_left'))
        obj.IdR = list(hdf5_loader.load(subpath + 'index_identity_right'))
        obj.bc = hdf5_loader.load(subpath + 'boundary_condition')
        obj.max_range = hdf5_loader.load(subpath + 'max_range')
        obj.explicit_plus_hc = bool(h5gr.attrs.get('explicit_plus_hc',
                                                   False))
        obj.dtype = npc.result_type(*[W.dtype for W in obj._W])
        return obj

    @staticmethod
    def _get_Id(Id, L):
        if Id is None:
            return [None] * (L + 1)
        Id = list(Id)
        if len(Id) != L + 1:
            raise ValueError("IdL/IdR must have L+1 entries")
        return Id

    @property
    def L(self):
        return len(self.sites)

    @property
    def finite(self):
        """True for 'finite' and 'segment' bc, False for 'infinite'."""
        return self.bc != 'infinite'

    @property
    def chi(self):
        """MPO bond dimensions."""
        return [W.get_leg('wL').ind_len for W in self._W] + \
            [self._W[-1].get_leg('wR').ind_len]

    def extract_segment(self, first, last):
        """A copy on the sites ``[first, last]`` (indices of the infinite
        MPO, taken modulo its length) with bc ``'segment'``; the last
        IdL/IdR entry is that of the bond right of ``last``."""
        L = self.L
        sites = [self.sites[i % L] for i in range(first, last + 1)]
        Ws = [self.get_W(i, copy=True) for i in range(first, last + 1)]
        IdL = [self.IdL[i % L] for i in range(first, last + 1)]
        IdL.append(self.IdL[last % L + 1])
        IdR = [self.IdR[i % L] for i in range(first, last + 1)]
        IdR.append(self.IdR[last % L + 1])
        return self.__class__(sites, Ws, 'segment', IdL, IdR, self.max_range,
                              self.explicit_plus_hc)

    def test_sanity(self):
        assert len(self._W) == self.L
        for i in range(self.L):
            W = self._W[i]
            assert set(W.get_leg_labels()) == {'wL', 'wR', 'p', 'p*'}
            if self.bc == 'infinite' or i + 1 < self.L:
                W2 = self._W[(i + 1) % self.L]
                W.get_leg('wR').test_contractible(W2.get_leg('wL'))

    def copy(self):
        return MPO(self.sites, [W.copy(deep=False) for W in self._W],
                   self.bc, list(self.IdL), list(self.IdR), self.max_range,
                   self.explicit_plus_hc)

    def __repr__(self):
        return f"<MPO L={self.L} bc={self.bc!r} max_chi={max(self.chi)}>"

    def sort_legcharges(self):
        """Sort the virtual legs by charge, in place, moving IdL and IdR
        with them (the option ``sort_mpo_legs`` of a model).  As in
        ``tenpy_tpu``, a finite MPO's last bond keeps its order."""
        from ..tools.misc import inverse_permutation
        L = self.L
        perms, new_legs = [None] * (L + 1), [None] * (L + 1)
        for i in range(L):
            leg = self._W[i].get_leg('wL')
            if not leg.is_sorted():
                perm, new_legs[i] = leg.sort(bunch=False)
                perms[i] = np.asarray(perm)
        for i in range(L):
            W = self._W[i]
            j = (i + 1) % L if self.bc == 'infinite' else i + 1
            pL, pR = perms[i], (perms[j] if j < L else None)
            if pL is None and pR is None:
                continue
            dense = W.to_numpy()
            if pL is not None:
                dense = dense[pL]
            if pR is not None:
                dense = dense[:, pR]
            legL = new_legs[i] if new_legs[i] is not None else W.get_leg('wL')
            legR = new_legs[j].conj() if j < L and new_legs[j] is not None \
                else W.get_leg('wR')
            self._W[i] = npc.Array.from_ndarray(
                dense, [legL, legR, W.get_leg('p'), W.get_leg('p*')],
                labels=['wL', 'wR', 'p', 'p*'], warn_wrong_sector=False)
        for b in range(L + 1):
            p = perms[b % L] if self.bc == 'infinite' else \
                (perms[b] if b < L else None)
            if p is None:
                continue
            inv = inverse_permutation(p)
            if self.IdL[b] is not None:
                self.IdL[b] = int(inv[self.IdL[b]])
            if self.IdR[b] is not None:
                self.IdR[b] = int(inv[self.IdR[b]])
        return self

    def get_W(self, i, copy=False):
        W = self._W[self._to_valid_index(i)]
        return W.copy(deep=False) if copy else W

    def get_IdL(self, i):
        """IdL index on the bond *left* of site i."""
        return self.IdL[self._to_valid_index(i)]

    def get_IdR(self, i):
        """IdR index on the bond *right* of site i."""
        i = self._to_valid_index(i)
        if i + 1 == self.L and self.bc == 'infinite':
            return self.IdR[0]
        return self.IdR[i + 1]

    def _to_valid_index(self, i):
        if self.finite:
            if i < 0:
                i += self.L
            if not 0 <= i < self.L:
                raise IndexError(i)
            return i
        return i % self.L

    @classmethod
    def from_grids(cls, sites, grids, bc='finite', IdL=None, IdR=None,
                   legs=None, max_range=None, explicit_plus_hc=False):
        """An MPO from per-site grids of operator entries: ``None``, an
        operator name, ``[(opname, strength), ...]`` or an Array."""
        sites = list(sites)
        L = len(sites)
        chinfo = sites[0].leg.chinfo
        grids = [grid_insert_ops(sites[i], grids[i]) for i in range(L)]
        if legs is None:
            legs = _calc_grid_legs(chinfo, grids, bc, IdL, IdR)
        Ws = []
        for i in range(L):
            grid = grids[i]
            legR = legs[i + 1] if i + 1 < len(legs) else legs[0]
            grid_obj = np.empty((len(grid), len(grid[0])), dtype=object)
            for a, row in enumerate(grid):
                for b, entry in enumerate(row):
                    grid_obj[a, b] = entry
            Ws.append(npc.grid_outer(grid_obj, [legs[i], legR.conj()],
                                     grid_labels=['wL', 'wR']))
        return cls(sites, Ws, bc, IdL, IdR, max_range, explicit_plus_hc)

    def expectation_value(self, psi):
        """``<psi|H|psi>``: for finite bc the full contraction, for infinite
        bc the energy per site from the transfer matrix
        (:meth:`expectation_value_TM`)."""
        if psi.finite:
            return np.real_if_close(
                MPOEnvironment(psi, self, psi).full_contraction(0))
        return self.expectation_value_TM(psi)

    def expectation_value_TM(self, psi):
        """Energy per site of an iMPS, the mean of the two densities of
        :meth:`MPOTransferMatrix.find_init_LP_RP` (``calc_E=True``)."""
        _, Es, _ = MPOTransferMatrix.find_init_LP_RP(self, psi, calc_E=True)
        return float(np.real(np.mean(Es)))


    def variance(self, psi, exact_E=None):
        """``<psi|H^2|psi> - <psi|H|psi>^2`` of a finite ``psi``, with
        ``H|psi>`` by :meth:`apply_naively`."""
        assert psi.finite
        Hpsi = self.apply_naively(psi.copy())
        if exact_E is None:
            exact_E = self.expectation_value(psi)
        return np.real(Hpsi.overlap(Hpsi) - exact_E ** 2)

    def apply(self, psi, options):
        """Apply the MPO to ``psi`` in place and compress: options
        ``compression_method`` ('SVD': :meth:`apply_naively` and
        ``compress_svd``; 'zip_up' (default): :meth:`apply_zipup` and
        ``compress_svd``; 'variational':
        :class:`~tenpy_tpu_torch.algorithms.mps_common.VariationalApplyMPO`)
        and ``trunc_params``.  Returns the truncation error."""
        from ..tools.params import asConfig
        options = asConfig(options, 'MPO_apply')
        method = options.get('compression_method', 'zip_up')
        if method == 'SVD':
            self.apply_naively(psi)
            return psi.compress_svd(options.subconfig('trunc_params'))
        if method == 'zip_up':
            trunc_err = self.apply_zipup(psi, options)
            return trunc_err + psi.compress_svd(
                options.subconfig('trunc_params'))
        if method == 'variational':
            from ..algorithms.mps_common import VariationalApplyMPO
            return VariationalApplyMPO(psi, self, options).run()
        raise ValueError(f"unknown compression_method {method!r}")

    def apply_naively(self, psi):
        """Contract each W into the state's B-form tensor (the bond
        dimensions multiply), then canonicalize (no renormalization)."""
        finite = psi.bc == 'finite'
        for i in range(psi.L):
            # the B form, not the stored tensor: a mixed-canonical state is
            # the product of its raw tensors only with S at the A/B border
            B = npc.tensordot(psi.get_B(i, 'B'), self.get_W(i),
                              axes=[['p'], ['p*']])
            if finite and i == 0 and self.IdL[0] is not None:
                B = _project_onto_w_index(B, 'wL', self.IdL[0])
                B = B.combine_legs([['wR', 'vR']], qconj=[-1])
                B.ireplace_label('(wR.vR)', 'vR')
            elif finite and i == psi.L - 1 and self.IdR[-1] is not None:
                B = _project_onto_w_index(B, 'wR', self.IdR[-1])
                B = B.combine_legs([['wL', 'vL']], qconj=[+1])
                B.ireplace_label('(wL.vL)', 'vL')
            else:
                B = B.combine_legs([['wL', 'vL'], ['wR', 'vR']],
                                   qconj=[+1, -1])
                B.ireplace_labels(['(wL.vL)', '(wR.vR)'], ['vL', 'vR'])
            psi.set_B(i, B.itranspose(['vL', 'p', 'vR']), None)
        # the Schmidt values are not known: placeholders until canonical
        for b in range(psi.L + 1):
            n = psi.get_B(min(b, psi.L - 1), None).get_leg(
                'vL' if b < psi.L else 'vR').ind_len
            psi._S[b] = np.ones(n) / np.sqrt(n)
        if finite:
            psi.canonical_form_finite(renormalize=False)
        else:
            psi.canonical_form_infinite()
        return psi

    def apply_zipup(self, psi, options):
        """Apply the MPO to a finite ``psi`` in place by the zip-up
        (arXiv:1002.1305): contract site by site and truncate on the way
        (``trunc_params``, relaxed by ``trunc_weight`` < 1), then
        canonicalize.  Returns the truncation error."""
        from ..tools.params import asConfig
        options = asConfig(options, 'zip_up')
        trunc_params = options.subconfig('trunc_params')
        trunc_weight = options.get('trunc_weight', 1., 'real')
        relax = dict(trunc_params.as_dict())
        if trunc_weight < 1. and relax.get('svd_min') is not None:
            relax['svd_min'] = relax['svd_min'] * trunc_weight
        if relax.get('chi_max') is not None:
            relax['chi_max'] = int(relax['chi_max']
                                   * (2 if trunc_weight < 1. else 1))
        assert psi.finite
        trunc_err = TruncationError()
        carry = None
        for i in range(psi.L):
            B = psi.get_B(i, 'B' if i > 0 else 'Th')
            W = self.get_W(i)
            if carry is None:
                C = npc.tensordot(B, W, axes=[['p'], ['p*']])
                C = _project_onto_w_index(C, 'wL', self.IdL[0])
            else:
                C = npc.tensordot(carry, B, axes=[['vR'], ['vL']])
                C = npc.tensordot(C, W, axes=[['wR', 'p'], ['wL', 'p*']])
            C.itranspose(['vL', 'p', 'wR', 'vR'])
            if i == psi.L - 1:
                C = _project_onto_w_index(C, 'wR', self.IdR[-1])
                psi.set_B(i, C.itranspose(['vL', 'p', 'vR']), None)
                break
            theta = C.combine_legs([['vL', 'p'], ['wR', 'vR']],
                                   qconj=[+1, -1])
            U, S, VH, err, renorm = svd_theta(theta, relax)
            trunc_err += err
            psi.set_B(i, U.split_legs([0]), 'A')
            psi.set_SR(i, S)
            carry = VH.iscale_axis(np.asarray(S) * renorm, 0).split_legs([1])
        psi.canonical_form_finite(renormalize=False)
        return trunc_err

    # ------------------------------------------------------- time evolution
    def make_U(self, dt, approximation='II'):
        """``U ~ exp(-dt H)`` as an MPO, by the W_I or W_II approximation
        (arXiv:1407.1832); ``dt`` may be complex (``1j * delta_t`` for real
        time)."""
        if approximation == 'II':
            return self.make_U_II(dt)
        if approximation == 'I':
            return self.make_U_I(dt)
        raise ValueError(f"unknown approximation {approximation!r}")

    def make_U_I(self, dt):
        """The W_I approximation of ``exp(-dt H)`` (first order)."""
        return self._make_U(dt, _make_WI_tensor, 'W_I')

    def make_U_II(self, dt):
        """The W_II approximation of ``exp(-dt H)``."""
        return self._make_U(dt, _make_WII_tensor, 'W_II')

    def _make_U(self, dt, make_tensor, name):
        keeps, bond_legs = _wII_bond_data(self)
        U = []
        for i in range(self.L):
            IdL, IdR = self.get_IdL(i), self.get_IdR(i)
            if IdL is None or IdR is None:
                raise ValueError(f"{name} needs IdL/IdR")
            bR = (i + 1) % self.L if self.bc == 'infinite' else i + 1
            U.append(make_tensor(self.get_W(i), IdL, IdR, dt, keeps[i],
                                 keeps[bR], bond_legs[i],
                                 bond_legs[bR].conj()))
        return MPO(self.sites, U, self.bc, IdL=[0] * (self.L + 1),
                   IdR=[0] * (self.L + 1), max_range=self.max_range)


def grid_insert_ops(site, grid):
    """Grid entries (str | [(str or Array, strength)] | Array | None) ->
    operators."""
    new_grid = []
    for row in grid:
        new_row = []
        for entry in row:
            if entry is None or isinstance(entry, npc.Array):
                new_row.append(entry)
            elif isinstance(entry, str):
                new_row.append(site.get_op(entry))
            else:
                op = None
                for opname, strength in entry:
                    term = (site.get_op(opname) if isinstance(opname, str)
                            else opname) * strength
                    op = term if op is None else op + term
                new_row.append(op)
        new_grid.append(new_row)
    return new_grid


def _calc_grid_legs(chinfo, grids, bc, IdL, IdR):
    """The virtual leg charges, propagated through the grids from IdL."""
    L = len(grids)
    n_states = [len(grids[i]) for i in range(L)] + [len(grids[L - 1][0])]
    qs = [[None] * n for n in n_states]
    qs[0][IdL[0] if IdL and IdL[0] is not None else 0] = chinfo.make_valid()
    passes = 1 if bc == 'finite' else L + 2     # infinite: bond L is bond 0
    for _ in range(passes):
        for i in range(L):
            for a, row in enumerate(grids[i]):
                if qs[i][a] is None:
                    continue
                for b, op in enumerate(row):
                    if op is None:
                        continue
                    q = chinfo.make_valid(qs[i][a]
                                          + np.asarray(op.qtotal, QTYPE))
                    tgt = qs[0] if (i + 1 == L and bc == 'infinite') \
                        else qs[i + 1]
                    if tgt[b] is None:
                        tgt[b] = q
        if bc == 'infinite':
            qs[L] = qs[0]
    legs = []
    for bqs in qs[:L] + ([qs[L]] if bc != 'infinite' else []):
        qflat = np.array([q if q is not None else chinfo.make_valid()
                          for q in bqs], QTYPE).reshape(len(bqs),
                                                        chinfo.qnumber)
        legs.append(LegCharge.from_qflat(chinfo, qflat, qconj=+1))
    if bc == 'infinite':
        legs.append(legs[0])
    return legs


class MPOGraph:
    """Finite-state-machine form of a sum of terms, compiled to an MPO.

    States live on bonds; edges on sites carry ``(opname, strength)``."""

    def __init__(self, sites, bc='finite', max_range=None):
        self.sites = list(sites)
        self.chinfo = self.sites[0].leg.chinfo
        self.bc = bc
        self.max_range = max_range
        self.L = L = len(self.sites)
        n_bonds = L + 1 if bc == 'finite' else L
        self.states = [dict() for _ in range(n_bonds)]
        self.graph = [dict() for _ in range(L)]   # keyL -> keyR -> [(op, c)]

    @classmethod
    def from_terms(cls, terms, sites, bc, insert_all_id=True):
        """The graph of ``(onsite_terms, coupling_terms, ...)``."""
        graph = cls(sites, bc)
        for t in terms:
            if t is not None:
                t.add_to_graph(graph)
        graph.add_missing_IdL_IdR(insert_all_id)
        return graph

    @classmethod
    def from_term_list(cls, term_list, sites, bc, insert_all_id=True):
        """The graph of a
        :class:`~tenpy_tpu_torch.networks.terms.TermList`."""
        ot, ct = term_list.to_OnsiteTerms_CouplingTerms(sites)
        return cls.from_terms([ot, ct], sites, bc, insert_all_id)

    def _bond(self, b):
        return b if self.bc == 'finite' else b % self.L

    def add(self, i, keyL, keyR, opname, strength, check_op=True,
            skip_existing=False):
        """Add the edge keyL --opname*strength--> keyR at site i."""
        site_i = i % self.L
        if check_op and not self.sites[site_i].valid_opname(opname):
            raise ValueError(f"unknown op {opname!r} on site {site_i}")
        self.states[self._bond(i)].setdefault(keyL, None)
        self.states[self._bond(i + 1)].setdefault(keyR, None)
        entries = self.graph[site_i].setdefault(keyL, {}).setdefault(keyR, [])
        if skip_existing and any(op == opname for op, _ in entries):
            return
        entries.append((opname, strength))

    def add_string_left_to_right(self, i, j, key, op_string, check_op=True):
        """``op_string`` edges on sites i+1..j-1 carrying ``key``; returns
        the key on bond j.  For infinite bc a string longer than the unit
        cell carries its winding number in the key (no FSM cycle)."""
        def bond_key(b):
            if self.bc == 'finite':
                return key
            w = (b - (i + 1)) // self.L
            return key if w == 0 else (key, 'wind', w)

        for x in range(i + 1, j):
            self.add(x, bond_key(x), bond_key(x + 1), op_string, 1.,
                     check_op=check_op, skip_existing=True)
        return bond_key(j)

    def add_string_right_to_left(self, j, i, key, op_string, check_op=True):
        """:meth:`add_string_left_to_right` from ``i`` to ``j``."""
        return self.add_string_left_to_right(i, j, key, op_string, check_op)

    def add_missing_IdL_IdR(self, insert_all_id=True):
        """IdL/IdR states on all bonds, connected by identity strings."""
        L = self.L
        if self.bc == 'finite':
            bonds_L, bonds_R = range(0, L), range(1, L + 1)
        else:
            bonds_L, bonds_R = range(0, L), range(0, L)
        for b in bonds_L:
            self.states[self._bond(b)].setdefault('IdL', None)
        for b in bonds_R:
            self.states[self._bond(b)].setdefault('IdR', None)
        for i in range(L):
            if self.bc != 'finite' or i + 1 < L:
                d = self.graph[i].setdefault('IdL', {})
                if 'IdL' not in d:
                    d['IdL'] = [('Id', 1.)]
            if self.bc != 'finite' or i > 0:
                d = self.graph[i].setdefault('IdR', {})
                if 'IdR' not in d:
                    d['IdR'] = [('Id', 1.)]
        for i in range(L):
            for keyL, d in self.graph[i].items():
                self.states[self._bond(i)].setdefault(keyL, None)
                for keyR in d:
                    self.states[self._bond(i + 1)].setdefault(keyR, None)

    def test_sanity(self):
        for i in range(self.L):
            for keyL, d in self.graph[i].items():
                assert keyL in self.states[self._bond(i)]
                for keyR in d:
                    assert keyR in self.states[self._bond(i + 1)]

    def _order_states(self):
        """State indices: IdL first, IdR last, the rest in insertion order
        (this order decides the order of W's wL/wR legs)."""
        ordered = []
        for states in self.states:
            res = ['IdL'] if 'IdL' in states else []
            res.extend(k for k in states if k not in ('IdL', 'IdR'))
            if 'IdR' in states:
                res.append('IdR')
            ordered.append({k: x for x, k in enumerate(res)})
        return ordered

    def build_MPO(self):
        """Compile the graph into an MPO (virtual leg charges included)."""
        self.test_sanity()
        if self.bc == 'infinite' and not self.chinfo.trivial_shift:
            raise NotImplementedError(
                "infinite MPOs with position-dependent charges (dipole "
                "conservation) need charge shifts at the unit-cell wrap: "
                "use bc_MPS='finite'")
        ordered = self._order_states()
        L = self.L
        grids = []
        for i in range(L):
            bL, bR = self._bond(i), self._bond(i + 1)
            grid = [[None] * len(ordered[bR]) for _ in ordered[bL]]
            for keyL, d in self.graph[i].items():
                a = ordered[bL][keyL]
                for keyR, entries in d.items():
                    b = ordered[bR][keyR]
                    if grid[a][b] is None:
                        grid[a][b] = list(entries)
                    else:
                        grid[a][b].extend(entries)
            grids.append(grid)
        bonds = ordered + [ordered[0]] if self.bc == 'infinite' else ordered
        IdL = [s.get('IdL', None) for s in bonds][:L + 1]
        IdR = [s.get('IdR', None) for s in bonds][:L + 1]
        return MPO.from_grids(self.sites, grids, self.bc, IdL, IdR,
                              max_range=self.max_range)

    def __repr__(self):
        return f"<MPOGraph L={self.L} bc={self.bc!r}>"


class MPOEnvironment(BaseEnvironment):
    """Partial contractions of <bra|H|ket>.

    ``LP[i]`` has labels ``('vR*', 'wR', 'vR')``, ``RP[i]`` has
    ``('vL*', 'wL', 'vL')``."""

    def __init__(self, bra, H, ket, cache=None, **init_env_data):
        self.H = H
        super().__init__(bra, ket, cache, **init_env_data)
        self.dtype = npc.result_type(bra.dtype, ket.dtype, H.dtype)

    def init_LP(self, i, start_env_sites=0):
        """Trivial LP: identity on the virtual legs, IdL on the w leg."""
        i0 = i - start_env_sites
        leg_v = self.ket.get_B(i0, None).get_leg('vL')
        leg_w = self.H.get_W(i0).get_leg('wL')
        IdL = self.H.get_IdL(i0)
        if IdL is None:
            raise ValueError(f"no IdL on bond {i0}: can't initialize LP")
        LP = _env_init(leg_v, leg_w, IdL, self.dtype, left=True)
        for j in range(i0, i):
            LP = self._contract_LP(j, LP)
        return LP

    def init_RP(self, i, start_env_sites=0):
        i0 = i + start_env_sites
        leg_v = self.ket.get_B(i0, None).get_leg('vR')
        leg_w = self.H.get_W(i0).get_leg('wR')
        IdR = self.H.get_IdR(i0)
        if IdR is None:
            raise ValueError(f"no IdR on bond {i0 + 1}: can't initialize RP")
        RP = _env_init(leg_v, leg_w, IdR, self.dtype, left=False)
        for j in range(i0, i, -1):
            RP = self._contract_RP(j, RP)
        return RP

    def _extra_p(self):
        """The state's physical legs besides the MPO's ``p`` (``q`` of a
        purification): the MPO acts on them as the identity, so they
        contract bra with ket."""
        return [l for l in getattr(self.ket, '_p_label', ['p']) if l != 'p']

    def _contract_LP(self, i, LP):
        extra = self._extra_p()
        LP = npc.tensordot(LP, self.ket.get_B(i, 'A'), axes=[['vR'], ['vL']])
        LP = npc.tensordot(self.H.get_W(i), LP,
                           axes=[['wL', 'p*'], ['wR', 'p']])
        LP = npc.tensordot(self.bra.get_B(i, 'A').conj(), LP,
                           axes=[['vL*', 'p*'] + [l + '*' for l in extra],
                                 ['vR*', 'p'] + extra])
        return LP.itranspose(['vR*', 'wR', 'vR'])

    def _contract_RP(self, i, RP):
        extra = self._extra_p()
        RP = npc.tensordot(self.ket.get_B(i, 'B'), RP, axes=[['vR'], ['vL']])
        RP = npc.tensordot(RP, self.H.get_W(i),
                           axes=[['p', 'wL'], ['p*', 'wR']])
        RP = npc.tensordot(RP, self.bra.get_B(i, 'B').conj(),
                           axes=[['p', 'vL*'] + extra,
                                 ['p*', 'vR*'] + [l + '*' for l in extra]])
        return RP.itranspose(['vL*', 'wL', 'vL'])

    def full_contraction(self, i0):
        """``<bra|H|ket>`` (times both norms): ``LP[i0]`` and ``RP[i0-1]``
        with the Schmidt values of bond ``i0`` between them.  For finite bc,
        ``i0 = 0`` contracts site 0 into a fresh LP and ``i0 = L`` site
        ``L-1`` into a fresh RP."""
        L = self.ket.L
        if self.ket.finite and i0 == 0:
            LP = self._contract_LP(0, self.init_LP(0))
            RP = self.get_RP(0)
            S_bra, S_ket = self.bra.get_SR(0), self.ket.get_SR(0)
        elif self.ket.finite and i0 == L:
            RP = self._contract_RP(L - 1, self.init_RP(L - 1))
            LP = self.get_LP(L - 1)
            S_bra, S_ket = self.bra.get_SL(L - 1), self.ket.get_SL(L - 1)
        else:
            LP = self.get_LP(i0)
            RP = self.get_RP(i0 - 1)
            S_bra, S_ket = self.bra.get_SL(i0), self.ket.get_SL(i0)
        LP = self._scale_S_axis(LP, S_bra, 'vR*', conj=True)
        LP = self._scale_S_axis(LP, S_ket, 'vR', conj=False)
        contr = npc.tensordot(LP, RP, axes=[['vR*', 'wR', 'vR'],
                                            ['vL*', 'wL', 'vL']])
        return complex(contr) * self.bra.norm * self.ket.norm

    @staticmethod
    def _scale_S_axis(T, S, axis, conj):
        """``T`` with the Schmidt values ``S`` (conjugated with ``conj``)
        multiplied onto leg ``axis``; ``S`` may be a mixer's bond matrix."""
        if isinstance(S, npc.Array):
            if conj:
                T = npc.tensordot(T, S.conj(), axes=[[axis], ['vL*']])
                return T.ireplace_label('vR*', axis)
            T = npc.tensordot(T, S, axes=[[axis], ['vL']])
            return T.ireplace_label('vR', axis)
        S = np.asarray(S)
        return T.copy(deep=False).iscale_axis(np.conj(S) if conj else S,
                                              axis)


def _env_init(leg_v, leg_w, w_idx, dtype, left=True):
    """LP/RP start tensor: identity on the virtual legs times the unit
    vector ``w_idx`` of the w leg."""
    if left:
        diag = npc.diag(1., leg_v, dtype=dtype, labels=['vR*', 'vR'])
    else:
        diag = npc.diag(1., leg_v.conj(), dtype=dtype, labels=['vL', 'vL*'])
    w_leg = leg_w.conj()
    vec = np.zeros(w_leg.ind_len)
    vec[w_idx] = 1.
    w_arr = npc.Array.from_ndarray(vec, [w_leg],
                                   qtotal=w_leg.to_qflat()[w_idx]
                                   * w_leg.qconj, warn_wrong_sector=False)
    res = npc.outer(diag, w_arr)
    if left:
        res.iset_leg_labels(['vR*', 'vR', 'wR'])
        return res.itranspose(['vR*', 'wR', 'vR'])
    res.iset_leg_labels(['vL', 'vL*', 'wL'])
    return res.itranspose(['vL*', 'wL', 'vL'])


class MPOTransferMatrix:
    """Transfer matrix of a Hamiltonian-like MPO between canonical iMPS.

    With the MPO's virtual leg split into IdL, inner and IdR channels (Schur
    form) the transfer matrix has a Jordan block: its generalized dominant
    eigenvector is the converged environment, and the linear growth rate is
    the energy per site.  :meth:`matvec` applies one unit cell and projects
    the growing part out, so Arnoldi converges to the fixed point with
    eigenvalue 1.

    Parameters
    ----------
    H : MPO, psi : MPS (both infinite)
    transpose : bool
        False: acts on RP (legs ``vL wL vL*``); True: on LP (``vR* wR vR``).
    guess : Array or None
        Start vector (dropped with a warning where its legs do not fit).
    subtraction_gauge : 'rho' | 'trace'
        The projector fixing the additive gauge of the generalized
        eigenvector ('rho', density-matrix weighted, is the one for which
        :meth:`energy` is the energy per site).
    """

    def __init__(self, H, psi, transpose=False, guess=None,
                 subtraction_gauge='rho'):
        if psi.finite or H.bc != 'infinite':
            raise ValueError("MPOTransferMatrix needs an infinite MPS/MPO")
        self.L = L = int(np.lcm(H.L, psi.L))
        norm_err = np.linalg.norm(psi.norm_test())
        if norm_err > 1e-6:
            logger.warning("MPOTransferMatrix: psi not in canonical form "
                           "(norm_err=%.2e); fixed point may be inaccurate",
                           norm_err)
        self.H = H
        self.psi = psi
        self.transpose = transpose
        self.dtype = dtype = npc.result_type(H.dtype,
                                             psi.get_B(0, None).dtype)
        self.IdL = H.get_IdL(0)
        self.IdR = H.get_IdR(-1)
        if self.IdL is None or self.IdR is None:
            raise ValueError("MPO needs IdL/IdR structure")
        S = psi.get_SL(0)
        S_is_matrix = isinstance(S, npc.Array)   # a UniformMPS's C
        if not S_is_matrix:
            S = np.asarray(S)
        form = 'A' if transpose else 'B'
        self._M = [psi.get_B(i, form) for i in range(L)]
        self._W = [H.get_W(i) for i in range(L)]
        self._Mc = [M.conj() for M in self._M]
        if not transpose:      # fixed point of RP, right to left
            wR = H.get_W(L - 1).get_leg('wR')
            w_leg = wR.conj()
            v_leg = psi.get_B(psi.L - 1, 'B').get_leg('vR')
            if S_is_matrix:
                rho = npc.tensordot(S, S.conj(), axes=[['vL'], ['vL*']])
                rho.iset_leg_labels(['vR', 'vR*'])
            else:
                rho = npc.diag(S ** 2, v_leg, labels=['vR', 'vR*'])
            eye = npc.diag(1., v_leg.conj(), dtype=dtype,
                           labels=['vL', 'vL*'])
            labels, proj_labels, rho_w = (['vL', 'wL', 'vL*'],
                                          ['vR', 'wR', 'vR*'], wR)
            id_shift, id_norm, id_rho = self.IdL, self.IdR, self.IdL
        else:                  # fixed point of LP, left to right
            wL = H.get_W(0).get_leg('wL')
            w_leg = wL.conj()
            v_leg = psi.get_B(0, 'A').get_leg('vL')
            if S_is_matrix:
                rho = npc.tensordot(S.conj(), S, axes=[['vR*'], ['vR']])
                rho.iset_leg_labels(['vL*', 'vL'])
            else:
                rho = npc.diag(S ** 2, v_leg.conj(), labels=['vL*', 'vL'])
            eye = npc.diag(1., v_leg, dtype=dtype, labels=['vR*', 'vR'])
            labels, proj_labels, rho_w = (['vR*', 'wR', 'vR'],
                                          ['vL*', 'wL', 'vL'], wL)
            id_shift, id_norm, id_rho = self.IdR, self.IdL, self.IdR
        w_label = labels[1]
        self._chi0 = chi0 = v_leg.ind_len
        self._E_shift = eye.add_leg(w_leg, id_shift, axis=1, label=w_label)
        self._proj_trace = self._E_shift.conj().iset_leg_labels(
            proj_labels) / chi0
        self._proj_norm = eye.add_leg(w_leg, id_norm, axis=1,
                                      label=w_label).conj()
        self._proj_rho = rho.add_leg(rho_w, id_rho, axis=1,
                                     label=proj_labels[1])
        self._guess_default = eye.add_leg(w_leg, id_norm, axis=1,
                                          label=w_label)
        self._axes = (labels, proj_labels)
        self._proj_subtr = self._proj_rho if subtraction_gauge == 'rho' \
            else self._proj_trace
        if guess is not None:
            try:
                guess = guess.transpose(labels)
                for lbl, leg in zip(labels, self._guess_default.legs):
                    guess.get_leg(lbl).test_equal(leg)
            except (ValueError, KeyError):
                logger.warning("MPOTransferMatrix: dropping incompatible "
                               "guess")
                guess = None
            else:
                guess = self._project(guess)
        self.guess = guess if guess is not None else self._guess_default

    def matvec(self, vec, project=True):
        """One unit cell of the transfer matrix (projected by default)."""
        if any(lbl is None for lbl in vec.get_leg_labels()):
            # from the pipe round trip of FlatLinearOperator: legs in order
            vec = vec.copy(deep=False).iset_leg_labels(list(self._axes[0]))
        if not self.transpose:
            vec = vec.transpose(['vL', 'wL', 'vL*'])
            for i in range(self.L - 1, -1, -1):
                vec = npc.tensordot(self._M[i], vec, axes=[['vR'], ['vL']])
                vec = npc.tensordot(vec, self._W[i],
                                    axes=[['p', 'wL'], ['p*', 'wR']])
                vec = npc.tensordot(vec, self._Mc[i],
                                    axes=[['vL*', 'p'], ['vR*', 'p*']])
                vec.itranspose(['vL', 'wL', 'vL*'])
        else:
            vec = vec.transpose(['vR*', 'wR', 'vR'])
            for i in range(self.L):
                vec = npc.tensordot(vec, self._M[i], axes=[['vR'], ['vL']])
                vec = npc.tensordot(self._W[i], vec,
                                    axes=[['wL', 'p*'], ['wR', 'p']])
                vec = npc.tensordot(self._Mc[i], vec,
                                    axes=[['p*', 'vL*'], ['p', 'vR*']])
                vec.itranspose(['vR*', 'wR', 'vR'])
        return self._project(vec) if project else vec

    def _project(self, vec):
        """``vec`` less its additive (linearly growing) part."""
        E = npc.inner(vec, self._proj_subtr, axes=self._axes, do_conj=False)
        return vec - self._E_shift * E

    def dominant_eigenvector(self, options=None):
        """``(val, vec)``: the dominant eigenpair of the projected transfer
        matrix (ARPACK; a dense eigensolver for sectors of size 8 or less),
        ``val`` about 1, ``vec`` scaled so its IdR (IdL) channel traces to
        ``chi0``."""
        linop, v0 = FlatLinearOperator.from_guess_with_pipe(
            self.matvec, self.guess, dtype=self.dtype)
        n = linop.shape[0]
        if n <= 8:   # ARPACK needs k < n - 1
            basis = np.eye(n, dtype=_np_dtype(self.dtype))
            mat = np.stack([linop._matvec(basis[:, j]) for j in range(n)],
                           axis=1)
            evals, evecs = np.linalg.eig(mat)
            order = np.argsort(-np.abs(evals))
            # a degenerate top eigenvalue (an operator string through the
            # whole cell): the physical environment has the largest
            # identity-channel trace
            top = [j for j in order
                   if abs(abs(evals[j]) - abs(evals[order[0]])) < 1e-8]
            best = None
            for j in top:
                v_npc = linop.flat_to_npc(evecs[:, j]).split_legs([0])
                v_npc.iset_leg_labels(list(self._axes[0]))
                tr = abs(complex(npc.inner(self._proj_norm, v_npc,
                                           axes='range', do_conj=False)))
                if best is None or tr > best[0]:
                    best = (tr, j)
            val = evals[best[1]]
            vec = linop.flat_to_npc(evecs[:, best[1]])
        else:
            vals, vecs = linop.eigenvectors(num_ev=1, which='LM', v0_npc=v0,
                                            **dict(options or {}))
            val, vec = vals[0], vecs[0]
        vec = vec.split_legs([0])
        vec.iset_leg_labels(list(self._axes[0]))
        norm = npc.inner(self._proj_norm, vec, axes='range',
                         do_conj=False) / self._chi0
        return val, vec / norm

    def energy(self, dom_vec):
        """Energy per MPS site: the growth of ``dom_vec`` over one cell."""
        E0 = npc.inner(dom_vec, self._proj_rho, axes=self._axes,
                       do_conj=False)
        E = npc.inner(self.matvec(dom_vec, project=False), self._proj_rho,
                      axes=self._axes, do_conj=False)
        return complex(E - E0) / self.L

    @classmethod
    def find_init_LP_RP(cls, H, psi, calc_E=False, guess_init_env_data=None,
                        tol_ev0=1e-8, subtraction_gauge='rho', options=None,
                        method='auto'):
        """Converged initial LP/RP environments of an infinite MPS.

        Returns the ``init_env_data`` dict (keys ``init_LP, init_RP,
        age_LP, age_RP``), plus ``(Es, E0)`` with ``calc_E``: the energy
        densities ``[e_R, e_L]`` from either fixed point and the
        ``<LP|S^2|RP>`` contraction.  ``method='auto'`` takes the
        channel-wise GMRES construction of :class:`~tenpy_tpu_torch.
        networks.mpo_env_builder.MPOEnvironmentBuilder` where it applies
        (equal unit cells, the MPO's Schur structure), else, as
        ``method='arnoldi'``, the dominant eigenvectors of
        :class:`MPOTransferMatrix`; a real ``H`` and ``psi`` keep them
        real.
        """
        if method == 'auto' and psi.L == H.L:
            from .mpo_env_builder import MPOEnvironmentBuilder
            try:
                builder = MPOEnvironmentBuilder(H, psi)
                return builder.init_LP_RP_iterative(which='both',
                                                    calc_E=calc_E)
            except (ValueError, NotImplementedError) as e:
                logger.debug("iterative env init not applicable (%s); "
                             "falling back to Arnoldi", e)
        guess_init_env_data = guess_init_env_data or {}
        real_in = not psi.dtype.is_complex and not H.dtype.is_complex
        envs, Es = [], []
        for transpose in [False, True]:
            TM = cls(H, psi, transpose=transpose,
                     guess=guess_init_env_data.get(
                         'init_LP' if transpose else 'init_RP'),
                     subtraction_gauge=subtraction_gauge)
            val, vec = TM.dominant_eigenvector(options=options)
            if abs(1. - val) > tol_ev0:
                logger.warning("MPOTransferMatrix eigenvalue not 1: got %s",
                               val)
            if real_in:
                # the Arnoldi eigenvector may carry junk imaginary parts
                vec = vec.real_if_close(tol=1e-10)
            envs.append(vec)
            if calc_E:
                Es.append(np.real_if_close(TM.energy(vec)))
        init_env_data = {'init_LP': envs[1], 'init_RP': envs[0],
                         'age_LP': 0, 'age_RP': 0}
        if not calc_E:
            return init_env_data
        return init_env_data, Es, _E0(envs[1], psi.get_SL(0), envs[0])


def _E0(LP, SL, RP):
    """``<LP|S S^dagger|RP>`` across bond 0: ``SL`` the Schmidt values or
    a bond matrix (a UniformMPS's C)."""
    if isinstance(SL, npc.Array):
        LP = npc.tensordot(LP, SL, axes=[['vR'], ['vL']])
        LP = npc.tensordot(LP, SL.conj(), axes=[['vR*'], ['vL*']])
    else:
        SL = np.asarray(SL)
        LP = LP.copy(deep=False).iscale_axis(SL, 'vR')
        LP = LP.iscale_axis(SL, 'vR*')
    return complex(npc.tensordot(LP, RP, axes=[['vR', 'wR', 'vR*'],
                                               ['vL', 'wL', 'vL*']]))


def _project_onto_w_index(a, label, idx):
    """``a`` at the single index ``idx`` of its leg ``label`` (the leg
    removed)."""
    mask = np.zeros(a.get_leg(label).ind_len, bool)
    mask[idx] = True
    res = a.copy(deep=False).iproject([mask], [label])
    return res.squeeze([res.get_leg_index(label)])


def _wII_bond_data(H):
    """Per bond of ``H``: the kept indices (all but IdL and IdR) and the
    new bond leg, whose index 0 is the single identity channel that
    replaces both.  One leg per bond (conjugated on the left site's wR)
    keeps neighbouring U tensors contractible where IdL != IdR."""
    L = H.L
    keeps, legs = [], []
    for b in range(L if H.bc == 'infinite' else L + 1):
        leg = H.get_W(b).get_leg('wL') if b < L else \
            H.get_W(L - 1).get_leg('wR').conj()
        drop = {x for x in (H.IdL[b], H.IdR[b]) if x is not None}
        keep = [x for x in range(leg.ind_len) if x not in drop]
        chinfo = leg.chinfo
        qflat = leg.to_qflat()
        rows = [chinfo.make_valid()] + [qflat[x] * leg.qconj for x in keep]
        keeps.append(keep)
        legs.append(LegCharge.from_qflat(
            chinfo, chinfo.make_valid(np.array(rows)), +1))
    return keeps, legs


def _W_blocks(W, IdL, IdR, keepL, keepR):
    """The blocks of ``W = [[1, C, D], [0, A, B], [0, 0, 1]]``: ``(A, B,
    C, D)`` as numpy arrays, and ``W`` dense."""
    dense = W.to_numpy()
    return (dense[np.ix_(keepL, keepR)], dense[keepL, IdR],
            dense[IdL, keepR], dense[IdL, IdR], dense)


def _sqrt_t(t):
    return np.sqrt(complex(t)) if np.iscomplexobj(np.asarray(t)) or \
        np.real(t) < 0 else np.sqrt(t)


def _make_WI_tensor(W, IdL, IdR, dt, keepL, keepR, legL, legR):
    """The U^I tensor ``[[1 + t D, sqrt(t) C], [sqrt(t) B, A]]`` with ``t
    = -dt`` (``make_U(dt) = exp(-dt H)``)."""
    A, B, C, D, dense = _W_blocks(W, IdL, IdR, keepL, keepR)
    d = dense.shape[2]
    t = -dt
    sqdt = _sqrt_t(t)
    nL, nR = len(keepL), len(keepR)
    U = np.zeros((1 + nL, 1 + nR, d, d), complex if np.iscomplexobj(sqdt)
                 or np.iscomplexobj(dense) else float)
    U[0, 0] = np.eye(d) + t * D
    for b in range(nR):
        U[0, 1 + b] = sqdt * C[b]
    for a in range(nL):
        U[1 + a, 0] = sqdt * B[a]
        for b in range(nR):
            U[1 + a, 1 + b] = A[a, b]
    return npc.Array.from_ndarray(U, [legL, legR, W.get_leg('p'),
                                      W.get_leg('p*')],
                                  labels=['wL', 'wR', 'p', 'p*'],
                                  warn_wrong_sector=False)


def _make_WII_tensor(W, IdL, IdR, dt, keepL, keepR, legL, legR):
    r"""The W_II tensor (arXiv:1407.1832 eq. 11-12): for each pair of an
    "in" row ``a`` and an "out" column ``b``, the element
    ``<n_a, n_b| exp(G) |0, 0>`` of two auxiliary hard-core bosons, ``G =
    t D + sqrt(t) (c_a^dagger B_a + c_b^dagger C_b) + c_a^dagger
    c_b^dagger A_ab`` on (boson a) x (boson b) x (site), ``t = -dt``."""
    import scipy.linalg
    A, B, C, D, dense = _W_blocks(W, IdL, IdR, keepL, keepR)
    d = dense.shape[2]
    t = -dt
    sq_t = _sqrt_t(t)
    nL, nR = len(keepL), len(keepR)
    U = np.zeros((1 + nL, 1 + nR, d, d), complex if np.iscomplexobj(sq_t)
                 or np.iscomplexobj(dense) else float)
    cdag = np.array([[0., 0.], [1., 0.]])
    proj0, proj1 = np.array([1., 0.]), np.array([0., 1.])
    eye2, zero = np.eye(2), np.zeros((d, d))
    vec_in = np.kron(np.kron(proj0, proj0), np.eye(d))
    for a in range(nL + 1):
        for b in range(nR + 1):
            Ba = B[a - 1] if a > 0 else zero
            Cb = C[b - 1] if b > 0 else zero
            Aab = A[a - 1, b - 1] if (a > 0 and b > 0) else zero
            G = (np.kron(np.kron(eye2, eye2), t * D)
                 + np.kron(np.kron(cdag, eye2), sq_t * Ba)
                 + np.kron(np.kron(eye2, cdag), sq_t * Cb)
                 + np.kron(np.kron(cdag, cdag), Aab))
            vec_out = np.kron(np.kron(proj1 if a > 0 else proj0,
                                      proj1 if b > 0 else proj0), np.eye(d))
            U[a, b] = vec_out @ scipy.linalg.expm(G) @ vec_in.T
    return npc.Array.from_ndarray(U, [legL, legR, W.get_leg('p'),
                                      W.get_leg('p*')],
                                  labels=['wL', 'wR', 'p', 'p*'],
                                  warn_wrong_sector=False)
