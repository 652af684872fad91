r"""Matrix product operators: MPO, the MPOGraph compiler, MPO environments.

Port of the part of ``tenpy_tpu/networks/mpo.py`` that the sweep engine's
host setup runs: :class:`MPO` with :meth:`MPO.from_grids`, the
:class:`MPOGraph` compiler of a model's terms, :class:`MPOEnvironment` and
the converged infinite-bc environments of
:meth:`MPOTransferMatrix.find_init_LP_RP` by its ``method='auto'`` route
(the channel-wise GMRES construction of
:mod:`~tenpy_tpu_torch.networks.mpo_env_builder`).  Its fallback, the
Arnoldi eigensolver over a ``FlatLinearOperator``, is not ported and
raises.

Conventions (as in ``tenpy_tpu``): W tensors have labels ``wL, wR, p, p*``
with ``qconj=+1`` (wL) / ``-1`` (wR); ``IdL[b]`` / ``IdR[b]`` index the
"only identities to the left/right" state on bond ``b`` (or None).
"""

from __future__ import annotations

import logging

import numpy as np

from ..linalg import np_conserved as npc
from ..linalg.charges import LegCharge, QTYPE
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


def grid_insert_ops(site, grid):
    """Grid entries (str | [(str, strength)] | Array | None) -> operators."""
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
                    term = site.get_op(opname) * strength
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
                "infinite MPOs with position-dependent charges are not "
                "ported")
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

    def _contract_LP(self, i, LP):
        LP = npc.tensordot(LP, self.ket.get_B(i, 'A'), axes=[['vR'], ['vL']])
        LP = npc.tensordot(self.H.get_W(i), LP,
                           axes=[['wL', 'p*'], ['wR', 'p']])
        LP = npc.tensordot(self.bra.get_B(i, 'A').conj(), LP,
                           axes=[['vL*', 'p*'], ['vR*', 'p']])
        return LP.itranspose(['vR*', 'wR', 'vR'])

    def _contract_RP(self, i, RP):
        RP = npc.tensordot(self.ket.get_B(i, 'B'), RP, axes=[['vR'], ['vL']])
        RP = npc.tensordot(RP, self.H.get_W(i),
                           axes=[['p', 'wL'], ['p*', 'wR']])
        RP = npc.tensordot(RP, self.bra.get_B(i, 'B').conj(),
                           axes=[['p', 'vL*'], ['p*', 'vR*']])
        return RP.itranspose(['vL*', 'wL', 'vL'])


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
    """Converged environments of a Hamiltonian-like MPO on an infinite MPS.

    Only :meth:`find_init_LP_RP` is ported, by its ``method='auto'`` route.
    """

    @classmethod
    def find_init_LP_RP(cls, H, psi, calc_E=False, guess_init_env_data=None,
                        tol_ev0=1e-8, subtraction_gauge='rho', options=None,
                        method='auto'):
        """Converged initial LP/RP environments of an infinite MPS.

        Returns the ``init_env_data`` dict (keys ``init_LP, init_RP,
        age_LP, age_RP``), plus ``(Es, E0)`` with ``calc_E``: the energy
        densities from either fixed point and the ``<LP|S^2|RP>``
        contraction.  The route is the channel-wise GMRES construction of
        :class:`~tenpy_tpu_torch.networks.mpo_env_builder.
        MPOEnvironmentBuilder`.  Where it does not apply, ``tenpy_tpu``
        falls back to an Arnoldi eigensolver of the transfer matrix; that
        route is not ported and raises ``NotImplementedError``.
        """
        if method == 'auto' and psi.L == H.L:
            from .mpo_env_builder import MPOEnvironmentBuilder
            try:
                builder = MPOEnvironmentBuilder(H, psi)
                return builder.init_LP_RP_iterative(which='both',
                                                    calc_E=calc_E)
            except (ValueError, NotImplementedError) as e:
                raise NotImplementedError(
                    "find_init_LP_RP: the channel-wise GMRES construction "
                    f"does not apply ({e}); the Arnoldi route of tenpy_tpu "
                    "(MPOTransferMatrix.dominant_eigenvector over a "
                    "FlatLinearOperator) is not ported") from e
        raise NotImplementedError(
            f"find_init_LP_RP(method={method!r}, psi.L={psi.L}, H.L={H.L}): "
            "only the channel-wise GMRES route (method='auto', equal unit "
            "cells) is ported; the Arnoldi route is not")
