r"""Hamiltonian terms on the way from the model DSL to the MPO.

Port of ``tenpy_tpu/networks/terms.py``: ``TermList``, ``OnsiteTerms``,
``CouplingTerms``, ``MultiCouplingTerms``, ``ExponentiallyDecayingTerms``
and ``order_combine_term``.  Couplings are stored with ``i < j``; for
infinite systems ``j`` may exceed ``L`` (a coupling across the unit-cell
boundary); fermionic terms carry the Jordan-Wigner strings that
``Site.op_needs_JW`` asks for.  Each container adds itself to an
:class:`~tenpy_tpu_torch.networks.mpo.MPOGraph` as in ``tenpy_tpu``, so a
model's W tensors come out the same.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..linalg import np_conserved as npc

__all__ = ['TermList', 'OnsiteTerms', 'CouplingTerms', 'MultiCouplingTerms',
           'ExponentiallyDecayingTerms', 'order_combine_term']


class TermList:
    """Terms, each a list of ``(opname, site_index)``, with prefactors."""

    def __init__(self, terms, strength=1.):
        self.terms = [list(t) for t in terms]
        strength = np.asarray(strength)
        if strength.ndim == 0:
            strength = np.broadcast_to(strength, (len(self.terms),))
        self.strength = np.array(strength)
        if len(self.strength) != len(self.terms):
            raise ValueError("strength length mismatch")

    @classmethod
    def from_lattice_locations(cls, lattice, terms, strength=1., shift=None):
        """Terms given as ``(opname, lattice index)`` on MPS indices."""
        converted = []
        for term in terms:
            new_term = []
            for op, lat_idx in term:
                idx = np.array(lat_idx)
                if shift is not None:
                    idx = idx + np.array(shift + [0])
                new_term.append((op, int(lattice.lat2mps_idx(idx))))
            converted.append(new_term)
        return cls(converted, strength)

    def to_OnsiteTerms_CouplingTerms(self, sites):
        """``(OnsiteTerms, CouplingTerms or MultiCouplingTerms)`` of the
        terms (the Jordan-Wigner strings inserted)."""
        L = len(sites)
        ot = OnsiteTerms(L)
        ct = (MultiCouplingTerms if any(len(t) > 2 for t in self.terms)
              else CouplingTerms)(L)
        for term, strength in zip(self.terms, self.strength):
            term = list(term)
            if len(term) == 1:
                op, i = term[0]
                ot.add_onsite_term(strength, i % L, op)
            elif len(term) == 2:
                ct.add_coupling_term(*ct.coupling_term_handle_JW(
                    strength, term, sites))
            else:
                term, sign = order_combine_term(term, sites)
                ct.add_multi_coupling_term(*ct.multi_coupling_term_handle_JW(
                    strength * sign, term, sites))
        return ot, ct

    def order_combine(self, sites):
        """Sort each term by site (with the fermionic signs) and combine
        operators on one site, in place."""
        for idx, term in enumerate(self.terms):
            self.terms[idx], sign = order_combine_term(term, sites)
            self.strength[idx] *= sign
        return self

    def limits(self):
        return (np.array([min(i for _, i in t) for t in self.terms]),
                np.array([max(i for _, i in t) for t in self.terms]))

    def shift(self, i0):
        return TermList([[(op, i + i0) for op, i in t] for t in self.terms],
                        self.strength)

    def max_range(self):
        mins, maxs = self.limits()
        return int(np.max(maxs - mins))

    def __iter__(self):
        return iter(zip(self.terms, self.strength))

    def __add__(self, other):
        if isinstance(other, TermList):
            return TermList(self.terms + other.terms,
                            np.concatenate([self.strength, other.strength]))
        return NotImplemented

    def __mul__(self, other):
        return TermList(self.terms, self.strength * other)

    def __str__(self):
        return ' +\n'.join(
            f"{strength:.5f} * " + ' '.join(f"{op}_{i}" for op, i in term)
            for term, strength in self)


def order_combine_term(term, sites):
    """Sort a term by site index (stable), tracking fermionic signs, and
    combine operators on the same site; returns ``(term, sign)``."""
    L = len(sites)
    ops = list(term)
    sign = 1
    n = len(ops)
    needs_JW = [sites[i % L].op_needs_JW(op) for op, i in ops]
    for a in range(n):
        for b in range(n - 1 - a):
            if ops[b][1] > ops[b + 1][1]:
                if needs_JW[b] and needs_JW[b + 1]:
                    sign = -sign
                ops[b], ops[b + 1] = ops[b + 1], ops[b]
                needs_JW[b], needs_JW[b + 1] = needs_JW[b + 1], needs_JW[b]
    combined = []
    for op, i in ops:
        if combined and combined[-1][1] == i:
            combined[-1] = (sites[i % L].multiply_op_names([combined[-1][0],
                                                            op]), i)
        else:
            combined.append((op, i))
    return combined, sign


def _onsite_sum(site, d):
    H = None
    for opname, strength in d.items():
        term = site.get_op(opname) * strength
        H = term if H is None else H + term
    return H


class OnsiteTerms:
    """Sum of on-site terms: ``onsite_terms[i] = {opname: strength}``."""

    def __init__(self, L):
        assert L > 0
        self.L = L
        self.onsite_terms = [{} for _ in range(L)]

    def max_range(self):
        return 0

    def add_onsite_term(self, strength, i, op):
        d = self.onsite_terms[i]
        d[op] = d.get(op, 0) + strength

    def add_to_graph(self, graph):
        for i, d in enumerate(self.onsite_terms):
            for opname, strength in d.items():
                graph.add(i, 'IdL', 'IdR', opname, strength)

    def remove_zeros(self, tol_zero=1e-15):
        for d in self.onsite_terms:
            for op in [op for op, s in d.items() if abs(s) < tol_zero]:
                del d[op]

    def add_to_nn_bond_Arrays(self, H_bond, sites, finite,
                              distribute=(0.5, 0.5)):
        """Distribute the on-site terms onto ``H_bond`` (``H_bond[i]`` acts
        on sites ``(i-1, i)``)."""
        L = self.L
        for j, d in enumerate(self.onsite_terms):
            if not d:
                continue
            H = _onsite_sum(sites[j], d)
            dl, dr = distribute
            if finite:
                if j == 0:
                    dl, dr = 0., 1.
                elif j == L - 1:
                    dl, dr = 1., 0.
            if dl > 0.:
                b = j % L
                Hb = npc.outer(
                    sites[(j - 1) % L].Id.replace_labels(['p', 'p*'],
                                                         ['p0', 'p0*']),
                    (dl * H).replace_labels(['p', 'p*'], ['p1', 'p1*']))
                H_bond[b] = Hb if H_bond[b] is None else H_bond[b] + Hb
            if dr > 0.:
                b = (j + 1) % L
                Hb = npc.outer(
                    (dr * H).replace_labels(['p', 'p*'], ['p0', 'p0*']),
                    sites[(j + 1) % L].Id.replace_labels(['p', 'p*'],
                                                         ['p1', 'p1*']))
                H_bond[b] = Hb if H_bond[b] is None else H_bond[b] + Hb
        return H_bond

    def to_TermList(self):
        terms, strength = [], []
        for i, d in enumerate(self.onsite_terms):
            for op, s in d.items():
                terms.append([(op, i)])
                strength.append(s)
        return TermList(terms, strength)

    def __iadd__(self, other):
        if other.L != self.L:
            raise ValueError("different L")
        for i, d in enumerate(other.onsite_terms):
            for op, s in d.items():
                self.add_onsite_term(s, i, op)
        return self

    def _test_terms(self, sites):
        for i, d in enumerate(self.onsite_terms):
            for op in d:
                if not sites[i].valid_opname(op):
                    raise ValueError(f"unknown op {op!r} on site {i}")


class CouplingTerms:
    """Two-site terms, as the nested dict
    ``coupling_terms[i][(op_i, op_string)][j][op_j] = strength``."""

    def __init__(self, L):
        assert L > 0
        self.L = L
        self.coupling_terms = {}

    def max_range(self):
        return max((j - i for i, d1 in self.coupling_terms.items()
                    for d2 in d1.values() for j in d2), default=0)

    def add_coupling_term(self, strength, i, j, op_i, op_j, op_string='Id'):
        """Add ``strength * op_i_{i} op_string ... op_j_{j}``,
        ``0 <= i < j``."""
        if not 0 <= i < self.L:
            raise ValueError(f"i={i} out of range")
        if not i < j:
            raise ValueError("need i < j")
        d3 = self.coupling_terms.setdefault(i, {}).setdefault(
            (op_i, op_string), {}).setdefault(j, {})
        d3[op_j] = d3.get(op_j, 0) + strength

    def coupling_term_handle_JW(self, strength, term, sites, op_string=None):
        """The Jordan-Wigner string of a two-site term; returns the
        arguments of :meth:`add_coupling_term`."""
        L = self.L
        (op_i, i), (op_j, j) = term
        site_i = sites[i % L]
        need_i = site_i.op_needs_JW(op_i)
        need_j = sites[j % L].op_needs_JW(op_j)
        if op_string is None:
            if need_i and need_j:
                op_string = 'JW'
            elif need_i or need_j:
                raise ValueError("only one operator needs a JW string?!")
            else:
                op_string = 'Id'
        if op_string == 'JW':
            op_i = site_i.multiply_op_names([op_i, op_string])
        return strength, i, j, op_i, op_j, op_string

    def add_to_graph(self, graph):
        """Insert every coupling into an MPOGraph (states keyed by
        ``(i, op_i, op_string)``)."""
        for i, d1 in self.coupling_terms.items():
            for (op_i, op_string), d2 in d1.items():
                label = (i, op_i, op_string)
                graph.add(i, 'IdL', label, op_i, 1., skip_existing=True)
                for j, d3 in d2.items():
                    label_j = graph.add_string_left_to_right(i, j, label,
                                                             op_string)
                    for op_j, strength in d3.items():
                        graph.add(j, label_j, 'IdR', op_j, strength)

    def to_nn_bond_Arrays(self, sites):
        """Bond operators ``H_bond[j]`` on sites ``(j-1, j)`` (range 1)."""
        L = self.L
        H_bond = [None] * L
        for i, d1 in self.coupling_terms.items():
            for (op_i, op_string), d2 in d1.items():
                for j, d3 in d2.items():
                    if j != i + 1:
                        raise ValueError("not nearest neighbor")
                    H = None
                    for op_j, strength in d3.items():
                        term = npc.outer(
                            (strength * sites[i % L].get_op(op_i))
                            .replace_labels(['p', 'p*'], ['p0', 'p0*']),
                            sites[j % L].get_op(op_j).replace_labels(
                                ['p', 'p*'], ['p1', 'p1*']))
                        H = term if H is None else H + term
                    b = j % L
                    H_bond[b] = H if H_bond[b] is None else H_bond[b] + H
        return H_bond

    def remove_zeros(self, tol_zero=1e-15):
        for i in list(self.coupling_terms):
            d1 = self.coupling_terms[i]
            for key in list(d1):
                d2 = d1[key]
                for j in list(d2):
                    d3 = d2[j]
                    for op in [op for op, s in d3.items()
                               if abs(s) < tol_zero]:
                        del d3[op]
                    if not d3:
                        del d2[j]
                if not d2:
                    del d1[key]
            if not d1:
                del self.coupling_terms[i]

    def to_TermList(self):
        terms, strength = [], []
        for i in sorted(self.coupling_terms):
            d1 = self.coupling_terms[i]
            for op_i, op_string in d1:
                d2 = d1[(op_i, op_string)]
                for j in sorted(d2):
                    for op_j, s in d2[j].items():
                        terms.append([(op_i, i), (op_j, j)])
                        strength.append(s)
        return TermList(terms, strength)

    def __iadd__(self, other):
        if other.L != self.L:
            raise ValueError("different L")
        if isinstance(other, MultiCouplingTerms) and \
                not isinstance(self, MultiCouplingTerms):
            raise ValueError("can't add MultiCouplingTerms into "
                             "CouplingTerms")
        for i, d1 in other.coupling_terms.items():
            for (op_i, op_string), d2 in d1.items():
                for j, d3 in d2.items():
                    for op_j, s in d3.items():
                        self.add_coupling_term(s, i, j, op_i, op_j, op_string)
        return self

    def _test_terms(self, sites):
        L = self.L
        for i, d1 in self.coupling_terms.items():
            for (op_i, op_string), d2 in d1.items():
                if not sites[i % L].valid_opname(op_i):
                    raise ValueError(f"unknown op {op_i!r} on site {i}")
                for j, d3 in d2.items():
                    for op_j in d3:
                        if not sites[j % L].valid_opname(op_j):
                            raise ValueError(f"unknown op {op_j!r} on site "
                                             f"{j}")


class MultiCouplingTerms(CouplingTerms):
    """Coupling terms of any number of operators.

    Terms of three or more operators are stored flat, ``multi_terms =
    [(strength, ijkl, ops, op_strings)]``; :meth:`add_to_graph` keys the
    MPO states by each term's growing prefix, so terms that share a prefix
    share its states (as an explicit tree of prefixes would).  Two-operator
    terms go to the nested dict of :class:`CouplingTerms`.
    """

    def __init__(self, L):
        super().__init__(L)
        self.multi_terms = []

    def max_range(self):
        return max([super().max_range()]
                   + [ijkl[-1] - ijkl[0] for _, ijkl, _, _ in
                      self.multi_terms])

    def add_multi_coupling_term(self, strength, ijkl, ops_ijkl,
                                op_string='Id'):
        """Add ``strength * prod_k ops_ijkl[k]_{ijkl[k]}``, ``ijkl``
        strictly ascending; ``op_string`` one name or one per gap."""
        if len(ijkl) < 2:
            raise ValueError("term with fewer than 2 operators: use "
                             "add_onsite_term")
        if any(i >= j for i, j in zip(ijkl, ijkl[1:])):
            raise ValueError("ijkl must be strictly ascending")
        if not 0 <= ijkl[0] < self.L:
            raise ValueError("first operator outside unit cell")
        op_strings = [op_string] * (len(ijkl) - 1) \
            if isinstance(op_string, str) else list(op_string)
        if len(ijkl) == 2:
            self.add_coupling_term(strength, ijkl[0], ijkl[1], ops_ijkl[0],
                                   ops_ijkl[1], op_strings[0])
            return
        self.multi_terms.append((strength, tuple(int(x) for x in ijkl),
                                 tuple(ops_ijkl), tuple(op_strings)))

    def multi_coupling_term_handle_JW(self, strength, term, sites,
                                      op_string=None):
        """The Jordan-Wigner strings of a multi-site term; returns the
        arguments of :meth:`add_multi_coupling_term`."""
        L = self.L
        n = len(term)
        if n < 2:
            raise ValueError("got onsite term instead of coupling")
        if op_string == 'JW':
            warnings.warn("op_string='JW' is probably not what you want!")
        ops = [t[0] for t in term]
        ijkl = [t[1] for t in term]
        assert all(i < j for i, j in zip(ijkl, ijkl[1:]))
        needs = [sites[i % L].op_needs_JW(op) for op, i in term]
        if not any(needs):
            op_string = 'Id'
        i0 = ijkl[0]
        if not 0 <= i0 < L:
            ijkl = [i + i0 % L - i0 for i in ijkl]
        if op_string is not None:
            return strength, ijkl, ops, [op_string] * (n - 1)
        new_op_str = []
        JW_right = False
        for x in range(n):
            if needs[x]:
                JW_right = not JW_right
            if JW_right:
                new_op_str.append('JW')
                ops[x] = sites[ijkl[x] % L].multiply_op_names([ops[x], 'JW'])
            else:
                new_op_str.append('Id')
        if JW_right:
            raise ValueError("odd number of Jordan-Wigner strings")
        new_op_str.pop()
        return strength, ijkl, ops, new_op_str

    def add_to_graph(self, graph):
        super().add_to_graph(graph)
        for strength, ijkl, ops, op_strings in self.multi_terms:
            key = ('multi', ijkl[0], ops[0], op_strings[0])
            graph.add(ijkl[0], 'IdL', key, ops[0], 1., skip_existing=True)
            for k in range(1, len(ijkl)):
                key = graph.add_string_left_to_right(ijkl[k - 1], ijkl[k],
                                                     key, op_strings[k - 1])
                if k == len(ijkl) - 1:
                    graph.add(ijkl[k], key, 'IdR', ops[k], strength)
                else:
                    new_key = key + (ijkl[k], ops[k], op_strings[k])
                    graph.add(ijkl[k], key, new_key, ops[k], 1.,
                              skip_existing=True)
                    key = new_key

    def remove_zeros(self, tol_zero=1e-15):
        super().remove_zeros(tol_zero)
        self.multi_terms = [t for t in self.multi_terms
                            if abs(t[0]) >= tol_zero]

    def to_TermList(self):
        tl = super().to_TermList()
        terms, strength = list(tl.terms), list(tl.strength)
        for s, ijkl, ops, _ in self.multi_terms:
            terms.append([(op, i) for op, i in zip(ops, ijkl)])
            strength.append(s)
        return TermList(terms, strength)

    def __iadd__(self, other):
        super().__iadd__(other)
        if isinstance(other, MultiCouplingTerms):
            self.multi_terms.extend(other.multi_terms)
        return self

    def _test_terms(self, sites):
        super()._test_terms(sites)
        L = self.L
        for _, ijkl, ops, _ in self.multi_terms:
            for op, i in zip(ops, ijkl):
                if not sites[i % L].valid_opname(op):
                    raise ValueError(f"unknown op {op!r} on site {i}")


class ExponentiallyDecayingTerms:
    r"""Long-range couplings
    ``strength * sum_{i<j} lambda^{j-i} A_{subsites[i]} B_{subsites[j]}``,
    one extra MPO bond state per term."""

    def __init__(self, L):
        assert L > 0
        self.L = L
        self.exp_decaying_terms = []

    @property
    def is_empty(self):
        return len(self.exp_decaying_terms) == 0

    def add_exponentially_decaying_coupling(self, strength, lambda_, op_i,
                                            op_j, subsites=None,
                                            subsites_start=None,
                                            op_string='Id'):
        if subsites is None:
            subsites = np.arange(self.L)
        else:
            subsites = np.asarray(subsites)
            if len(subsites) > 1 and np.any(subsites[1:] < subsites[:-1]):
                raise ValueError("subsites must be sorted")
        subsites_start = subsites if subsites_start is None \
            else np.asarray(subsites_start)
        self.exp_decaying_terms.append((strength, lambda_, op_i, op_j,
                                        subsites, subsites_start, op_string))

    def add_to_graph(self, graph, key='exp-decay'):
        """One bond state per term carrying the decaying string."""
        for t_idx, (strength, lambda_, op_i, op_j, subsites, subsites_start,
                    op_string) in enumerate(self.exp_decaying_terms):
            label = (key, t_idx)
            subset = set(int(x) for x in subsites)
            subset_start = set(int(x) for x in subsites_start)
            if graph.bc == 'finite':
                first = int(min(min(subsites), min(subsites_start)))
                last = int(max(subsites))
                for x in range(first, last + 1):
                    if x in subset_start and x < last:
                        graph.add(x, 'IdL', label, op_i, strength,
                                  skip_existing=False)
                    if x > first:
                        if x in subset:
                            graph.add(x, label, 'IdR', op_j, lambda_)
                        if x < last:
                            graph.add(x, label, label,
                                      op_string if x in subset else 'Id',
                                      lambda_ if x in subset else 1.,
                                      skip_existing=True)
            else:
                for x in range(self.L):
                    if x in subset_start:
                        graph.add(x, 'IdL', label, op_i, strength,
                                  skip_existing=False)
                    if x in subset:
                        graph.add(x, label, 'IdR', op_j, lambda_)
                        graph.add(x, label, label, op_string, lambda_,
                                  skip_existing=True)
                    else:
                        graph.add(x, label, label, 'Id', 1.,
                                  skip_existing=True)

    def to_TermList(self, cutoff=0.01, bc='finite'):
        """The terms with ``lambda^(j-i) > cutoff`` written out."""
        terms, strength = [], []
        L = self.L
        for (s, lambda_, op_i, op_j, subsites, _,
             _) in self.exp_decaying_terms:
            max_d = int(np.ceil(np.log(cutoff) / np.log(abs(lambda_)))) \
                if abs(lambda_) < 1 else L
            sub = list(subsites)
            for a, i in enumerate(sub):
                for d in range(1, max_d + 1):
                    if a + d >= len(sub):
                        if bc == 'finite':
                            break
                        j = sub[(a + d) % len(sub)] + L * ((a + d)
                                                           // len(sub))
                    else:
                        j = sub[a + d]
                    terms.append([(op_i, i), (op_j, j)])
                    strength.append(s * lambda_ ** d)
        return TermList(terms, strength)

    def max_range(self):
        return 0 if self.is_empty else self.L

    def __iadd__(self, other):
        if other.L != self.L:
            raise ValueError("different L")
        self.exp_decaying_terms.extend(other.exp_decaying_terms)
        return self

    def _test_terms(self, sites):
        for (_, _, op_i, op_j, subsites, _,
             _) in self.exp_decaying_terms:
            for u in subsites:
                site = sites[u % len(sites)]
                if not site.valid_opname(op_i) or \
                        not site.valid_opname(op_j):
                    raise ValueError(f"unknown ops {op_i!r}/{op_j!r}")
