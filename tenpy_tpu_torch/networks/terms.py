r"""Hamiltonian terms on the way from the model DSL to the MPO.

Port of ``OnsiteTerms``, ``CouplingTerms`` and ``order_combine_term`` from
``tenpy_tpu/networks/terms.py``.  Couplings are stored with ``i < j``; for
infinite systems ``j`` may exceed ``L`` (a coupling across the unit-cell
boundary); fermionic terms carry the Jordan-Wigner strings that
``Site.op_needs_JW`` asks for.  ``MultiCouplingTerms``, ``TermList`` and
``ExponentiallyDecayingTerms`` are not ported.
"""

from __future__ import annotations

from ..linalg import np_conserved as npc

__all__ = ['OnsiteTerms', 'CouplingTerms', 'order_combine_term']


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

    def __iadd__(self, other):
        if other.L != self.L:
            raise ValueError("different L")
        for i, d in enumerate(other.onsite_terms):
            for op, s in d.items():
                self.add_onsite_term(s, i, op)
        return self


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
        """Add ``strength * op_i_{i} op_string ... op_j_{j}``, ``0 <= i < j``."""
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

    def __iadd__(self, other):
        if other.L != self.L:
            raise ValueError("different L")
        for i, d1 in other.coupling_terms.items():
            for (op_i, op_string), d2 in d1.items():
                for j, d3 in d2.items():
                    for op_j, s in d3.items():
                        self.add_coupling_term(s, i, j, op_i, op_j, op_string)
        return self
