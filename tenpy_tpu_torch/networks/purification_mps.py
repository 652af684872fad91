r"""Purification MPS for finite temperature.

Port of ``tenpy_tpu/networks/purification_mps.py``.  Each tensor has the
legs ``vL, p, q, vR``: ``q`` is the ancilla leg that purifies the density
matrix, ``rho = Tr_q |psi><psi|``, and physical operators act on ``p``
only.  The infinite-temperature state is the product of maximally
entangled p-q pairs; imaginary-time evolution by ``exp(-beta H / 2)`` on
the ``p`` legs gives the Gibbs state at inverse temperature ``beta``
(:class:`~tenpy_tpu_torch.algorithms.purification.PurificationTEBD`).

With ``conserve_ancilla_charge`` the canonical ensemble conserves the
physical and the ancilla charge separately, on a doubled
:class:`~tenpy_tpu_torch.linalg.charges.ChargeInfo`: physical legs carry
``[Q, 0]``, ancilla legs ``[0, Q]`` and bond legs ``[Q, -Q]``;
:func:`convert_model_purification_canonical_conserve_ancilla_charge`
converts the model to match.
"""

from __future__ import annotations

import copy

import numpy as np

from ..linalg import np_conserved as npc
from ..linalg.charges import ChargeInfo, LegCharge
from ..tools.math import entropy
from .mps import MPS

__all__ = ['PurificationMPS',
           'convert_model_purification_canonical_conserve_ancilla_charge']


def _doubled_chinfo(chinfo):
    """A ChargeInfo with a second copy of every charge, for the ancilla."""
    names = list(chinfo.names) + [n + ' ancilla' for n in chinfo.names]
    return ChargeInfo(list(chinfo.mod) * 2, names)


def _doubled_leg(leg, chinfo2, which):
    """``leg`` in the doubled charges: ``[Q, 0]`` for ``which='p'``,
    ``[0, Q]`` for ``'q'`` and ``[Q, -Q]`` for ``'bond'`` (the bond legs
    carry the opposite ancilla flow, so that ``delta_{p,q}`` tensors have
    charge 0)."""
    Q = np.asarray(leg.charges)
    if which == 'p':
        Q2 = np.hstack([Q, np.zeros_like(Q)])
    elif which == 'q':
        Q2 = np.hstack([np.zeros_like(Q), Q])
    else:
        Q2 = np.hstack([Q, -Q])
    return LegCharge(chinfo2, leg.slices, chinfo2.make_valid(Q2), leg.qconj)


class PurificationMPS(MPS):
    """An MPS with a physical leg ``p`` and an ancilla leg ``q`` per site;
    canonical forms treat ``(p, q)`` as one physical leg."""

    _p_label = ['p', 'q']

    def test_sanity(self):
        assert len(self._B) == self.L
        assert len(self._S) == self.L + 1
        for B in self._B:
            assert set(B.get_leg_labels()) == {'vL', 'p', 'q', 'vR'}

    @classmethod
    def from_infiniteT(cls, sites, bc='finite', form='B', dtype=np.float64):
        """The infinite-temperature state: on every site
        ``delta_{p,q} / sqrt(d)``, bond dimension 1."""
        sites = list(sites)
        legL = LegCharge.from_trivial(1, sites[0].leg.chinfo, qconj=+1)
        Bs = []
        for site in sites:
            d = site.dim
            B = np.eye(d).reshape(1, d, d, 1) / np.sqrt(d)
            Bs.append(npc.Array.from_ndarray(
                B, [legL, site.leg, site.leg.conj(), legL.conj()],
                dtype=dtype, labels=['vL', 'p', 'q', 'vR'],
                warn_wrong_sector=False))
        res = cls.__new__(cls)
        MPS.__init__(res, sites, Bs, [np.ones(1)] * (len(sites) + 1), bc=bc,
                     form=form)
        return res

    @classmethod
    def from_infiniteT_canonical(cls, sites, charge_sector, dtype=np.float64,
                                 conserve_ancilla_charge=False):
        r"""The infinite-temperature state of the canonical ensemble: equal
        weight on every basis state of total charge ``charge_sector``
        (finite bc): ``B[vL, p, q, vR] = delta_{p,q} delta_{Q(vL) + Q(p),
        Q(vR)}`` with bond legs enumerating the partial charges that are
        reachable from both ends.

        With ``conserve_ancilla_charge`` the charges are doubled (see the
        module docstring): the state's ``sites`` are then converted copies,
        and the model needs
        :func:`convert_model_purification_canonical_conserve_ancilla_charge`.
        """
        sites = list(sites)
        L = len(sites)
        chinfo = sites[0].leg.chinfo
        charge_sector = tuple(int(q) for q in
                              chinfo.make_valid(charge_sector))
        site_charges = []
        for s in sites:
            leg = s.leg
            qflat = np.asarray(leg.to_qflat()) * leg.qconj
            site_charges.append([tuple(int(x) for x in qflat[i])
                                 for i in range(s.dim)])
        fwd = [{tuple([0] * chinfo.qnumber)}]
        for i in range(L):
            fwd.append({tuple(chinfo.make_valid(np.asarray(q)
                                                + np.asarray(qp)))
                        for q in fwd[-1] for qp in site_charges[i]})
        bwd = [None] * (L + 1)
        bwd[L] = {charge_sector}
        for i in range(L - 1, -1, -1):
            bwd[i] = {tuple(chinfo.make_valid(np.asarray(q) - np.asarray(qp)))
                      for q in bwd[i + 1] for qp in site_charges[i]}
        keep = [sorted(fwd[i] & bwd[i]) for i in range(L + 1)]
        if not keep[0] or not keep[L]:
            raise ValueError(f"charge sector {charge_sector} unreachable")

        def v_qflat(k):
            return np.array(k, np.int64).reshape(len(k), chinfo.qnumber)

        if conserve_ancilla_charge:
            chinfo2 = _doubled_chinfo(chinfo)
            legs_v = [LegCharge.from_qflat(
                chinfo2, chinfo2.make_valid(np.hstack([v_qflat(k),
                                                       -v_qflat(k)])),
                qconj=+1) for k in keep]
            sites = [copy.copy(s) for s in sites]
            for s in sites:
                s.change_charge(_doubled_leg(s.leg, chinfo2, 'p'))
        else:
            legs_v = [LegCharge.from_qflat(chinfo, v_qflat(k), qconj=+1)
                      for k in keep]
        Bs = []
        for i, site in enumerate(sites):
            d = site.dim
            idxR = {q: b for b, q in enumerate(keep[i + 1])}
            dense = np.zeros((len(keep[i]), d, d, len(keep[i + 1])))
            for a, qL in enumerate(keep[i]):
                for p in range(d):
                    qR = tuple(chinfo.make_valid(
                        np.asarray(qL) + np.asarray(site_charges[i][p])))
                    b = idxR.get(qR)
                    if b is not None:
                        dense[a, p, p, b] = 1.
            if conserve_ancilla_charge:
                # the ancilla leg carries [0, Q_p] with qconj -1: physical
                # and ancilla charge are then conserved separately, and the
                # delta_{p,q} entries have charge 0
                Qp = np.asarray(site.leg.charges)[:, :chinfo.qnumber]
                q_leg = LegCharge(
                    chinfo2, site.leg.slices,
                    chinfo2.make_valid(np.hstack([np.zeros_like(Qp), Qp])),
                    -1)
            else:
                q_leg = LegCharge.from_trivial(d, chinfo, qconj=-1)
            Bs.append(npc.Array.from_ndarray(
                dense, [legs_v[i], site.leg, q_leg, legs_v[i + 1].conj()],
                dtype=dtype, labels=['vL', 'p', 'q', 'vR'],
                warn_wrong_sector=False))
        SVs = [np.ones(l.ind_len) / np.sqrt(l.ind_len) for l in legs_v]
        res = cls.__new__(cls)
        MPS.__init__(res, sites, Bs, SVs, bc='finite', form=None)
        res.canonical_form_finite(renormalize=True)
        return res

    @classmethod
    def from_density_matrix(cls, sites, rho, cutoff=1e-16, normalize=True):
        r"""The purification of a full density matrix ``rho`` (labels
        ``p0, p0*, ..., p{L-1}, p{L-1}*``; finite bc): from ``rho = U D
        U^dagger``, ``|psi> = sum_k sqrt(D_k) U_ik conj(U_jk) |i>_p
        |j>_q``, split into sites by successive SVDs."""
        L = len(sites)
        rho = rho.combine_legs([[f'p{i}' for i in range(L)],
                                [f'p{i}*' for i in range(L)]],
                               qconj=[+1, -1])
        D, U = npc.eigh(rho)
        if np.any(D < -1e-12):
            raise ValueError("density matrix is not positive semi-definite")
        D = np.where(D < 0, 0., D)
        psi = npc.tensordot(U.scale_axis(np.sqrt(D), 1), U.conj(),
                            axes=[[1], [1]])
        psi.iset_leg_labels(['(' + '.'.join(f'p{i}' for i in range(L)) + ')',
                             '(' + '.'.join(f'p{i}*' for i in range(L))
                             + ')'])
        psi = psi.split_legs()
        psi.ireplace_labels([f'p{i}*' for i in range(L)],
                            [f'q{i}' for i in range(L)])
        triv = LegCharge.from_trivial(1, sites[0].leg.chinfo, qconj=+1)
        psi = psi.add_leg(triv, 0, axis=0, label='vL')
        psi = psi.add_leg(triv.conj(), 0, axis=psi.rank, label='vR')
        Bs = [None] * L
        SVs = [np.ones(1)] * (L + 1)
        rest = psi
        for i in range(L - 1, 0, -1):
            legsL = ['vL'] + [x for k in range(i) for x in (f'p{k}', f'q{k}')]
            mat = rest.combine_legs([legsL, [f'p{i}', f'q{i}', 'vR']],
                                    qconj=[+1, -1])
            Uc, S, VH = npc.svd(mat, cutoff=cutoff if cutoff else None,
                                inner_labels=['vR', 'vL'])
            nrm = np.linalg.norm(S)
            Bs[i] = VH.split_legs([1]).ireplace_labels([f'p{i}', f'q{i}'],
                                                       ['p', 'q'])
            SVs[i] = S / nrm
            rest = Uc.split_legs([0]).iscale_axis(S, 'vR')
        Bs[0] = rest.ireplace_labels(['p0', 'q0'], ['p', 'q'])
        res = cls.__new__(cls)
        MPS.__init__(res, sites, Bs, SVs, bc='finite', form='B')
        res.canonical_form_finite(renormalize=normalize)
        if normalize:
            res.norm = 1.
        return res

    # ------------------------------------------------------------ overrides
    def get_theta(self, i, n=2, cutoff=1e-16, formL=1., formR=1.):
        """The ``n``-site wave function, labels ``vL, p0, q0, ...,
        p{n-1}, q{n-1}, vR``."""
        i = self._to_valid_index(i)
        theta = self.get_B(i, (formL, 1.) if n > 1 else (formL, formR),
                           copy=True, cutoff=cutoff)
        theta.ireplace_labels(['p', 'q'], ['p0', 'q0'])
        for k in range(1, n):
            B = self.get_B(i + k, (0., 1.) if k < n - 1 else (0., formR),
                           copy=True, cutoff=cutoff)
            B.ireplace_labels(['p', 'q'], [f'p{k}', f'q{k}'])
            theta = npc.tensordot(theta, B, axes=[['vR'], ['vL']])
        return theta

    def expectation_value(self, ops, sites=None):
        """``<psi|op_i|psi>`` per site, one-site operators on ``p`` (the
        ancilla traced out)."""
        if isinstance(ops, (str, npc.Array)):
            ops = [ops]
        if sites is None:
            sites = range(self.L)
        res = []
        for i in sites:
            theta = self.get_theta(i, 1)
            val = npc.tensordot(self.get_op(ops, i), theta,
                                axes=[['p*'], ['p0']])
            val = npc.tensordot(
                theta.conj(), val,
                axes=[['vL*', 'p0*', 'q0*', 'vR*'], ['vL', 'p', 'q0', 'vR']])
            res.append(complex(val))
        res = np.array(res)
        if np.allclose(res.imag, 0., atol=1e-14):
            res = res.real
        return res

    def expectation_value_multi_sites(self, operators, i0):
        """``<psi| op_0 op_1 ... |psi>`` for operators on the ``p`` legs of
        the consecutive sites ``i0, i0 + 1, ...``."""
        ops = [self.get_op([op], i0 + k) if isinstance(op, str) else op
               for k, op in enumerate(operators)]
        theta = self.get_theta(i0, len(ops))
        ctheta = theta.conj()
        for k, op in enumerate(ops):
            theta = npc.tensordot(op, theta, axes=[['p*'], [f'p{k}']])
            theta.ireplace_label('p', f'p{k}')
        n = len(ops)
        legs = ['vL', 'vR'] + [f'p{k}' for k in range(n)] + \
            [f'q{k}' for k in range(n)]
        return complex(npc.tensordot(ctheta, theta,
                                     axes=[[l + '*' for l in legs], legs]))

    def norm_test(self):
        """The isometry errors of the A and B forms of every site, an
        ``(L, 2)`` array."""
        res = np.empty((self.L, 2))
        for i in range(self.L):
            A = self.get_B(i, 'A')
            c = npc.tensordot(A.conj(), A,
                              axes=[['vL*', 'p*', 'q*'], ['vL', 'p', 'q']])
            res[i, 0] = npc.norm(c - npc.eye_like(c, 0))
            B = self.get_B(i, 'B')
            c = npc.tensordot(B, B.conj(),
                              axes=[['p', 'q', 'vR'], ['p*', 'q*', 'vR*']])
            res[i, 1] = npc.norm(c - npc.eye_like(c, 0))
        return res

    def get_rho_segment(self, segment):
        """The reduced density matrix of the sites ``segment`` on both the
        ``p`` and ``q`` legs (labels ``p0, q0, p0*, q0*, ...``); sites
        between them are traced over both."""
        segment = np.sort(np.asarray(segment, int))
        if len(segment) > 10:
            raise ValueError("segment too large: exponentially expensive")
        if np.all(segment[1:] == segment[:-1] + 1):
            theta = self.get_theta(int(segment[0]),
                                   int(segment[-1] - segment[0] + 1))
            return npc.tensordot(theta, theta.conj(),
                                 axes=[['vL', 'vR'], ['vL*', 'vR*']])
        rho = self.get_theta(int(segment[0]), 1)
        rho = npc.tensordot(rho, rho.conj(), axes=[['vL'], ['vL*']])
        k = 1
        for i in range(int(segment[0]) + 1, int(segment[-1])):
            B = self.get_B(i, 'B')
            if i == segment[k]:
                B = B.replace_labels(['p', 'q'], [f'p{k}', f'q{k}'])
                k += 1
                rho = npc.tensordot(rho, B, axes=[['vR'], ['vL']])
                rho = npc.tensordot(rho, B.conj(), axes=[['vR*'], ['vL*']])
            else:
                rho = npc.tensordot(rho, B, axes=[['vR'], ['vL']])
                rho = npc.tensordot(rho, B.conj(),
                                    axes=[['vR*', 'p', 'q'],
                                          ['vL*', 'p*', 'q*']])
        B = self.get_B(int(segment[-1]), 'B').replace_labels(
            ['p', 'q'], [f'p{k}', f'q{k}'])
        rho = npc.tensordot(rho, B, axes=[['vR'], ['vL']])
        return npc.tensordot(rho, B.conj(),
                             axes=[['vR*', 'vR'], ['vL*', 'vR*']])

    @staticmethod
    def _pq_tr_comb(legs, N):
        """The (traced, combined) label pairs of ``N`` sites for the
        physical (``legs='p'``), ancilla (``'q'``) or both (``'pq'``)
        spaces."""
        def labels(choice):
            return ([c + str(k) for k in range(N) for c in choice],
                    [c + str(k) + '*' for k in range(N) for c in choice])

        if legs == 'pq':
            return ([], []), labels(['p', 'q'])
        if legs == 'p':
            return labels(['q']), labels(['p'])
        if legs == 'q':
            return labels(['p']), labels(['q'])
        raise ValueError(f"legs must be 'p', 'q' or 'pq', got {legs!r}")

    def _rho_entropy(self, segment, tr_legs, comb_legs, n):
        rho = self.get_rho_segment(segment)
        for a, b in zip(*tr_legs):
            rho = npc.trace(rho, a, b)
        rho = rho.combine_legs(comb_legs, qconj=[+1, -1])
        return entropy(npc.eigvalsh(rho), n)

    def entanglement_entropy_segment(self, segment=(0,), first_site=None,
                                     n=1, legs='p'):
        """The entropy of the segment's reduced density matrix in the
        physical (``legs='p'``), ancilla (``'q'``) or combined (``'pq'``)
        space, for the segment shifted to start at each of
        ``first_site``."""
        segment = np.sort(np.asarray(segment, int))
        if first_site is None:
            first_site = range(0, self.L - segment[-1]) if self.finite \
                else range(self.L)
        tr_legs, comb_legs = self._pq_tr_comb(legs, len(segment))
        return np.array([self._rho_entropy(segment + i0, tr_legs, comb_legs,
                                           n) for i0 in first_site])

    def mutinf_two_site(self, max_range=None, n=1, legs='p'):
        """The mutual information ``S(i) + S(j) - S(i, j)`` of every pair
        ``i < j`` at most ``max_range`` apart, in the chosen space:
        ``(coords, mutinf)``."""
        if max_range is None:
            max_range = self.L
        S_i = self.entanglement_entropy_segment(n=n, legs=legs)
        tr_legs, comb_legs = self._pq_tr_comb(legs, 2)
        mutinf, coords = [], []
        for i in range(self.L):
            jmax = i + max_range + 1
            if self.finite:
                jmax = min(jmax, self.L)
            for j in range(i + 1, jmax):
                S_ij = self._rho_entropy([i, j], tr_legs, comb_legs, n)
                mutinf.append(S_i[i] + S_i[j % self.L] - S_ij)
                coords.append((i, j))
        return np.array(coords), np.array(mutinf)

    def canonical_form_finite(self, renormalize=True, cutoff=0.):
        """QR sweep left to right, then SVD sweep right to left, with
        ``(p, q)`` as one physical leg; every tensor ends in B form."""
        L = self.L
        Ms = self._stripped_tensors()
        R = None
        for i in range(L):
            M = Ms[i]
            if R is not None:
                M = npc.tensordot(R, M, axes=[['vR'], ['vL']])
            Q, R = npc.qr(M.combine_legs([['vL', 'p', 'q']]),
                          inner_labels=['vR', 'vL'])
            Ms[i] = Q.split_legs([0])
        norm_fact = npc.norm(R)
        self.norm = 1. if renormalize else self.norm * norm_fact
        M = npc.tensordot(Ms[L - 1], R / norm_fact, axes=[['vR'], ['vL']])
        self.set_SR(L - 1, np.ones(M.get_leg('vR').ind_len))
        for i in range(L - 1, 0, -1):
            U, S, VH = npc.svd(M.combine_legs([['p', 'q', 'vR']],
                                              qconj=[-1]),
                               cutoff=cutoff if cutoff else None,
                               inner_labels=['vR', 'vL'])
            S = S / np.linalg.norm(S)
            self._B[i] = VH.split_legs([1])
            self.form[i] = self._valid_forms['B']
            self.set_SL(i, S)
            M = npc.tensordot(Ms[i - 1], U.iscale_axis(S, 'vR'),
                              axes=[['vR'], ['vL']])
        self._B[0] = M.copy(deep=False).iscale_axis(
            self._scale_S(self.get_SL(0), -1.), 'vL')
        self.form[0] = self._valid_forms['B']
        return self


def convert_model_purification_canonical_conserve_ancilla_charge(model):
    """A shallow copy of ``model`` with its charges doubled for
    ``from_infiniteT_canonical(..., conserve_ancilla_charge=True)``: site
    legs ``[Q, 0]``, the MPO's ``wL``/``wR`` legs ``[Q, -Q]`` and the
    ``qtotal`` of every W and bond Hamiltonian ``[Q, 0]``, so ``H_MPO``
    and ``H_bond`` act on the physical half and are neutral in the
    ancilla half."""
    model = model.copy()
    chinfo2 = _doubled_chinfo(model.lat.unit_cell[0].leg.chinfo)
    converted = {}

    def conv_site(site):
        s2 = converted.get(id(site))
        if s2 is None:
            s2 = copy.copy(site)
            s2.change_charge(_doubled_leg(site.leg, chinfo2, 'p'))
            converted[id(site)] = s2
        return s2

    def doubled_qtotal(qt):
        qt = np.asarray(qt)
        return tuple(int(q) for q in
                     chinfo2.make_valid(np.hstack([qt, np.zeros_like(qt)])))

    model.lat = copy.copy(model.lat)
    model.lat.unit_cell = [conv_site(s) for s in model.lat.unit_cell]
    if hasattr(model, 'H_MPO'):
        H = model.H_MPO.copy()
        H.sites = [conv_site(s) for s in H.sites]
        H.chinfo = chinfo2
        Ws = []
        for W in H._W:
            W = W.copy(deep=False).itranspose(['wL', 'wR', 'p', 'p*'])
            p = _doubled_leg(W.legs[2], chinfo2, 'p')
            W.legs = (_doubled_leg(W.legs[0], chinfo2, 'bond'),
                      _doubled_leg(W.legs[1], chinfo2, 'bond'), p, p.conj())
            W.qtotal = doubled_qtotal(W.qtotal)
            Ws.append(W)
        H._W = Ws
        model.H_MPO = H
    if hasattr(model, 'H_bond'):
        sites = model.lat.mps_sites()
        L = len(sites)
        H_bond = list(model.H_bond)
        for i, Hb in enumerate(H_bond):
            if Hb is None:
                continue
            leg0, leg1 = sites[(i - 1) % L].leg, sites[i].leg
            Hb = Hb.transpose(['p0', 'p1', 'p0*', 'p1*'])
            Hb.legs = (leg0, leg1, leg0.conj(), leg1.conj())
            Hb.qtotal = doubled_qtotal(Hb.qtotal)
            Hb.test_sanity()
            H_bond[i] = Hb
        model.H_bond = H_bond
    return model
