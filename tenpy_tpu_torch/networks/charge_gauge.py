r"""The charge gauge of an infinite MPS: relabellings of its U(1) bookkeeping.

Port of the gauge functions of ``tenpy_tpu/algorithms/packed_dmrg.py``.
None of them touches a block or a Schmidt value: they shift the bond
charges (:func:`apply_bond_charge_shift`), multiply the charge units
(:func:`scale_psi_charges`, :func:`scale_mpo_charges`), or both, so that
every bond of a unit cell sits in one charge frame
(:func:`uniformize_charge_gauge`).  The device engine applies them before
packing; :func:`~tenpy_tpu_torch.networks.exchange.load_mps` inverts a
stored gauge.
"""

from __future__ import annotations

import copy
from math import gcd

import numpy as np

from ..linalg.charges import QTYPE, LegCharge

__all__ = ['apply_bond_charge_shift', 'scale_psi_charges',
           'scale_mpo_charges', 'uniformize_charge_gauge']


def apply_bond_charge_shift(psi, o):
    """``q_bond[j] -> q_bond[j] - o_j`` on every bond leg of an infinite MPS,
    with the site qtotals adjusted so every tensor stays charge-consistent.
    A gauge of the bookkeeping (no data touched); ``-o`` inverts it."""
    L = psi.L
    chinfo = psi._B[0].legs[0].chinfo
    new_bond_leg = {}

    def shifted(leg, j):
        key = (id(leg), j % L)
        if key not in new_bond_leg:
            new_bond_leg[key] = LegCharge(
                leg.chinfo, leg.slices,
                chinfo.make_valid(np.asarray(leg.charges, QTYPE) - o[j % L]),
                leg.qconj)
        return new_bond_leg[key]

    for i in range(L):
        B = psi._B[i]
        iL = B.get_leg_index('vL')
        iR = B.get_leg_index('vR')
        legs = list(B.legs)
        delta = (-o[i % L] * legs[iL].qconj
                 - o[(i + 1) % L] * legs[iR].qconj)
        legs[iL] = shifted(legs[iL], i)
        legs[iR] = shifted(legs[iR], i + 1)
        B.legs = tuple(legs)
        B.qtotal = tuple(int(q) for q in chinfo.make_valid(
            np.asarray(B.qtotal, QTYPE) + delta))


def scale_psi_charges(psi, k, div=False, sites=True):
    """Multiply (or exactly divide, ``div=True``) every U(1) charge of an
    MPS by per-charge integer factors ``k``: leg charges, qtotals and the
    sites' physical legs.  A relabelling of the bookkeeping that makes
    fractional per-site charges (``Q % L != 0``) integer.  In place;
    ``psi.sites`` become shallow copies carrying the rescaled leg (with
    ``sites=False`` they are left as they are: the caller restores its
    own)."""
    k = np.asarray(k, QTYPE)
    if np.all(k == 1):
        return
    seen = {}

    def scaled(leg):
        key = id(leg)
        if key not in seen:
            q = np.asarray(leg.charges, QTYPE)
            if div:
                if np.any(q % k != 0):
                    raise ValueError("charge not divisible on unscale")
                q = q // k
            else:
                q = q * k
            seen[key] = LegCharge(leg.chinfo, leg.slices, q, leg.qconj)
        return seen[key]

    for B in psi._B:
        B.legs = tuple(scaled(l) for l in B.legs)
        qt = np.asarray(B.qtotal, QTYPE).ravel()
        if div:
            if np.any(qt % k != 0):
                raise ValueError("qtotal not divisible on unscale")
            qt = qt // k
        else:
            qt = qt * k
        B.qtotal = tuple(int(q) for q in qt)
    if not sites:
        return
    new_sites = []
    for s in psi.sites:
        s2 = copy.copy(s)
        s2.leg = scaled(s.leg)
        new_sites.append(s2)
    psi.sites = new_sites


def scale_mpo_charges(H, k):
    """A shallow copy of MPO ``H`` with every U(1) charge multiplied by
    ``k`` (see :func:`scale_psi_charges`); ``H`` itself is untouched."""
    k = np.asarray(k, QTYPE)
    H2 = copy.copy(H)
    if np.all(k == 1):
        return H2
    seen = {}

    def scaled(leg):
        key = id(leg)
        if key not in seen:
            seen[key] = LegCharge(leg.chinfo, leg.slices,
                                  np.asarray(leg.charges, QTYPE) * k,
                                  leg.qconj)
        return seen[key]

    Ws = []
    for i in range(H.L):
        W = H.get_W(i).copy(deep=False)
        W.legs = tuple(scaled(l) for l in W.legs)
        W.qtotal = tuple(int(q) for q in
                         np.asarray(W.qtotal, QTYPE).ravel() * k)
        Ws.append(W)
    H2._W = Ws
    new_sites = []
    for s in H.sites:
        s2 = copy.copy(s)
        s2.leg = scaled(s.leg)
        new_sites.append(s2)
    H2.sites = new_sites
    return H2


def uniformize_charge_gauge(psi, rescale=False):
    """Regauge the charge bookkeeping of an infinite MPS so all bonds match.

    Applies ``q_bond[j] -> q_bond[j] - o_j`` with
    ``o_{j+1} = o_j - qtotal_j + Q/L`` (``Q`` the unit cell's charge), which
    leaves every block and Schmidt value untouched but makes each site's
    ``qtotal`` equal to ``Q/L`` and puts all bond legs into one charge
    frame, so one capacity layout serves every bond.  Only for U(1)
    charges.  Where ``Q`` is not divisible by ``L`` and ``rescale`` is set,
    the charge units are first multiplied by ``k_c = L / gcd(|Q_c|, L)``
    (:func:`scale_psi_charges`).

    Returns None if not applicable, else ``{'k': ..., 'o': [...]}`` (the
    unit scale and the bond offsets applied).  ``psi`` is changed in place.
    """
    if psi.bc == 'finite':
        return None
    L = psi.L
    chinfo = psi.sites[0].leg.chinfo
    nq = chinfo.qnumber
    if nq == 0:
        return {'k': np.ones(0, QTYPE), 'o': [np.zeros(0, QTYPE)] * L}
    if not np.all(np.asarray(chinfo.mod) == 1):
        return None
    qtots = [np.asarray(psi.get_B(i, None).qtotal, QTYPE) for i in range(L)]
    Q = np.sum(qtots, axis=0)
    k = np.ones(nq, QTYPE)
    if np.any(Q % L != 0):
        if not rescale:
            return None
        k = np.array([L // gcd(int(abs(int(q))), L) for q in Q.ravel()],
                     QTYPE)
        scale_psi_charges(psi, k)
        qtots = [q * k for q in qtots]
        Q = Q * k
    qeff = Q // L
    o = [np.zeros_like(qeff)]
    for i in range(L - 1):
        o.append(o[i] - qtots[i] + qeff)
    info = {'k': k, 'o': o}
    if all(np.all(oi == 0) for oi in o):
        return info   # already uniform
    apply_bond_charge_shift(psi, o)
    return info
