r"""Cylinders in a mixed real- and momentum-space basis.

Port of ``tenpy_tpu/models/mixed_xk.py``: ``MixedXKLattice``,
``MixedXKModel`` (its intra- and inter-ring hoppings and interactions and
the ``real_to_mixed_*`` measurements), ``SpinlessMixedXKSquare`` and
``HubbardMixedXKSquare``; the same terms, added in the same order, give
the same MPO.

The cylinder stays in real space along its axis and is Fourier
transformed around its circumference:

.. math ::
    c^\dagger_{x,k,l} = \frac{1}{\sqrt{L_y}} \sum_y e^{-2\pi i k y / L_y}
                        c^\dagger_{x,y,l}

so one ring is the unit cell of a 1D lattice whose ``Ly * N_orb`` sites
carry the y-momentum ``ky`` as a Z_Ly charge: y-momentum is conserved by
the charge bookkeeping, with many small blocks per tensor.  The square
cylinders' Hamiltonians are real in this basis (``cos k`` and density
terms); the ``real_to_mixed_*`` measurements are complex.
"""

from __future__ import annotations

import itertools

import numpy as np

from .lattice import Lattice
from .model import CouplingMPOModel
from ..linalg.charges import ChargeInfo, LegCharge
from ..networks.site import FermionSite
from ..networks.terms import TermList
from ..tools.misc import to_array

__all__ = ['MixedXKLattice', 'MixedXKModel', 'SpinlessMixedXKSquare',
           'HubbardMixedXKSquare']


class MixedXKLattice(Lattice):
    r"""A cylinder with momentum space around its circumference.

    The unit-cell index ``u = k * N_orb + l`` combines the y-momentum
    ``k`` and the orbital ``l``; the rings repeat along the axis.
    ``ring_order`` permutes the sites within a ring; ``delta_q[q][k1, k2]``
    is ``delta_{(k1 + q) mod Ly, k2}``.
    """

    def __init__(self, N_rings, Ly, N_orb, sites, ring_order=None,
                 orbital_names=None, orbital_values=None, **kwargs):
        self.N_orb = N_orb
        self.Ly = Ly
        self.N_rings = N_rings
        delta_q = np.zeros((Ly, Ly, Ly))
        for q in range(Ly):
            for k1 in range(Ly):
                delta_q[q, k1, (k1 + q) % Ly] = 1.
        self.delta_q = delta_q
        n_ring = Ly * N_orb
        self.ring_order = np.arange(n_ring, dtype=np.intp) \
            if ring_order is None else np.asarray(ring_order, dtype=np.intp)
        kwargs.setdefault('bc', 'periodic')
        kwargs.setdefault('bc_MPS', 'infinite')
        if 'order' in kwargs:
            raise NotImplementedError("use ring_order to change the order")
        super().__init__([N_rings], sites, **kwargs)
        order = np.zeros((self.N_sites, 2), np.intp)
        for x in range(N_rings):
            order[x * n_ring:(x + 1) * n_ring, 0] = x
            order[x * n_ring:(x + 1) * n_ring, 1] = self.ring_order
        self.order = order
        self.orbital_names = orbital_names
        self.orbital_values = orbital_values

    @classmethod
    def from_charges_of_orbitals(cls, N_rings, Ly, N_orb, chinfo, charges,
                                 conserve_k=True, ring_order=None, **kwargs):
        """The lattice of one fermion site per ``(k, l)``, carrying orbital
        ``l``'s charges ``charges[l]`` and (with ``conserve_k``) ``k`` as
        a Z_Ly charge named 'ky'."""
        charges = np.asarray(charges, int)
        assert charges.shape[0] == N_orb
        if conserve_k:
            chinfo = ChargeInfo.add([chinfo, ChargeInfo([Ly], ['ky'])])
        unit_cell = [None] * (Ly * N_orb)
        for l in range(N_orb):
            for k in range(Ly):
                qflat = np.zeros((2, chinfo.qnumber), int)
                if conserve_k:
                    qflat[1, :-1] = charges[l]
                    qflat[1, -1] = k
                else:
                    qflat[1, :] = charges[l]
                perm_flat, leg = LegCharge.from_qflat(
                    chinfo, qflat, qconj=+1).sort(bunch=False)
                site = FermionSite(conserve=None)
                site.change_charge(leg, np.asarray(perm_flat))
                unit_cell[k * N_orb + l] = site
        return cls(N_rings, Ly, N_orb, unit_cell, ring_order=ring_order,
                   **kwargs)

    def get_u(self, k, l):
        return k * self.N_orb + l

    def get_k(self, u):
        return u // self.N_orb

    def get_l(self, u):
        return u % self.N_orb

    def get_exp_ik(self, k):
        """``exp(2 pi i k / Ly)``, element-wise."""
        return np.exp(2.j * np.pi * np.asarray(k) / self.Ly)


def _couplings(couplings, lead, shape):
    """``couplings`` (with or without the leading ring axis) tiled to
    ``(lead,) + shape`` and reshaped to ``(lead, N_r, ..., N_r)``."""
    couplings = np.asarray(couplings)
    if couplings.ndim == len(shape):
        couplings = couplings[np.newaxis, ...]
    couplings = to_array(couplings, (lead,) + shape)
    n_r = shape[0] * shape[1]
    return np.reshape(couplings, (lead,) + (n_r,) * (len(shape) // 2),
                      order='C')


class MixedXKModel(CouplingMPOModel):
    """Hamiltonians in the mixed x-k basis.

    Options: ``Lx`` (rings, 1), ``Ly`` (2), ``ring_order``, ``conserve_k``
    (True), ``bc_MPS`` ('infinite'; 'finite' makes the axis open),
    ``xy_lattice`` (only 'Square').
    """

    def init_lattice(self, model_params, N_orb, chinfo, charges):
        if model_params.get('xy_lattice', 'Square') != 'Square':
            raise NotImplementedError("only Square real-space geometry")
        N_rings = model_params.get('Lx', 1, int)
        Ly = model_params.get('Ly', 2, int)
        ring_order = model_params.get('ring_order', None)
        conserve_k = model_params.get('conserve_k', True, bool)
        bc_MPS = model_params.get('bc_MPS', 'infinite', str)
        bc = 'periodic' if bc_MPS == 'infinite' else 'open'
        return MixedXKLattice.from_charges_of_orbitals(
            N_rings, Ly, N_orb, chinfo, charges, conserve_k,
            ring_order=ring_order, bc=bc, bc_MPS=bc_MPS)

    def _n_x(self, dx):
        """Ring pairs at distance ``dx`` (fewer on an open axis)."""
        return self.lat.N_rings - int(bool(self.lat.bc[0])) * abs(dx)

    def add_intra_ring_hopping(self, couplings):
        r"""``sum_x couplings[x, k1, l1, k2, l2] c^dag_{x,k1,l1}
        c_{x,k2,l2}``."""
        lat = self.lat
        couplings = _couplings(couplings, lat.N_rings,
                               (lat.Ly, lat.N_orb) * 2)
        for u1, u2 in zip(*(np.linalg.norm(couplings, axis=0).nonzero())):
            strength = couplings[:, u1, u2]
            if u1 == u2:
                self.add_onsite(np.real_if_close(strength), int(u1), 'N')
            else:
                self.add_coupling(strength, int(u1), 'Cd', int(u2), 'C', 0,
                                  op_string='JW')

    def add_inter_ring_hopping(self, couplings, dx=+1):
        r"""``sum_x couplings[x, k1, l1, k2, l2] c^dag_{x,k1,l1}
        c_{x+dx,k2,l2} + h.c.``"""
        assert dx != 0
        lat = self.lat
        n_x = self._n_x(dx)
        if n_x <= 0:
            return      # open axis: no ring pairs at this distance
        couplings = _couplings(couplings, n_x, (lat.Ly, lat.N_orb) * 2)
        for u1, u2 in zip(*(np.linalg.norm(couplings, axis=0).nonzero())):
            self.add_coupling(couplings[:, u1, u2], int(u1), 'Cd', int(u2),
                              'C', dx, op_string='JW', plus_hc=True)

    def add_intra_ring_interaction(self, couplings,
                                   operators=('Cd', 'C', 'Cd', 'C')):
        r"""``sum_x couplings[x, k1, l1, ..., k4, l4] A_{x,k1,l1}
        B_{x,k2,l2} C_{x,k3,l3} D_{x,k4,l4}``."""
        lat = self.lat
        couplings = _couplings(couplings, lat.N_rings,
                               (lat.Ly, lat.N_orb) * 4)
        A, B, C, D = operators
        for u1, u2, u3, u4 in zip(
                *(np.linalg.norm(couplings, axis=0).nonzero())):
            strength = couplings[:, u1, u2, u3, u4]
            if u1 == u2 == u3 == u4:
                self.add_onsite(np.real_if_close(strength), int(u1),
                                ' '.join([A, B, C, D]))
            else:
                self.add_multi_coupling(
                    strength, [(A, 0, int(u1)), (B, 0, int(u2)),
                               (C, 0, int(u3)), (D, 0, int(u4))])

    def add_inter_ring_interaction(self, couplings, dx,
                                   operators=('Cd', 'C', 'Cd', 'C')):
        r"""``sum_x couplings[x, ...] A_{x,k1,l1} B_{x,k2,l2}
        C_{x+dx,k3,l3} D_{x+dx,k4,l4}``."""
        assert dx != 0
        lat = self.lat
        n_x = self._n_x(dx)
        if n_x <= 0:
            return      # open axis: no ring pairs at this distance
        couplings = _couplings(couplings, n_x, (lat.Ly, lat.N_orb) * 4)
        A, B, C, D = operators
        for u1, u2, u3, u4 in zip(
                *(np.linalg.norm(couplings, axis=0).nonzero())):
            self.add_multi_coupling(
                couplings[:, u1, u2, u3, u4],
                [(A, 0, int(u1)), (B, 0, int(u2)), (C, dx, int(u3)),
                 (D, dx, int(u4))])

    # ------------------------------------------------------- measurements
    def _conserve_k(self):
        return 'ky' in self.lat.unit_cell[0].leg.chinfo.names

    def _mps_idx(self, xs, us):
        return self.lat.lat2mps_idx(np.stack([np.asarray(xs),
                                              np.asarray(us)], axis=-1))

    def real_to_mixed_onsite(self, A, A_coord):
        r"""The :class:`~tenpy_tpu_torch.networks.terms.TermList` of the
        real-space on-site observable ``sum_{l1,l2} A[l1,l2]
        c^dag_{x,y,l1} c_{x,y,l2}`` at ``A_coord = (x, y)``; evaluate with
        ``MPS.expectation_value_terms_sum``."""
        x, y = A_coord
        lat = self.lat
        Ly = lat.Ly
        conserve_k = self._conserve_k()
        A = np.asarray(A)
        if A.shape != (lat.N_orb, lat.N_orb):
            raise ValueError("wrong shape of A")
        terms, strengths = [], []
        for l1, l2 in zip(*A.nonzero()):
            for k1 in range(Ly):
                i1 = int(lat.lat2mps_idx([x, lat.get_u(k1, l1)]))
                for k2 in range(Ly):
                    if conserve_k and (k1 - k2) % Ly != 0:
                        continue    # breaks ky: its expectation value is 0
                    i2 = int(lat.lat2mps_idx([x, lat.get_u(k2, l2)]))
                    terms.append([('Cd', i1), ('C', i2)])
                    strengths.append(A[l1, l2]
                                     * lat.get_exp_ik((k1 - k2) * y) / Ly)
        return TermList(terms, strengths)

    def real_to_mixed_two_site(self, A, A_coord, B, B_coord):
        r"""The TermList of the real-space correlation ``A_{x1,y1}
        B_{x2,y2}`` of two on-site orbital-matrix operators."""
        return self.real_to_mixed_n_site([A, B], [A_coord, B_coord])

    def real_to_mixed_n_site(self, orbital_coeffs, rs_coords):
        r"""The TermList of an n-point real-space correlation of on-site
        operators ``sum_{l1,l2} M[l1,l2] c^dag_{x,y,l1} c_{x,y,l2}``."""
        num_ops = len(orbital_coeffs)
        orbital_coeffs = [np.asarray(op) for op in orbital_coeffs]
        assert num_ops == len(rs_coords)
        lat = self.lat
        Ly = lat.Ly
        conserve_k = self._conserve_k()
        terms, strengths = [], []
        xx_ind = np.repeat([x for x, _ in rs_coords], 2)
        y_ind = [y for _, y in rs_coords]
        ops = ['Cd', 'C'] * num_ops
        for l_ind in itertools.product(*[zip(*op_i.nonzero())
                                         for op_i in orbital_coeffs]):
            coeff = np.prod([op_i[l_i]
                             for op_i, l_i in zip(orbital_coeffs, l_ind)])
            for k_ind in itertools.product(range(Ly), repeat=2 * num_ops):
                if conserve_k and \
                        (sum(k_ind[::2]) - sum(k_ind[1::2])) % Ly != 0:
                    continue
                kdiff_y = sum((k1 - k2) * y for k1, k2, y
                              in zip(k_ind[::2], k_ind[1::2], y_ind))
                strengths.append(coeff * lat.get_exp_ik(kdiff_y)
                                 / Ly**num_ops)
                u_ind = lat.get_u(np.array(k_ind), np.array(l_ind).flatten())
                terms.append(list(zip(ops, (int(i) for i in self._mps_idx(
                    xx_ind, u_ind)))))
        return TermList(terms, strengths)

    def real_to_mixed_correlations_any(self, ops, coeff_orbitals, rs_coords):
        r"""The TermList of any real-space string of 'C'/'Cd' operators
        ``ops`` at ``rs_coords``, with ``coeff_orbitals = [(coeff,
        [l_1, ..., l_n]), ...]``."""
        num_ops = len(ops)
        assert num_ops == len(rs_coords)
        assert all(num_ops == len(orbs) for _, orbs in coeff_orbitals)
        lat = self.lat
        Ly = lat.Ly
        conserve_k = self._conserve_k()
        terms, strengths = [], []
        x_ind = np.array([x for x, _ in rs_coords])
        y_ind = np.array([y for _, y in rs_coords])
        k_sign = np.array([(+1 if op == 'Cd' else -1) for op in ops])
        coeff_orbitals = [(c, np.asarray(l_ind))
                          for c, l_ind in coeff_orbitals]
        for k_ind in itertools.product(range(Ly), repeat=num_ops):
            k_ind = np.array(k_ind)
            if conserve_k and np.sum(k_ind * k_sign) % Ly != 0:
                continue
            fourier = lat.get_exp_ik(np.sum(k_ind * k_sign * y_ind)) \
                / Ly**(num_ops / 2.)
            for coeff, l_ind in coeff_orbitals:
                strengths.append(coeff * fourier)
                u_ind = lat.get_u(k_ind, l_ind)
                terms.append(list(zip(ops, (int(i) for i in self._mps_idx(
                    x_ind, u_ind)))))
        return TermList(terms, strengths)


class SpinlessMixedXKSquare(MixedXKModel):
    r"""Spinless fermions on a square-lattice cylinder in the x-k basis
    (``N_orb = 1``): nearest-neighbour hopping ``t`` (1.), diagonal in k
    within a ring (``-2 t cos(2 pi k / Ly)``), and nearest-neighbour
    density interaction ``V`` (1.), a sum over momentum transfers."""

    def init_lattice(self, model_params):
        return MixedXKModel.init_lattice(
            self, model_params, 1, ChargeInfo([1], ['Charge']), [[1]])

    def init_terms(self, model_params):
        t = model_params.get('t', 1., 'real_or_array')
        V = model_params.get('V', 1., 'real_or_array')
        lat = self.lat
        Ly, N_orb = lat.Ly, lat.N_orb
        assert N_orb == 1
        intra_hopping = np.zeros((Ly, N_orb, Ly, N_orb), dtype=complex)
        inter_hopping = np.zeros((Ly, N_orb, Ly, N_orb))
        cos_k = np.real(lat.get_exp_ik(np.arange(Ly)))
        for k in range(Ly):
            intra_hopping[k, 0, k, 0] = -t * 2. * cos_k[k]
            inter_hopping[k, 0, k, 0] = -t
        self.add_intra_ring_hopping(intra_hopping)
        self.add_inter_ring_hopping(inter_hopping, dx=1)
        n_q = lat.delta_q
        intra_int = np.zeros((Ly, N_orb) * 4)
        inter_int = np.zeros((Ly, N_orb) * 4)
        for q in range(Ly):
            nn = (n_q[q][:, :, np.newaxis, np.newaxis]
                  * n_q[-q][np.newaxis, np.newaxis, :, :])
            intra_int[:, 0, :, 0, :, 0, :, 0] += V / Ly * cos_k[q] * nn
            inter_int[:, 0, :, 0, :, 0, :, 0] += V / Ly * nn
        self.add_intra_ring_interaction(intra_int)
        self.add_inter_ring_interaction(inter_int, 1)


class HubbardMixedXKSquare(MixedXKModel):
    r"""The spinful Hubbard model on a square-lattice cylinder in the x-k
    basis (``N_orb = 2``: spin up ``l=0``, down ``l=1``; charges N, Sz and
    ky): nearest-neighbour hopping ``t`` (1.) and on-site ``U`` (1.), a sum
    over momentum transfers."""

    def init_lattice(self, model_params):
        return MixedXKModel.init_lattice(
            self, model_params, 2, ChargeInfo([1, 1], ['Charge', 'Spin']),
            [[1, 1], [1, -1]])

    def init_terms(self, model_params):
        t = model_params.get('t', 1., 'real_or_array')
        U = model_params.get('U', 1., 'real_or_array')
        lat = self.lat
        Ly, N_orb = lat.Ly, lat.N_orb
        intra_hopping = np.zeros((Ly, N_orb, Ly, N_orb), dtype=complex)
        inter_hopping = np.zeros((Ly, N_orb, Ly, N_orb))
        cos_k = np.real(lat.get_exp_ik(np.arange(Ly)))
        for k in range(Ly):
            for l in range(N_orb):     # the hopping is diagonal in spin
                intra_hopping[k, l, k, l] = -2. * t * cos_k[k]
                inter_hopping[k, l, k, l] = -t
        self.add_intra_ring_hopping(intra_hopping)
        self.add_inter_ring_hopping(inter_hopping, dx=1)
        n_q = lat.delta_q
        intra_int = np.zeros((Ly, N_orb) * 4)
        for q in range(Ly):
            intra_int[:, 0, :, 0, :, 1, :, 1] += (
                U / Ly * n_q[q][:, :, np.newaxis, np.newaxis]
                * n_q[-q][np.newaxis, np.newaxis, :, :])
        self.add_intra_ring_interaction(intra_int)
