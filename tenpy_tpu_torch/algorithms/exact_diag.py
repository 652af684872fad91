"""Exact diagonalization of a finite model, in one charge sector or all.

Port of ``ExactDiag``, ``get_numpy_Hamiltonian`` and
``get_scipy_sparse_Hamiltonian`` of ``tenpy_tpu/algorithms/exact_diag.py``.
The full Hamiltonian is contracted from the model's MPO on the host (dense
numpy, then an :class:`~tenpy_tpu_torch.linalg.np_conserved.Array` on the
:class:`~tenpy_tpu_torch.linalg.charges.LegPipe` of all sites: the basis
sorted by total charge, as ``tenpy_tpu``'s), projected onto
``charge_sector`` if given, and diagonalized block by block; ``exp_H``
gives the exact evolution operator, ``mps_to_full`` and ``full_to_mps``
move states between an MPS and the dense vector.  It is the exact
reference for small systems; nothing of it runs on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..linalg import np_conserved as npc
from ..linalg.charges import LegPipe
from ..networks.mps import MPS

__all__ = ['ExactDiag', 'get_numpy_Hamiltonian',
           'get_scipy_sparse_Hamiltonian']


class ExactDiag:
    """The full Hamiltonian of a finite model as a 2-leg Array.

    Parameters
    ----------
    model : model with ``lat`` and ``H_MPO`` (finite bc)
    charge_sector : charges | None
        If given, the total charge the Hamiltonian is projected onto.
    max_size : int
        The largest Hilbert-space dimension accepted.

    Attributes
    ----------
    full_H : Array with legs ``p, p*`` | None
    E : ndarray | None
        Eigenvalues, ascending within each charge sector.
    V : Array | None
        Eigenvectors (columns).
    """

    def __init__(self, model, charge_sector=None, sparse=False,
                 max_size=2e6):
        self.model = model
        self.sites = model.lat.mps_sites()
        self.L = len(self.sites)
        self.chinfo = self.sites[0].leg.chinfo
        self.max_size = max_size
        self.pipe = LegPipe([s.leg for s in self.sites], qconj=+1)
        if self.pipe.ind_len > max_size:
            raise ValueError(f"system too large for ED: {self.pipe.ind_len}")
        self.full_H = None
        self.E = None
        self.V = None
        self._mask = None
        self.charge_sector = None if charge_sector is None else tuple(
            int(q) for q in self.chinfo.make_valid(charge_sector))

    @classmethod
    def from_H_mpo(cls, H_MPO, *args, **kwargs):
        """ED of a bare MPO (its sites make the lattice)."""
        class _Lattice:
            def mps_sites(self):
                return list(H_MPO.sites)

        class _Model:
            lat = _Lattice()

        model = _Model()
        model.H_MPO = H_MPO
        return cls(model, *args, **kwargs)

    def _pipe_order(self):
        """``perm[pipe index] = product-basis index``."""
        legs = self.pipe.legs
        dims = [l.ind_len for l in legs]
        perm = np.empty(self.pipe.ind_len, np.intp)
        for row in self.pipe.q_map:
            start, stop, qi = int(row[0]), int(row[1]), int(row[2])
            ranges = [np.arange(l.slices[s], l.slices[s + 1])
                      for l, s in zip(legs, row[3:])]
            grid = np.meshgrid(*ranges, indexing='ij')
            flat = np.ravel_multi_index([g.ravel() for g in grid], dims)
            off = int(self.pipe.slices[qi])
            perm[off + start:off + stop] = flat
        return perm

    def build_full_H_from_mpo(self):
        """Contract the MPO into the full H (legs ``p, p*`` on the pipe)."""
        H = self.model.H_MPO
        if not H.finite:
            raise ValueError("ED needs a finite MPO")
        T = None
        for i in range(H.L):
            W = H.get_W(i).copy(deep=False).itranspose(
                ['wL', 'wR', 'p', 'p*']).to_numpy()
            if T is None:
                T = W[H.get_IdL(i)]                   # (wR, p, p*)
                continue
            # T (wL, a, b), W (wL, wR, i, j) -> (wR, (a i), (b j))
            T = np.einsum('wab,wvij->vaibj', T, W)
            n = T.shape[1] * T.shape[2]
            T = T.reshape(T.shape[0], n, n)
        dense = T[H.get_IdR(H.L - 1)]
        if H.explicit_plus_hc:      # the MPO holds half of H + H^dagger
            dense = dense + dense.conj().T
        perm = self._pipe_order()
        self.full_H = npc.Array.from_ndarray(
            dense[np.ix_(perm, perm)], [self.pipe, self.pipe.conj()],
            labels=['p', 'p*'])
        self._maybe_project()
        return self.full_H

    def _maybe_project(self):
        if self.charge_sector is None:
            return
        leg = self.full_H.legs[0]
        qflat = self.chinfo.make_valid(leg.to_qflat() * leg.qconj)
        mask = np.all(qflat == np.asarray(self.charge_sector)[None, :],
                      axis=1)
        self._mask = mask
        self.full_H = self.full_H.copy(deep=False).iproject([mask, mask],
                                                           [0, 1])

    def full_diagonalization(self):
        """Diagonalize the (hermitian) full H, sector by sector."""
        if self.full_H is None:
            self.build_full_H_from_mpo()
        E, V = npc.eigh(self.full_H)
        self.E = np.asarray(E)
        self.V = V

    def groundstate(self, charge_sector=None):
        """``(E0, V0)``: the lowest eigenvalue and its eigenvector (dense,
        in the pipe basis of the projected space)."""
        if self.E is None:
            self.full_diagonalization()
        i0 = int(np.argmin(self.E))
        return float(self.E[i0]), self.V.to_numpy()[:, i0]

    def exp_H(self, dt):
        """``exp(-i dt H)`` as a 2-leg Array (complex128), from the full
        diagonalization."""
        if self.E is None:
            self.full_diagonalization()
        phases = np.exp(-1j * dt * np.asarray(self.E))
        Vs = self.V.astype(torch.complex128).iscale_axis(phases, 1)
        return npc.tensordot(Vs, self.V.conj().itranspose([1, 0]).astype(
            torch.complex128), axes=[[1], [0]])

    def mps_to_full(self, psi):
        """The dense vector of a finite MPS (its norm included), in the
        pipe basis (projected onto ``charge_sector`` if given)."""
        theta = psi.get_theta(0, psi.L)
        out = theta.combine_legs([[f'p{i}' for i in range(psi.L)]],
                                 pipes=[self.pipe])
        for lab in ['vL', 'vR']:
            idx = out.get_leg_index(lab)
            if out.legs[idx].ind_len == 1:
                out = out.squeeze([idx])
        vec = out.to_numpy().reshape(-1)
        if self._mask is not None:
            vec = vec[self._mask]
        return vec * psi.norm

    def full_to_mps(self, psi_vec, canonical_form='B'):
        """The exact MPS of a dense vector (pipe basis, projected onto
        ``charge_sector`` if given)."""
        full = np.asarray(psi_vec)
        if self._mask is not None:
            tmp = np.zeros(self.pipe.ind_len, dtype=full.dtype)
            tmp[self._mask] = full
            full = tmp
        arr = npc.Array.from_ndarray(full, [self.pipe],
                                     qtotal=self.charge_sector)
        return MPS.from_full(self.sites, arr.split_legs([0]))


def get_numpy_Hamiltonian(model):
    """The dense H of a finite model (the full Hilbert space, pipe
    basis)."""
    ed = ExactDiag(model)
    ed.build_full_H_from_mpo()
    return ed.full_H.to_numpy()


def get_scipy_sparse_Hamiltonian(model):
    import scipy.sparse
    return scipy.sparse.csr_matrix(get_numpy_Hamiltonian(model))
