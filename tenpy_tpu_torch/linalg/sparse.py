"""Linear operators on :class:`~.np_conserved.Array` vectors, and the bridge
to scipy.

Port of ``NpcLinearOperator``, ``NpcLinearOperatorWrapper``,
``OrthogonalNpcLinearOperator``, ``FlatLinearOperator`` and
``FlatHermitianOperator`` from
``tenpy_tpu/linalg/sparse.py``.  ``FlatLinearOperator`` maps the vectors of
one charge sector of a leg to flat numpy vectors, so that ARPACK
(``scipy.sparse.linalg.eigs``/``eigsh``) can run on an Array operator; the
environments' Arnoldi route (:meth:`~tenpy_tpu_torch.networks.mpo.
MPOTransferMatrix.dominant_eigenvector`) and the DMRG engines' ``arpack``
and ``ED_block`` eigensolvers take it.  ``OrthogonalNpcLinearOperator``
projects lower states out of an effective Hamiltonian (DMRG's
``orthogonal_to``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse.linalg

from . import np_conserved as npc
from .charges import QTYPE
from ..tools.misc import argsort

__all__ = ['NpcLinearOperator', 'NpcLinearOperatorWrapper',
           'OrthogonalNpcLinearOperator', 'FlatLinearOperator',
           'FlatHermitianOperator']


class NpcLinearOperator:
    """Base class: a linear operator on Arrays (``dtype``, ``acts_on``,
    ``matvec``)."""

    dtype = None
    acts_on = None

    def matvec(self, vec):
        raise NotImplementedError("subclass must implement matvec")

    def to_matrix(self):
        """The operator as a 2-leg Array (small operators only)."""
        raise NotImplementedError


class NpcLinearOperatorWrapper:
    """Base of the wrappers: everything not overridden is
    ``orig_operator``'s."""

    def __init__(self, orig_operator):
        self.orig_operator = orig_operator

    def __getattr__(self, name):
        return getattr(self.orig_operator, name)


class OrthogonalNpcLinearOperator(NpcLinearOperatorWrapper):
    """``P A P`` with ``P`` the projector out of the given (normalized)
    states: excited states orthogonal to lower ones."""

    def __init__(self, orig_operator, ortho_vecs):
        super().__init__(orig_operator)
        self.ortho_vecs = list(ortho_vecs)

    def _project(self, vec):
        from .krylov_based import _v_axpy, _v_inner
        for o in self.ortho_vecs:
            if not np.array_equal(o.qtotal, vec.qtotal):
                continue    # another charge sector: <o|vec> = 0
            vec = _v_axpy(-_v_inner(o, vec), o, vec)
        return vec

    def matvec(self, vec):
        vec = self.orig_operator.matvec(self._project(vec))
        return self._project(vec)

    def to_matrix(self):
        mat = self.orig_operator.to_matrix()
        P = npc.eye_like(mat)
        for o in self.ortho_vecs:
            oc = o if o.rank == 1 else o.combine_legs([list(range(o.rank))])
            P = P - npc.outer(oc, oc.conj())
        return npc.tensordot(P, npc.tensordot(mat, P, axes=[[1], [0]]),
                             axes=[[1], [0]])


class FlatLinearOperator(scipy.sparse.linalg.LinearOperator):
    """An Array operator as a scipy ``LinearOperator`` on flat numpy vectors.

    ``npc_matvec`` acts on one-leg Arrays on ``leg``; the flat vectors hold
    the entries of the sector ``charge_sector`` (None: the whole leg)."""

    def __init__(self, npc_matvec, leg, dtype, charge_sector=0):
        self.npc_matvec = npc_matvec
        self.leg = leg
        self.matvec_count = 0
        super().__init__(dtype=dtype, shape=(leg.ind_len, leg.ind_len))
        self.charge_sector = charge_sector

    @classmethod
    def from_NpcArray(cls, mat, charge_sector=0):
        """The operator of a square 2-leg Array acting on its leg 1."""
        if mat.rank != 2:
            raise ValueError("need 2-leg array")
        return cls(lambda v: npc.tensordot(mat, v, axes=[[1], [0]]),
                   mat.legs[0], _np_dtype(mat.dtype), charge_sector)

    @classmethod
    def from_guess_with_pipe(cls, npc_matvec, v0_guess, dtype=None):
        """An operator on multi-leg Arrays shaped like ``v0_guess``: every
        leg is combined into one pipe.  Returns ``(operator, v0_combined)``.
        """
        v0_combined = v0_guess.combine_legs(list(range(v0_guess.rank)))
        pipe = v0_combined.legs[0]

        def flat_matvec(v_combined):
            res = npc_matvec(v_combined.split_legs([0]))
            return res.combine_legs([list(range(res.rank))], pipes=[pipe])

        if dtype is None:
            dtype = v0_guess.dtype
        res = cls(flat_matvec, pipe, _np_dtype(dtype),
                  charge_sector=tuple(int(q) for q in v0_guess.qtotal))
        return res, v0_combined

    @property
    def charge_sector(self):
        return self._charge_sector

    @charge_sector.setter
    def charge_sector(self, value):
        if isinstance(value, int) and value == 0:
            value = self.leg.chinfo.make_valid()
        if value is not None:
            value = tuple(int(q) for q in self.leg.chinfo.make_valid(value))
            qflat = self.leg.chinfo.make_valid(self.leg.to_qflat()
                                               * self.leg.qconj)
            self._mask = np.all(qflat == np.array(value, QTYPE)[None, :],
                                axis=1)
            size = int(self._mask.sum())
        else:
            self._mask = None
            size = self.leg.ind_len
        self._charge_sector = value
        self.shape = (size, size)

    def flat_to_npc(self, vec):
        """A flat (sector) numpy vector as a one-leg Array."""
        vec = np.asarray(vec)
        if self._charge_sector is None:
            return npc.Array.from_ndarray(vec, [self.leg],
                                          warn_wrong_sector=False)
        full = np.zeros(self.leg.ind_len, dtype=vec.dtype)
        full[self._mask] = vec
        return npc.Array.from_ndarray(full, [self.leg],
                                      qtotal=self._charge_sector,
                                      warn_wrong_sector=False)

    def npc_to_flat(self, npc_vec):
        full = npc_vec.to_numpy()
        return full if self._charge_sector is None else full[self._mask]

    def _matvec(self, vec):
        self.matvec_count += 1
        res = self.npc_matvec(self.flat_to_npc(np.asarray(vec).reshape(-1)))
        return self.npc_to_flat(res)

    def eigenvectors(self, num_ev=1, max_num_ev=None, max_tol=1e-12,
                     which='LM', v0_npc=None, hermitian=False, **kwargs):
        """ARPACK eigenpairs ``(eta, vecs)`` in the order ``which``, the
        vectors as one-leg Arrays (``eigsh`` with ``hermitian``, else
        ``eigs``).  Where ARPACK does not converge for ``num_ev`` it retries
        with more vectors (up to ``max_num_ev``, default ``num_ev + 2``) at
        tolerance ``max_tol``."""
        if max_num_ev is None:
            max_num_ev = num_ev + 2
        if v0_npc is not None:
            kwargs['v0'] = self.npc_to_flat(v0_npc)
        eigs = scipy.sparse.linalg.eigsh if hermitian \
            else scipy.sparse.linalg.eigs
        for k in range(num_ev, max_num_ev + 1):
            if k > num_ev:
                kwargs['tol'] = max(max_tol, kwargs.get('tol', 0))
            try:
                eta, A = eigs(self, k=k, which=which, **kwargs)
                break
            except scipy.sparse.linalg.ArpackNoConvergence:
                if k == max_num_ev:
                    raise
        perm = argsort(eta, which)
        eta, A = eta[perm], A[:, perm]
        return eta, [self.flat_to_npc(A[:, j]) for j in range(A.shape[1])]


class FlatHermitianOperator(FlatLinearOperator):
    """A hermitian :class:`FlatLinearOperator`: ARPACK's ``eigsh``."""

    def eigenvectors(self, *args, **kwargs):
        kwargs['hermitian'] = True
        return super().eigenvectors(*args, **kwargs)


def _np_dtype(dtype):
    """The numpy dtype of a torch (or numpy) dtype."""
    if isinstance(dtype, np.dtype):
        return dtype
    return np.dtype(str(dtype).replace('torch.', ''))
