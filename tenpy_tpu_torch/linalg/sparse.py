"""Linear operators on :class:`~.np_conserved.Array` vectors, and the bridge
to scipy.

Port of ``NpcLinearOperator``, ``NpcLinearOperatorWrapper``,
``SumNpcLinearOperator``, ``ShiftNpcLinearOperator``,
``BoostNpcLinearOperator``, ``OrthogonalNpcLinearOperator``,
``FlatLinearOperator`` and ``FlatHermitianOperator`` from
``tenpy_tpu/linalg/sparse.py``.  ``FlatLinearOperator`` maps the vectors of
one charge sector of a leg to flat numpy vectors, so that ARPACK
(``scipy.sparse.linalg.eigs``/``eigsh``) can run on an Array operator; the
environments' Arnoldi route (:meth:`~tenpy_tpu_torch.networks.mpo.
MPOTransferMatrix.dominant_eigenvector`) and the DMRG engines' ``arpack``
and ``ED_block`` eigensolvers take it.  The wrappers compose operators
on the Krylov vectors of :mod:`.krylov_based` (an Array, a
:class:`~.packed.PackedArray`, or a list of either, a direct sum):
``Sum`` adds two operators (the plane-wave excitations' aligned and
unaligned parts), ``Shift`` adds a multiple of the identity, ``Boost``
raises the energy of given states (the excitations' ``orthogonal_to``),
and ``Orthogonal`` projects lower states out of an effective Hamiltonian
(DMRG's ``orthogonal_to``).
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse.linalg

from . import np_conserved as npc
from .charges import QTYPE
from ..tools.misc import argsort

__all__ = ['NpcLinearOperator', 'NpcLinearOperatorWrapper',
           'SumNpcLinearOperator', 'ShiftNpcLinearOperator',
           'BoostNpcLinearOperator', 'OrthogonalNpcLinearOperator',
           'FlatLinearOperator', 'FlatHermitianOperator']


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

    def adjoint(self):
        """The hermitian conjugate operator."""
        raise NotImplementedError("adjoint not defined for this operator")


class NpcLinearOperatorWrapper:
    """Base of the wrappers: everything not overridden is
    ``orig_operator``'s."""

    def __init__(self, orig_operator):
        self.orig_operator = orig_operator

    def __getattr__(self, name):
        return getattr(self.orig_operator, name)

    def unwrapped(self):
        """The innermost operator below every wrapper."""
        parent = self.orig_operator
        while isinstance(parent, NpcLinearOperatorWrapper):
            parent = parent.orig_operator
        return parent


class SumNpcLinearOperator(NpcLinearOperatorWrapper):
    """``(A + B) v``: ``orig_operator`` A and ``other_operator`` B."""

    def __init__(self, orig_operator, other_operator):
        super().__init__(orig_operator)
        self.other_operator = other_operator

    def matvec(self, vec):
        from .krylov_based import _v_axpy
        return _v_axpy(1., self.other_operator.matvec(vec),
                       self.orig_operator.matvec(vec))

    def to_matrix(self):
        return self.orig_operator.to_matrix() + self.other_operator.to_matrix()

    def adjoint(self):
        return SumNpcLinearOperator(self.orig_operator.adjoint(),
                                    self.other_operator.adjoint())


class ShiftNpcLinearOperator(NpcLinearOperatorWrapper):
    """``(A + shift) v``, e.g. to make an operator definite."""

    def __init__(self, orig_operator, shift):
        if shift == 0.:
            warnings.warn("shift=0: no-op wrapper", stacklevel=2)
        super().__init__(orig_operator)
        self.shift = shift

    def matvec(self, vec):
        from .krylov_based import _v_axpy
        return _v_axpy(self.shift, vec, self.orig_operator.matvec(vec))

    def to_matrix(self):
        mat = self.orig_operator.to_matrix()
        return mat + self.shift * npc.eye_like(mat)

    def adjoint(self):
        return ShiftNpcLinearOperator(self.orig_operator.adjoint(),
                                      np.conj(self.shift))


class BoostNpcLinearOperator(NpcLinearOperatorWrapper):
    """``(A + sum_i E_i |o_i><o_i|) v``: the states ``ortho_vecs`` raised
    by the ``penalties`` (excited states above lower ones)."""

    def __init__(self, orig_operator, penalties, ortho_vecs):
        super().__init__(orig_operator)
        self.penalties = list(penalties)
        self.ortho_vecs = list(ortho_vecs)

    def matvec(self, vec):
        from .krylov_based import _v_axpy, _v_inner
        res = self.orig_operator.matvec(vec)
        for E, o in zip(self.penalties, self.ortho_vecs):
            res = _v_axpy(E * _v_inner(o, vec), o, res)
        return res

    def to_matrix(self):
        mat = self.orig_operator.to_matrix()
        for E, o in zip(self.penalties, self.ortho_vecs):
            mat = mat + E * npc.outer(o, o.conj())
        return mat

    def adjoint(self):
        return BoostNpcLinearOperator(self.orig_operator.adjoint(),
                                      [np.conj(E) for E in self.penalties],
                                      self.ortho_vecs)


class OrthogonalNpcLinearOperator(BoostNpcLinearOperator):
    """``P A P`` with ``P`` the projector out of the given (normalized)
    states: excited states orthogonal to lower ones."""

    def __init__(self, orig_operator, ortho_vecs):
        BoostNpcLinearOperator.__init__(self, orig_operator, [], ortho_vecs)

    def _project(self, vec):
        from .krylov_based import _v_axpy, _v_inner
        for o in self.ortho_vecs:
            if not isinstance(vec, list) and \
                    not np.array_equal(o.qtotal, vec.qtotal):
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

    def adjoint(self):
        return OrthogonalNpcLinearOperator(self.orig_operator.adjoint(),
                                           self.ortho_vecs)


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
