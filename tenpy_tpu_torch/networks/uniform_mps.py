r"""Uniform MPS: the AL/AR/AC/C representation of VUMPS.

Port of ``tenpy_tpu/networks/uniform_mps.py`` (:class:`UniformMPS`,
``from_MPS``, ``to_MPS``, ``to_diagonal_gauge``, ``test_validity``,
``norm_test``).

A uniform MPS stores, per site, the left-canonical ``AL``, the
right-canonical ``AR`` and the one-site centre ``AC``; per bond the centre
matrix ``C`` (``C[i]`` sits left of site ``i``).  The identities ``AL_i
C_{i+1} = AC_i = C_i AR_i`` hold only once a tangent-space algorithm has
converged; their violation is VUMPS's split error.  The tensors are
:class:`~tenpy_tpu_torch.linalg.np_conserved.Array` s on the host; the dtype
of the state follows torch's type promotion of its tensors.
"""

from __future__ import annotations

import logging

import numpy as np

from ..linalg import np_conserved as npc
from ..tools.math import entropy
from .mps import MPS

logger = logging.getLogger(__name__)

__all__ = ['UniformMPS']


class UniformMPS(MPS):
    """An infinite MPS in the AL/AR/AC/C representation.

    Parameters
    ----------
    sites : list of :class:`~tenpy_tpu_torch.networks.site.Site`
    ALs, ARs, ACs : list of Array
        Per site, legs ``vL, p, vR``.
    Cs : list of Array
        Per bond (left of each site), legs ``vL, vR``.
    norm : float
    """

    _B_labels = ['vL', 'p', 'vR']
    _C_labels = ['vL', 'vR']

    def __init__(self, sites, ALs, ARs, ACs, Cs, norm=1.):
        self.sites = list(sites)
        self.chinfo = self.sites[0].leg.chinfo
        self.bc = 'infinite'
        self._AL = [AL.itranspose(self._B_labels) for AL in ALs]
        self._AR = [AR.itranspose(self._B_labels) for AR in ARs]
        self._AC = [AC.itranspose(self._B_labels) for AC in ACs]
        self._C = [C.itranspose(self._C_labels) for C in Cs]
        self.dtype = npc.result_type(*[A.dtype for A in self._AR])
        self.norm = norm
        self.grouped = 1
        self.form = [None] * len(self._AR)
        self._S = [None] * (len(self._AR) + 1)
        self.valid_umps = True
        self.diagonal_gauge = False
        self.left_U = None
        self.right_U = None
        self.segment_boundaries = (None, None)
        self.test_sanity()

    # ------------------------------------------------------------- sanity
    def test_sanity(self):
        L = self.L
        assert len(self._AL) == len(self._AR) == len(self._AC) == L
        assert len(self._C) == L
        for i in range(L):
            for A in (self._AL[i], self._AR[i], self._AC[i]):
                assert tuple(A.get_leg_labels()) == ('vL', 'p', 'vR')
            assert tuple(self._C[i].get_leg_labels()) == ('vL', 'vR')

    def test_validity(self, cutoff=1e-8):
        """The split errors ``(|AL_i C_{i+1} - AC_i|, |C_i AR_i - AC_i|)``
        per site; ``valid_umps`` says whether all are within ``cutoff``."""
        errs = []
        for i in range(self.L):
            ALC = npc.tensordot(self.get_AL(i), self.get_C(i + 1),
                                axes=[['vR'], ['vL']])
            CAR = npc.tensordot(self.get_C(i), self.get_AR(i),
                                axes=[['vR'], ['vL']])
            AC = self.get_AC(i)
            errs.append((float(npc.norm(ALC - AC)),
                         float(npc.norm(CAR - AC))))
        max_err = max(max(e) for e in errs)
        if max_err > cutoff:
            logger.warning("UniformMPS.test_validity: max split error %.2e",
                           max_err)
        self.valid_umps = max_err <= cutoff
        return np.array(errs)

    def copy(self):
        res = UniformMPS(self.sites,
                         [A.copy(deep=False) for A in self._AL],
                         [A.copy(deep=False) for A in self._AR],
                         [A.copy(deep=False) for A in self._AC],
                         [C.copy(deep=False) for C in self._C],
                         self.norm)
        res.valid_umps = self.valid_umps
        res.diagonal_gauge = self.diagonal_gauge
        res._S = list(self._S)
        return res

    # --------------------------------------------------------- properties
    @property
    def L(self):
        return len(self._AR)

    @property
    def finite(self):
        return False

    @property
    def chi(self):
        return [C.get_leg('vL').ind_len for C in self._C]

    @property
    def nontrivial_bonds(self):
        return slice(0, self.L)

    # ------------------------------------------------------------- access
    def get_B(self, i, form='B', copy=False, cutoff=1e-16, label_p=None):
        """The stored tensor of a canonical form: ``'B'`` is AR, ``'A'``
        AL, ``'Th'`` (or None) AC, ``'C'`` the bond matrix left of ``i``."""
        i = self._to_valid_index(i)
        if form in ('B', (0., 1.), (0, 1), 'AR'):
            A = self._AR[i]
        elif form in ('A', (1., 0.), (1, 0), 'AL'):
            A = self._AL[i]
        elif form in ('Th', (1., 1.), (1, 1), 'AC', None):
            A = self._AC[i]
        elif form == 'C':
            A = self._C[i]
        else:
            raise ValueError(f"form {form!r} not defined for UniformMPS")
        if copy:
            A = A.copy(deep=False)
        if label_p is not None:
            A = A.replace_label('p', 'p' + str(label_p))
        return A

    def get_AL(self, i, copy=False):
        return self.get_B(i, 'AL', copy)

    def get_AR(self, i, copy=False):
        return self.get_B(i, 'AR', copy)

    def get_AC(self, i, copy=False):
        return self.get_B(i, 'AC', copy)

    def get_C(self, i, copy=False):
        C = self._C[self._to_valid_index(i)]
        return C.copy(deep=False) if copy else C

    def set_B(self, i, B, form='B'):
        i = self._to_valid_index(i)
        if form in ('B', 'AR', (0., 1.)):
            self._AR[i] = B.itranspose(self._B_labels)
        elif form in ('A', 'AL', (1., 0.)):
            self._AL[i] = B.itranspose(self._B_labels)
        elif form in ('Th', 'AC', (1., 1.), None):
            self._AC[i] = B.itranspose(self._B_labels)
        else:
            raise ValueError(f"form {form!r} not defined for UniformMPS")
        self.dtype = npc.result_type(self.dtype, B.dtype)

    def set_AL(self, i, AL):
        self.set_B(i, AL, 'AL')

    def set_AR(self, i, AR):
        self.set_B(i, AR, 'AR')

    def set_AC(self, i, AC):
        self.set_B(i, AC, 'AC')

    def set_C(self, i, C):
        i = self._to_valid_index(i)
        self._C[i] = C.itranspose(self._C_labels)
        self._S[i] = None          # the cached Schmidt values are stale
        self.diagonal_gauge = False

    def get_SL(self, i):
        """The Schmidt data left of site ``i``: its singular values in the
        diagonal gauge, else the bond matrix ``C[i]`` itself."""
        i = self._to_valid_index(i)
        if self._S[i] is not None:
            return self._S[i]
        return self._C[i]

    def get_SR(self, i):
        return self.get_SL((i + 1) % self.L)

    def set_SL(self, i, S):
        self._S[self._to_valid_index(i)] = np.asarray(S)

    def set_SR(self, i, S):
        self.set_SL((i + 1) % self.L, S)

    def _schmidt_1d(self, i):
        i = self._to_valid_index(i)
        if self._S[i] is not None:
            return np.asarray(self._S[i])
        S = np.asarray(npc.svd(self._C[i], compute_uv=False))
        return np.sort(S)[::-1]

    # -------------------------------------------------------------- theta
    def get_theta(self, i, n=2, cutoff=1e-16, formL=1., formR=1.):
        """The ``n``-site wave function ``AC_i AR_{i+1} ... AR_{i+n-1}``
        (legs ``vL, p0, ..., p{n-1}, vR``)."""
        theta = self.get_AC(i).replace_label('p', 'p0')
        for k in range(1, n):
            B = self.get_AR(i + k).replace_label('p', f'p{k}')
            theta = npc.tensordot(theta, B, axes=[['vR'], ['vL']])
        return theta

    # ------------------------------------------------------- measurements
    def entanglement_entropy(self, n=1, bonds=None):
        """The entropy of the singular values of ``C`` on each bond
        (default all ``L``)."""
        if bonds is None:
            bonds = range(self.L)
        res = []
        for i in bonds:
            S = self._schmidt_1d(i)
            S = S / np.linalg.norm(S)
            res.append(entropy(S ** 2, n))
        return np.array(res)

    def entanglement_spectrum(self):
        """The singular values of ``C`` per bond, descending."""
        return [self._schmidt_1d(i) for i in range(self.L)]

    def expectation_value(self, ops, sites=None):
        """``<AC_i|op_i|AC_i>`` per site ``i`` (one-site operators)."""
        if isinstance(ops, (str, npc.Array)):
            ops = [ops]
        if sites is None:
            sites = range(self.L)
        res = []
        for i in sites:
            op = self.get_op(ops, i)
            AC = self.get_AC(i)
            val = npc.tensordot(op, AC, axes=[['p*'], ['p']])
            val = npc.tensordot(AC.conj(), val,
                                axes=[['vL*', 'p*', 'vR*'],
                                      ['vL', 'p', 'vR']])
            res.append(complex(val))
        res = np.array(res)
        if np.allclose(res.imag, 0., atol=1e-14):
            res = res.real
        return res

    def norm_test(self):
        """Isometry errors per site: columns ``|AL^dagger AL - 1|`` and
        ``|AR AR^dagger - 1|``."""
        res = np.empty((self.L, 2))
        for i in range(self.L):
            AL = self.get_AL(i)
            c = npc.tensordot(AL.conj(), AL,
                              axes=[['vL*', 'p*'], ['vL', 'p']])
            res[i, 0] = npc.norm(c - npc.eye_like(c, 0))
            AR = self.get_AR(i)
            c = npc.tensordot(AR, AR.conj(),
                              axes=[['p', 'vR'], ['p*', 'vR*']])
            res[i, 1] = npc.norm(c - npc.eye_like(c, 0))
        return res

    # --------------------------------------------------------- conversion
    @classmethod
    def from_MPS(cls, psi):
        """The uniform MPS of a canonical infinite MPS.

        ``AC`` is the stored ``'Th'`` form; ``AL`` and ``AR`` come without
        an inversion from the polar factors of ``AC C^dagger`` and ``C^dagger
        AC`` (``C`` diagonal and real), so that Schmidt values at the noise
        floor are never divided by."""
        assert not psi.finite
        AC = [psi.get_B(i, 'Th', copy=True).itranspose(cls._B_labels)
              for i in range(psi.L)]
        AL, AR = [], []
        for i in range(psi.L):
            M = AC[i].scale_axis(np.asarray(psi.get_SR(i)), 'vR')
            M = M.combine_legs([['vL', 'p']], qconj=[+1])
            W, _, VH = npc.svd(M, inner_labels=['vR', 'vL'])
            ALi = npc.tensordot(W, VH, axes=[['vR'], ['vL']])
            AL.append(ALi.split_legs(['(vL.p)']).itranspose(cls._B_labels))
            M = AC[i].scale_axis(np.asarray(psi.get_SL(i)), 'vL')
            M = M.combine_legs([['p', 'vR']], qconj=[-1])
            W, _, VH = npc.svd(M, inner_labels=['vR', 'vL'])
            ARi = npc.tensordot(W, VH, axes=[['vR'], ['vL']])
            AR.append(ARi.split_legs(['(p.vR)']).itranspose(cls._B_labels))
        Cs = [npc.diag(np.asarray(psi.get_SL(i)), AL[i].get_leg('vL'),
                       labels=['vL', 'vR']) for i in range(psi.L)]
        obj = cls(psi.sites, AL, AR, AC, Cs, psi.norm)
        obj.diagonal_gauge = True
        obj.valid_umps = False
        obj._S = [np.asarray(psi.get_SL(i)) for i in range(psi.L)] + [None]
        obj._S[psi.L] = obj._S[0]
        return obj

    def to_MPS(self, cutoff=1e-16, check_overlap=False):
        """The right-canonical infinite :class:`~tenpy_tpu_torch.networks.
        mps.MPS` of the ``AR`` (after :meth:`to_diagonal_gauge`), re-gauged
        by ``canonical_form``.  ``check_overlap`` logs ``|<AR-MPS|AL-MPS>|``,
        which is 1 at convergence."""
        if not self.diagonal_gauge:
            self.to_diagonal_gauge(cutoff=cutoff)
        SVs = [np.asarray(self._S[i]) for i in range(self.L)] + \
            [np.asarray(self._S[0])]
        psi = MPS(self.sites, [self.get_AR(i, copy=True)
                               for i in range(self.L)],
                  SVs, bc='infinite', form='B')
        psi.canonical_form()
        if check_overlap:
            try:
                psi_A = MPS(self.sites, [self.get_AL(i, copy=True)
                                         for i in range(self.L)],
                            SVs, bc='infinite', form='A')
                psi_A.canonical_form()
                ov = abs(psi.overlap(psi_A))
                logger.info("UniformMPS.to_MPS: |<AR-MPS|AL-MPS>| = %.10f",
                            ov)
                if abs(ov - 1.) > 1e-8:
                    logger.warning("to_MPS overlap not 1: %.10f", ov)
            except ValueError as e:    # a chi mismatch after truncation
                logger.warning("to_MPS overlap check skipped: %s", e)
        return psi

    def to_diagonal_gauge(self, cutoff=1e-16):
        """Rotate every ``C`` to diagonal form by its SVD ``C = U S VH``,
        the neighbouring AL, AR and AC with it; ``left_U`` and ``right_U``
        keep bond 0's ``U`` and ``VH``.  With ``L > 1`` the cutoff is 0
        (a cut would change bond dimensions inside the unit cell)."""
        if self.L > 1 and cutoff > 0.:
            cutoff = 0.
        self._S = [None] * (self.L + 1)
        for i in range(self.L):
            C = self.get_C(i)
            U, S, VH = npc.svd(C, cutoff=cutoff if cutoff else None,
                               qtotal_LR=[C.qtotal, None],
                               inner_labels=['vR', 'vL'])
            S = np.asarray(S)
            C_diag = npc.diag(S, VH.get_leg('vL'), labels=['vL', 'vR'])
            if i == 0:
                self.left_U = U
                self.right_U = VH
            # AL[i-1] U and U^dagger AL[i]; VH AR[i] and AR[i-1] VH^dagger
            self.set_AL(i - 1, npc.tensordot(self.get_AL(i - 1), U,
                                             axes=[['vR'], ['vL']]))
            self.set_AL(i, npc.tensordot(U.conj(), self.get_AL(i),
                                         axes=[['vL*'], ['vL']])
                        .ireplace_label('vR*', 'vL'))
            self.set_AR(i, npc.tensordot(VH, self.get_AR(i),
                                         axes=[['vR'], ['vL']]))
            self.set_AR(i - 1, npc.tensordot(self.get_AR(i - 1), VH.conj(),
                                             axes=[['vR'], ['vR*']])
                        .ireplace_label('vL*', 'vR'))
            self.set_AC(i, npc.tensordot(U.conj(), self.get_AC(i),
                                         axes=[['vL*'], ['vL']])
                        .ireplace_label('vR*', 'vL'))
            self.set_AC(i - 1, npc.tensordot(self.get_AC(i - 1), VH.conj(),
                                             axes=[['vR'], ['vR*']])
                        .ireplace_label('vL*', 'vR'))
            self.set_C(i, C_diag)
            self.set_SL(i, S)
        self._S[self.L] = self._S[0]
        self.diagonal_gauge = True

    # --------------------------------------------------------------- misc
    def _to_valid_index(self, i):
        return i % self.L

    def __repr__(self):
        return f"<UniformMPS L={self.L} max_chi={max(self.chi)}>"

    def canonical_form(self, **kwargs):
        raise NotImplementedError("a UniformMPS is kept canonical by "
                                  "construction; use to_MPS() and "
                                  "MPS.canonical_form()")

    def convert_form(self, new_form='B'):
        raise NotImplementedError("a UniformMPS stores all forms")
