r"""Matrix product states and their environments on the host.

Port of the ``MPS`` container and ``BaseEnvironment`` of
``tenpy_tpu/networks/mps.py``, with the same conventions:

* tensor labels ``vL, p, vR``; virtual legs have ``qconj=+1`` (vL) and
  ``-1`` (vR);
* canonical forms are exponent pairs ``(nL, nR)`` of the Schmidt values
  multiplied on the left and right: ``'B'=(0,1)``, ``'A'=(1,0)``,
  ``'C'=(0.5,0.5)``, ``'G'=(0,0)``, ``'Th'=(1,1)``;
* ``_S[i]`` are the Schmidt values on the bond left of site ``i`` (L+1
  entries; for infinite bc entry L mirrors entry 0), as numpy arrays.

Canonicalisation (``canonical_form``, the transfer matrices) is not
ported: the engine runs from states that are already canonical.
"""

from __future__ import annotations

import numpy as np

from ..linalg import np_conserved as npc
from ..linalg.charges import LegCharge

__all__ = ['MPS', 'BaseEnvironment']


class MPS:
    r"""A matrix product state, finite, segment or infinite.

    Parameters
    ----------
    sites : list of :class:`~tenpy_tpu_torch.networks.site.Site`
    Bs : list of Array
        Tensors with labels ``vL, p, vR``.
    SVs : list of 1D arrays
        Schmidt values on the L+1 bonds.
    bc : 'finite' | 'segment' | 'infinite'
    form : str | list
        Canonical form of the given Bs.
    norm : float
        Overall scalar norm factor of the state.
    """

    _valid_forms = {'A': (1., 0.), 'C': (0.5, 0.5), 'B': (0., 1.),
                    'G': (0., 0.), 'Th': (1., 1.), None: None}
    _valid_bc = ('finite', 'segment', 'infinite')

    def __init__(self, sites, Bs, SVs, bc='finite', form='B', norm=1.):
        self.sites = list(sites)
        self.chinfo = self.sites[0].leg.chinfo
        self.dtype = npc.result_type(*[B.dtype for B in Bs])
        self.form = self._parse_form(form)
        self.bc = bc
        if bc not in self._valid_bc:
            raise ValueError(f"invalid bc {bc!r}")
        self.norm = norm
        self._B = [B.astype(self.dtype) for B in Bs]
        self._S = [np.asarray(S) for S in SVs]
        self.test_sanity()

    def _parse_form(self, form):
        if isinstance(form, str) or form is None:
            return [self._to_valid_form(form)] * len(self.sites)
        if isinstance(form, tuple) and len(form) == 2 and \
                np.isscalar(form[0]):
            return [tuple(form)] * len(self.sites)
        return [self._to_valid_form(f) for f in form]

    def _to_valid_form(self, form):
        if isinstance(form, tuple):
            return form
        return self._valid_forms[form]

    @property
    def L(self):
        return len(self.sites)

    @property
    def dim(self):
        return [s.dim for s in self.sites]

    @property
    def finite(self):
        """True for 'finite' and 'segment' bc, False for 'infinite'."""
        return self.bc != 'infinite'

    @property
    def chi(self):
        """Bond dimensions: the L-1 inner bonds (finite) or all L bonds."""
        n = self.L - 1 if self.finite else self.L
        return [self._B[i].get_leg('vR').ind_len for i in range(n)]

    def copy(self):
        """A copy sharing the blocks (the tensors may be relabelled or
        re-gauged without touching the original)."""
        res = type(self).__new__(type(self))
        res.sites = list(self.sites)
        res.chinfo = self.chinfo
        res.dtype = self.dtype
        res.form = list(self.form)
        res.bc = self.bc
        res.norm = self.norm
        res._B = [B.copy(deep=False) for B in self._B]
        res._S = list(self._S)
        return res

    def test_sanity(self):
        assert len(self._B) == self.L
        assert len(self._S) == self.L + 1
        for B in self._B:
            assert set(B.get_leg_labels()) >= {'vL', 'p', 'vR'}

    def __repr__(self):
        return (f"<MPS L={self.L} bc={self.bc!r} max_chi="
                f"{max(self.chi) if self.chi else 1}>")

    def _to_valid_index(self, i):
        if self.finite:
            if i < 0:
                i += self.L
            if not 0 <= i < self.L:
                raise IndexError(f"site {i} out of range")
            return i
        return i % self.L

    @classmethod
    def from_product_state(cls, sites, p_state, bc='finite',
                           dtype=np.float64, permute=True, form='B',
                           chargeL=None):
        """Product state from per-site state labels or indices, or local
        vectors (in the sites' original basis order with ``permute``)."""
        sites = list(sites)
        L = len(sites)
        chinfo = sites[0].leg.chinfo
        Bs = []
        SVs = [np.ones(1)] * (L + 1)
        chargeL = chinfo.make_valid(chargeL)
        qL = np.array(chargeL, np.int64)
        legL = LegCharge.from_qflat(chinfo, [qL], qconj=+1)
        for i, (site, state) in enumerate(zip(sites, p_state)):
            if isinstance(state, (int, np.integer, str)):
                vec = np.zeros(site.dim)
                vec[site.state_index(state)] = 1.
            else:
                vec = np.asarray(state)
                if vec.shape != (site.dim,):
                    raise ValueError(f"wrong local state shape at site {i}")
                if permute:
                    vec = vec[site.perm]
            # the largest entry decides the state's charge
            qi, _ = site.leg.get_qindex(int(np.argmax(np.abs(vec))))
            q_p = site.leg.charges[qi] * site.leg.qconj
            if bc == 'infinite':
                # constant virtual legs, the site's charge in qtotal: a unit
                # cell with nonzero total charge still closes on itself
                Bs.append(npc.Array.from_ndarray(
                    vec.reshape(1, site.dim, 1),
                    [legL, site.leg, legL.conj()], labels=['vL', 'p', 'vR'],
                    dtype=dtype, qtotal=q_p))
                continue
            qR = chinfo.make_valid(qL + q_p)
            legR = LegCharge.from_qflat(chinfo, [qR], qconj=-1)
            Bs.append(npc.Array.from_ndarray(
                vec.reshape(1, site.dim, 1), [legL, site.leg, legR],
                labels=['vL', 'p', 'vR'], dtype=dtype))
            qL = np.array(qR, np.int64)
            legL = legR.conj()
        return cls(sites, Bs, SVs, bc=bc, form=form)

    # --------------------------------------------------------------- tensors
    def get_B(self, i, form='B', copy=False, cutoff=1e-16, label_p=None):
        """Tensor at site ``i`` converted to the requested canonical form."""
        i = self._to_valid_index(i)
        new_form = self._to_valid_form(form)
        old_form = self.form[i]
        B = self._B[i]
        if copy:
            B = B.copy(deep=False)
        if new_form is not None and old_form != new_form:
            B = self._convert_form_i(B, i, old_form, new_form, cutoff)
        if label_p is not None:
            B = B.replace_label('p', 'p' + str(label_p))
        return B

    def _convert_form_i(self, B, i, old_form, new_form, cutoff=1e-16):
        if old_form is None:
            raise ValueError("can't convert form of non-canonical tensor")
        dL = new_form[0] - old_form[0]
        dR = new_form[1] - old_form[1]
        if dL != 0.:
            B = B.scale_axis(self._scale_S(self.get_SL(i), dL, cutoff), 'vL')
        if dR != 0.:
            B = B.scale_axis(self._scale_S(self.get_SR(i), dR, cutoff), 'vR')
        return B

    @staticmethod
    def _scale_S(S, exp, cutoff=1e-16):
        S = np.asarray(S)
        if exp == 1.:
            return S
        if exp == -1.:
            return 1. / np.where(S > cutoff, S, 1.)
        return np.where(S > cutoff, S, 1.) ** exp

    def set_B(self, i, B, form='B'):
        i = self._to_valid_index(i)
        self.form[i] = self._to_valid_form(form)
        self._B[i] = B
        self.dtype = npc.result_type(self.dtype, B.dtype)

    def get_SL(self, i):
        return self._S[self._to_valid_index(i)]

    def get_SR(self, i):
        i = self._to_valid_index(i)
        if self.finite or i + 1 < self.L:
            return self._S[i + 1]
        return self._S[0]

    def set_SL(self, i, S):
        i = self._to_valid_index(i)
        self._S[i] = np.asarray(S)
        if not self.finite and i == 0:
            self._S[self.L] = self._S[0]

    def set_SR(self, i, S):
        i = self._to_valid_index(i)
        S = np.asarray(S)
        self._S[i + 1] = S
        if not self.finite and i + 1 == self.L:
            self._S[0] = S

    def get_theta(self, i, n=2, cutoff=1e-16, formL=1., formR=1.):
        """``n``-site wave function S--G--...--G--S with labels ``vL,
        p0, ..., p{n-1}, vR``; each inner Schmidt factor goes to the side
        whose stored form already carries it (no ``S^-1`` where avoidable).
        """
        i = self._to_valid_index(i)
        if n == 1:
            return self.get_B(i, (formL, formR), cutoff=cutoff, label_p=0)
        theta = None
        aL = formL
        for k in range(n):
            st = self.form[self._to_valid_index(i + k)]
            if k == n - 1:
                aR = formR
            else:
                nxt = self.form[self._to_valid_index(i + k + 1)]
                aR = 1. - (nxt[0] if nxt is not None else 0.)
                if st is not None and st[1] > aR + 1e-12:
                    aR = st[1]
            B = self.get_B(i + k, (aL, aR), cutoff=cutoff, label_p=k)
            theta = B if theta is None else \
                npc.tensordot(theta, B, axes=[['vR'], ['vL']])
            aL = 1. - aR
        return theta

    def norm_test(self):
        """Canonical-form check without dividing by S: the single-site
        density matrices against the bond Schmidt values.  Returns an
        ``(L, 2)`` array of left/right errors."""
        res = np.empty((self.L, 2))
        for i in range(self.L):
            th = self.get_theta(i, 1)
            p = [l for l in th.get_leg_labels() if l not in ('vL', 'vR')]
            pc = [l + '*' for l in p]
            rho_L = npc.tensordot(th, th.conj(),
                                  axes=[p + ['vR'], pc + ['vR*']])
            rho_L2 = npc.diag(np.asarray(self.get_SL(i)) ** 2,
                              rho_L.get_leg('vL'), dtype=rho_L.dtype,
                              labels=['vL', 'vL*'])
            res[i, 0] = npc.norm(rho_L - rho_L2)
            rho_R = npc.tensordot(th, th.conj(),
                                  axes=[['vL'] + p, ['vL*'] + pc])
            rho_R2 = npc.diag(np.asarray(self.get_SR(i)) ** 2,
                              rho_R.get_leg('vR'), dtype=rho_R.dtype,
                              labels=['vR', 'vR*'])
            res[i, 1] = npc.norm(rho_R - rho_R2)
        return res

    def real_if_close(self, tol=1e-12):
        """Drop a negligible imaginary part (in place)."""
        if not self.dtype.is_complex and \
                not any(B.dtype.is_complex for B in self._B):
            return self
        blocks = [b for B in self._B for b in B._data]
        mx = max((float(b.imag.abs().max()) for b in blocks
                  if b.is_complex() and b.numel()), default=0.)
        scale = max((float(b.abs().max()) for b in blocks if b.numel()),
                    default=1.)
        if mx > tol * max(scale, 1e-300):
            return self
        self._B = [B.real_if_close(tol=tol) for B in self._B]
        self.dtype = npc.result_type(*[B.dtype for B in self._B])
        return self


class BaseEnvironment:
    """Partial contractions ``LP[i]`` / ``RP[i]`` of ``<bra|ket>``, cached
    with their ages (a plain dict cache).

    ``LP[i]`` contracts everything left of site ``i`` (legs ``vR*, vR``),
    ``RP[i]`` everything right of site ``i`` (legs ``vL, vL*``);
    :class:`~tenpy_tpu_torch.networks.mpo.MPOEnvironment` adds the MPO leg
    and the start tensors.  ``cache``: a dict to keep them in (default a
    new one).
    """

    def __init__(self, bra, ket, cache=None, **init_env_data):
        self.bra = bra
        self.ket = ket
        assert bra.L == ket.L
        self.L = bra.L
        self.finite = bra.finite
        self.dtype = npc.result_type(bra.dtype, ket.dtype)
        self.cache = {} if cache is None else cache
        self._LP_age = [None] * self.L
        self._RP_age = [None] * self.L
        self.init_first_LP_last_RP(**init_env_data)

    def init_first_LP_last_RP(self, init_LP=None, init_RP=None, age_LP=0,
                              age_RP=0):
        if init_LP is None:
            init_LP = self.init_LP(0)
        if init_RP is None:
            init_RP = self.init_RP(self.L - 1)
        self.set_LP(0, init_LP, age=age_LP)
        self.set_RP(self.L - 1, init_RP, age=age_RP)

    def get_LP(self, i, store=True):
        """LP[i], contracted (and cached) from the nearest one available."""
        i0 = i
        while ('LP', i0 % self.L) not in self.cache:
            i0 -= 1
            if i - i0 > 2 * self.L:
                raise ValueError("no LP available")
        LP = self.cache[('LP', i0 % self.L)]
        age = self._LP_age[i0 % self.L]
        for j in range(i0, i):
            LP = self._contract_LP(j, LP)
            age += 1
            if store:
                self.set_LP(j + 1, LP, age=age)
        return LP

    def get_RP(self, i, store=True):
        i0 = i
        while ('RP', i0 % self.L) not in self.cache:
            i0 += 1
            if i0 - i > 2 * self.L:
                raise ValueError("no RP available")
        RP = self.cache[('RP', i0 % self.L)]
        age = self._RP_age[i0 % self.L]
        for j in range(i0, i, -1):
            RP = self._contract_RP(j, RP)
            age += 1
            if store:
                self.set_RP(j - 1, RP, age=age)
        return RP

    def set_LP(self, i, LP, age=0):
        self.cache[('LP', i % self.L)] = LP
        self._LP_age[i % self.L] = age

    def set_RP(self, i, RP, age=0):
        self.cache[('RP', i % self.L)] = RP
        self._RP_age[i % self.L] = age
