r"""Matrix product states and their environments on the host.

Port of the ``MPS`` container, ``BaseEnvironment`` and ``MPSEnvironment``
of ``tenpy_tpu/networks/mps.py``, with the same conventions:

* tensor labels ``vL, p, vR``; virtual legs have ``qconj=+1`` (vL) and
  ``-1`` (vR);
* canonical forms are exponent pairs ``(nL, nR)`` of the Schmidt values
  multiplied on the left and right: ``'B'=(0,1)``, ``'A'=(1,0)``,
  ``'C'=(0.5,0.5)``, ``'G'=(0,0)``, ``'Th'=(1,1)``;
* ``_S[i]`` are the Schmidt values on the bond left of site ``i`` (L+1
  entries; for infinite bc entry L mirrors entry 0), as numpy arrays; a
  density-matrix mixer of the host DMRG engines leaves a non-diagonal bond
  matrix (an Array with legs ``vL, vR``) there mid-run, which the form
  conversions and ``norm_test`` accept.

Since the write-back it also canonicalizes (``canonical_form``: the QR
sweeps of a finite MPS; for an infinite one the inverse-free iterated QR
gauge with its transfer-matrix fixed-point fallback and noise-floor
compression rescue) and measures (``entanglement_entropy``,
``expectation_value``, ``expectation_value_term``,
``correlation_function``, ``correlation_length`` through
:class:`TransferMatrix`, and ``overlap``: the full contraction of an
:class:`MPSEnvironment` for finite bc, the dominant transfer-matrix
eigenvalue per unit cell for infinite bc; ``MPSEnvironment.
expectation_value`` for ``<bra|op|ket>``).  For the time evolutions it
applies local operators (``apply_local_op``, ``apply_product_op``),
compresses (``compress``: SVD or variational) and is built from a dense
vector (``from_full``).  The blocks stay on the host;
the eigensolvers are :class:`~tenpy_tpu_torch.linalg.krylov_based.Arnoldi`.
"""

from __future__ import annotations

import logging
import warnings

import numpy as np
import torch

from ..linalg import np_conserved as npc
from ..linalg.charges import LegCharge
from ..linalg.krylov_based import Arnoldi, gram_schmidt
from ..linalg.truncation import TruncationError, svd_theta
from ..tools.cache import DictCache
from ..tools.math import entropy
from ..tools.params import asConfig
from .terms import order_combine_term

logger = logging.getLogger(__name__)

__all__ = ['MPS', 'BaseEnvironment', 'MPSEnvironment', 'TransferMatrix',
           'InitialStateBuilder', 'build_initial_state']


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
    _p_label = ['p']

    def __init__(self, sites, Bs, SVs, bc='finite', form='B', norm=1.):
        self.sites = list(sites)
        self.chinfo = self.sites[0].leg.chinfo
        self.dtype = npc.result_type(*[B.dtype for B in Bs])
        self.form = self._parse_form(form)
        self.bc = bc
        if bc not in self._valid_bc:
            raise ValueError(f"invalid bc {bc!r}")
        self.norm = norm
        self.segment_boundaries = (None, None)
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

    @property
    def nontrivial_bonds(self):
        return slice(1, self.L) if self.finite else slice(0, self.L + 1)

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
        res.segment_boundaries = self.segment_boundaries
        res._B = [B.copy(deep=False) for B in self._B]
        res._S = list(self._S)
        return res

    def test_sanity(self):
        assert len(self._B) == self.L
        assert len(self._S) == self.L + 1
        for B in self._B:
            assert set(B.get_leg_labels()) >= {'vL', 'p', 'vR'}

    def save_hdf5(self, hdf5_saver, h5gr, subpath):
        """The reference layout: children ``sites``, ``tensors``,
        ``singular_values``, ``boundary_condition``, ``canonical_form``,
        ``chinfo``, ``segment_boundaries``; attributes ``norm``,
        ``grouped``, ``transfermatrix_keep``, ``L`` (the port groups no
        sites and keeps one transfer-matrix eigenvector: 1 and 1)."""
        hdf5_saver.save(self.sites, subpath + 'sites')
        hdf5_saver.save(self._B, subpath + 'tensors')
        hdf5_saver.save(list(self._S), subpath + 'singular_values')
        hdf5_saver.save(self.bc, subpath + 'boundary_condition')
        hdf5_saver.save([None if f is None else list(f) for f in self.form],
                        subpath + 'canonical_form')
        hdf5_saver.save(self.chinfo, subpath + 'chinfo')
        hdf5_saver.save(self.segment_boundaries,
                        subpath + 'segment_boundaries')
        h5gr.attrs['norm'] = self.norm
        h5gr.attrs['grouped'] = 1
        h5gr.attrs['transfermatrix_keep'] = 1
        h5gr.attrs['L'] = self.L

    @classmethod
    def from_hdf5(cls, hdf5_loader, h5gr, subpath):
        obj = cls.__new__(cls)
        hdf5_loader.memorize_load(h5gr, obj)
        obj.sites = list(hdf5_loader.load(subpath + 'sites'))
        obj._B = list(hdf5_loader.load(subpath + 'tensors'))
        obj._S = [np.asarray(S) if not isinstance(S, npc.Array) else S
                  for S in hdf5_loader.load(subpath + 'singular_values')]
        obj.bc = hdf5_loader.load(subpath + 'boundary_condition')
        obj.form = [None if f is None else tuple(f) for f in
                    hdf5_loader.load(subpath + 'canonical_form')]
        obj.chinfo = hdf5_loader.load(subpath + 'chinfo')
        sb = hdf5_loader.load(subpath + 'segment_boundaries') \
            if 'segment_boundaries' in h5gr else None
        obj.segment_boundaries = tuple(sb) if sb is not None \
            else (None, None)
        obj.norm = float(hdf5_loader.get_attr(h5gr, 'norm'))
        grouped = int(h5gr.attrs.get('grouped', 1))
        if grouped != 1:
            raise NotImplementedError(f"an MPS of grouped sites "
                                      f"({grouped}) is not supported")
        obj.dtype = npc.result_type(*[B.dtype for B in obj._B])
        return obj

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

    def get_site(self, i):
        return self.sites[self._to_valid_index(i)]

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

    @classmethod
    def from_full(cls, sites, psi, form='B', cutoff=1e-16, normalize=True,
                  bc='finite'):
        """The exact MPS of a full wave function ``psi`` (an Array with
        one leg per site), split off site by site from the right by SVDs
        (singular values up to ``cutoff`` dropped); canonical."""
        if bc != 'finite':
            raise ValueError("from_full only for finite bc")
        L = len(sites)
        if psi.rank != L:
            raise ValueError("psi has wrong rank")
        psi = psi.copy(deep=False)
        psi.iset_leg_labels([f'p{i}' for i in range(L)])
        chinfo = psi.chinfo
        psi = psi.add_leg(LegCharge.from_trivial(1, chinfo, +1), 0, 0, 'vL')
        psi = psi.add_leg(LegCharge.from_trivial(1, chinfo, -1), 0, L + 1,
                          'vR')
        Bs, SVs = [], [np.ones(1)]
        trunc_par = {'chi_max': None, 'svd_min': cutoff, 'trunc_cut': None}
        rest = psi
        for i in range(L - 1, 0, -1):
            rest = rest.combine_legs([['vL'] + [f'p{k}' for k in range(i)],
                                      [f'p{i}', 'vR']], qconj=[+1, -1])
            U, S, VH, _, _ = svd_theta(rest, trunc_par)
            Bs.append(VH.split_legs([1]).ireplace_label(f'p{i}', 'p'))
            SVs.append(np.asarray(S))
            rest = U.split_legs([0]).iscale_axis(np.asarray(S), 'vR')
        rest.ireplace_label('p0', 'p')
        norm_rest = npc.norm(rest)
        if normalize:
            rest = rest / norm_rest
        Bs.append(rest)
        SVs.append(np.ones(1))
        res = cls(sites, Bs[::-1], SVs[::-1], bc=bc,
                  form=['Th'] + ['B'] * (L - 1),
                  norm=1. if normalize else norm_rest)
        res.canonical_form_finite()
        return res

    @classmethod
    def from_lat_product_state(cls, lat, p_state, allow_incommensurate=False,
                               **kwargs):
        """Product state given in lattice order: ``p_state`` indexed like
        the lattice's ``shape`` (each axis tiled periodically), entries as
        in :meth:`from_product_state` (with one more axis for local
        vectors)."""
        from ..tools.misc import to_array
        p_state = np.array(p_state, dtype=object)
        shape = list(lat.shape)
        if p_state.ndim == len(shape):
            p_state = to_array(p_state, shape,
                               allow_incommensurate=allow_incommensurate)
            flat = [p_state[tuple(idx)] for idx in lat.order]
        elif p_state.ndim == len(shape) + 1:
            p_state = to_array(p_state, shape + [None],
                               allow_incommensurate=allow_incommensurate)
            flat = [np.array(p_state[tuple(idx)], float)
                    for idx in lat.order]
        else:
            raise ValueError("wrong dimension of p_state")
        return cls.from_product_state(lat.mps_sites(), flat, bc=lat.bc_MPS,
                                      **kwargs)

    @classmethod
    def from_desired_bond_dimension(cls, sites, chi, bc='finite', seed=0,
                                    dtype=np.float64, p_state=None,
                                    n_sweeps=4):
        """A random charge-conserving MPS of bond dimension up to ``chi``:
        the product state ``p_state`` (default: basis state ``i % dim`` on
        site ``i``) after ``n_sweeps`` sweeps of random two-site gates
        (orthogonal for a real ``dtype``, else unitary), each truncated
        to ``chi``; canonical.  ``tenpy_tpu`` builds its state the same
        way from its own random numbers, so the two packages' states
        differ."""
        sites = list(sites)
        chi = int(chi) if np.isscalar(chi) else int(max(chi))
        if p_state is None:
            p_state = [i % s.dim for i, s in enumerate(sites)]
        psi = cls.from_product_state(sites, p_state, bc=bc, dtype=dtype)
        psi._random_gate_sweeps(n_sweeps, {'chi_max': chi, 'svd_min': 1e-14,
                                           'trunc_cut': None},
                                np.random.default_rng(seed), 1.)
        psi.canonical_form()
        return psi

    def perturb(self, randomize_params=None, close_1=True,
                canonicalize=True):
        """Apply random two-site gates, in place: ``N_steps`` (1) sweeps,
        each gate close to the identity with ``close_1`` (``exp(0.1 i
        H)``, H random), else fully random; truncated by
        ``randomize_params['trunc_params']``; ``seed`` (None: a fresh
        generator).  Used by the ``'randomized'`` initial state."""
        options = asConfig(randomize_params or {}, 'randomize')
        n_steps = options.get('N_steps', 1, int)
        close_1 = options.get('close_1', close_1)
        seed = options.get('seed', None)
        trunc = options.subconfig('trunc_params')
        trunc.setdefault('chi_max', 100)
        trunc.setdefault('svd_min', 1e-14)
        self._random_gate_sweeps(n_steps, trunc,
                                 np.random.default_rng(seed),
                                 0.1 if close_1 else 1.)
        if canonicalize:
            self.canonical_form()
        return self

    def _random_gate_sweeps(self, n_sweeps, trunc_par, rng, a):
        """``n_sweeps`` sweeps of random charge-conserving two-site gates
        ``exp(a X)``, X antisymmetric (a real state) or anti-hermitian,
        each followed by a truncated SVD as in :meth:`compress_svd`."""
        real = not self.dtype.is_complex
        for _ in range(n_sweeps):
            for i in range(self.L - 1 if self.finite else self.L):
                theta = self.get_theta(i, 2)
                U = _random_gate(theta.get_leg('p0'), theta.get_leg('p1'),
                                 rng, a, real)
                theta = npc.tensordot(U, theta, axes=[['p0*', 'p1*'],
                                                      ['p0', 'p1']])
                theta = theta.itranspose(['vL', 'p0', 'p1', 'vR'])
                theta = theta.combine_legs([['vL', 'p0'], ['p1', 'vR']],
                                           qconj=[+1, -1])
                Ut, S, VH, _, _ = svd_theta(theta, trunc_par)
                A_L = Ut.split_legs([0]).ireplace_label('p0', 'p')
                B_R = VH.split_legs([1]).ireplace_label('p1', 'p')
                self.set_SR(i, S)
                self.set_B(i + 1, B_R, 'B')
                if self.finite:
                    self.set_B(i, A_L, 'A')
                else:
                    B_L = A_L.iscale_axis(self._scale_S(self.get_SL(i), -1.),
                                          'vL')
                    self.set_B(i, B_L.iscale_axis(S, 'vR'), 'B')
        return self

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
            SL = self.get_SL(i)
            if isinstance(SL, npc.Array):       # a mixer's bond matrix
                B = npc.tensordot(self._matrix_S_pow(SL, dL, cutoff), B,
                                  axes=[['vR'], ['vL']])
            else:
                B = B.scale_axis(self._scale_S(SL, dL, cutoff), 'vL')
        if dR != 0.:
            SR = self.get_SR(i)
            if isinstance(SR, npc.Array):
                B = npc.tensordot(B, self._matrix_S_pow(SR, dR, cutoff),
                                  axes=[['vR'], ['vL']])
            else:
                B = B.scale_axis(self._scale_S(SR, dR, cutoff), 'vR')
        return B

    @staticmethod
    def _matrix_S_pow(S, exp, cutoff=1e-16):
        """A bond matrix ``S`` or its pseudo-inverse (``exp`` +-1);
        directions with a singular value below ``cutoff`` pass with factor
        1, as in :meth:`_scale_S`."""
        if exp == 1.:
            return S
        if exp != -1.:
            raise ValueError("matrix-valued S: only exponents +-1 supported")
        U, s, VH = npc.svd(S, inner_labels=['vR', 'vL'])
        s_inv = 1. / np.where(np.asarray(s) > cutoff, np.asarray(s), 1.)
        Sinv = npc.tensordot(VH.conj().iscale_axis(s_inv, 'vL*'), U.conj(),
                             axes=[['vL*'], ['vR*']])
        Sinv.iset_leg_labels(['vL', 'vR'])
        return Sinv

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
        return self._S[0] if self.bc == 'infinite' else self._S[self.L]

    def set_SL(self, i, S):
        i = self._to_valid_index(i)
        if not isinstance(S, npc.Array):     # a mixer's bond matrix stays
            S = np.asarray(S)
        self._S[i] = S
        if not self.finite and i == 0:
            self._S[self.L] = self._S[0]

    def set_SR(self, i, S):
        i = self._to_valid_index(i)
        if not isinstance(S, npc.Array):
            S = np.asarray(S)
        if i + 1 <= self.L:
            self._S[i + 1] = S
        if not self.finite and i + 1 == self.L:
            self._S[0] = S

    def get_theta(self, i, n=2, cutoff=1e-16, formL=1., formR=1.):
        """``n``-site wave function S--G--...--G--S with labels ``vL,
        p0, ..., p{n-1}, vR``; each inner Schmidt factor goes to the side
        whose stored form already carries it (no ``S^-1`` where avoidable).
        """
        theta = None
        for B in self._theta_tensors(i, n, cutoff, formL, formR):
            theta = B if theta is None else \
                npc.tensordot(theta, B, axes=[['vR'], ['vL']])
        return theta

    def _theta_tensors(self, i, n, cutoff=1e-16, formL=1., formR=1.,
                       label_p=True):
        """The ``n`` tensors whose product is :meth:`get_theta` ``(i, n)``
        (physical legs ``p0, ...`` with ``label_p``, else ``p``)."""
        i = self._to_valid_index(i)
        if n == 1:
            return [self.get_B(i, (formL, formR), cutoff=cutoff,
                               label_p=0 if label_p else None)]
        res = []
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
            res.append(self.get_B(i + k, (aL, aR), cutoff=cutoff,
                                  label_p=k if label_p else None))
            aL = 1. - aR
        return res

    def norm_test(self):
        """Canonical-form check without dividing by S: the single-site
        density matrices against the bond Schmidt values (or ``S S^H`` of a
        bond matrix).  Returns an ``(L, 2)`` array of left/right errors."""
        res = np.empty((self.L, 2))
        for i in range(self.L):
            th = self.get_theta(i, 1)
            p = [l for l in th.get_leg_labels() if l not in ('vL', 'vR')]
            pc = [l + '*' for l in p]
            rho_L = npc.tensordot(th, th.conj(),
                                  axes=[p + ['vR'], pc + ['vR*']])
            S = self.get_SL(i)
            if isinstance(S, npc.Array):
                rho_L2 = npc.tensordot(S, S.conj(), axes=[['vR'], ['vR*']])
                rho_L2.iset_leg_labels(['vL', 'vL*'])
            else:
                rho_L2 = npc.diag(np.asarray(S) ** 2, rho_L.get_leg('vL'),
                                  dtype=rho_L.dtype, labels=['vL', 'vL*'])
            res[i, 0] = npc.norm(rho_L - rho_L2)
            rho_R = npc.tensordot(th, th.conj(),
                                  axes=[['vL'] + p, ['vL*'] + pc])
            S = self.get_SR(i)
            if isinstance(S, npc.Array):
                rho_R2 = npc.tensordot(S.conj(), S, axes=[['vL*'], ['vL']])
                rho_R2.iset_leg_labels(['vR*', 'vR']).itranspose(['vR',
                                                                  'vR*'])
            else:
                rho_R2 = npc.diag(np.asarray(S) ** 2, rho_R.get_leg('vR'),
                                  dtype=rho_R.dtype, labels=['vR', 'vR*'])
            res[i, 1] = npc.norm(rho_R - rho_R2)
        return res

    def astype(self, dtype):
        """Convert every tensor to ``dtype`` (in place; S stays real)."""
        self.dtype = npc.as_dtype(dtype)
        self._B = [B.astype(self.dtype) for B in self._B]
        return self

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

    def gauge_consistency_error(self):
        """Largest isometry error of the tensors converted to the form
        opposite to their stored one.

        :meth:`norm_test` weighs everything by the Schmidt values and so
        cannot see garbage in noise-floor Schmidt directions, which a
        conversion that divides by S amplifies to O(1); this measures it.
        """
        p = list(self._p_label)
        pc = [l + '*' for l in p]
        err = 0.
        for i in range(self.L):
            st = self.form[i]
            if st is None:
                return np.inf
            if isinstance(self.get_SL(i), npc.Array) or \
                    isinstance(self.get_SR(i), npc.Array):
                continue        # a mixer's bond matrix: forms not comparable
            if st[0] >= 1. - 1e-12 and st[1] <= 1e-12:     # 'A': check B
                B = self.get_B(i, 'B')
                c = npc.tensordot(B, B.conj(),
                                  axes=[p + ['vR'], pc + ['vR*']])
            else:                                           # check A
                A = self.get_B(i, 'A')
                c = npc.tensordot(A.conj(), A,
                                  axes=[['vL*'] + pc, ['vL'] + p])
            err = max(err, npc.norm(c - npc.eye_like(c, 0)))
        return err

    # ----------------------------------------------------------- measurements
    def get_op(self, op_list, i):
        """Operator ``op_list[i % len(op_list)]`` at site ``i`` (a name is
        looked up on the site)."""
        i = self._to_valid_index(i)
        op = op_list[i % len(op_list)]
        if isinstance(op, str):
            op = self.sites[i].get_op(op)
        return op

    def entanglement_entropy(self, n=1, bonds=None):
        """Von Neumann (``n=1``) or Renyi entropy of the Schmidt values on
        each bond (default: the nontrivial bonds; for infinite bc the
        ``L + 1`` bonds ``0..L``)."""
        if bonds is None:
            nt = self.nontrivial_bonds
            bonds = range(nt.start, nt.stop)
        return np.array([entropy(np.asarray(self._S[ib if ib <= self.L
                                                    else ib % self.L]) ** 2,
                                 n) for ib in bonds])

    def entanglement_entropy_segment(self, segment, n=1):
        """The entropy of the reduced density matrix of the sites
        ``segment`` (from the theta spanning them; exponential in its
        length)."""
        segment = sorted(segment)
        i0 = segment[0]
        nsites = segment[-1] - i0 + 1
        theta = self.get_theta(i0, nsites)
        keep = [f'p{k - i0}' for k in segment]
        trace_out = [f'p{k}' for k in range(nsites)
                     if k + i0 not in segment]
        rho = npc.tensordot(theta, theta.conj(),
                            axes=[['vL', 'vR'] + trace_out,
                                  ['vL*', 'vR*'] + [t + '*'
                                                    for t in trace_out]])
        rho = rho.combine_legs([keep, [k + '*' for k in keep]],
                               qconj=[+1, -1])
        return entropy(npc.eigvalsh(rho), n)

    def entanglement_entropy_segment_1site(self, n=1):
        """The entropy of each single site's reduced density matrix."""
        res = []
        for i in range(self.L):
            theta = self.get_theta(i, 1)
            rho = npc.tensordot(theta, theta.conj(),
                                axes=[['vL', 'vR'], ['vL*', 'vR*']])
            res.append(entropy(npc.eigvalsh(rho), n))
        return np.array(res)

    def mutinf_two_site(self, max_range=None, n=1):
        """The mutual information ``S(i) + S(j) - S(i, j)`` of every pair
        ``i < j`` at most ``max_range`` apart: ``(coords, mutinf)``."""
        if max_range is None:
            max_range = self.L
        S_i = self.entanglement_entropy_segment_1site(n)
        coords, mutinf = [], []
        for i in range(self.L):
            jmax = i + max_range + 1
            if self.finite:
                jmax = min(jmax, self.L)
            for j in range(i + 1, jmax):
                S_ij = self.entanglement_entropy_segment([i, j], n)
                mutinf.append(S_i[i] + S_i[j % self.L] - S_ij)
                coords.append((i, j))
        return np.array(coords), np.array(mutinf)

    def get_rho_segment(self, segment):
        """The reduced density matrix of the sites ``segment`` (labels
        ``p0, p0*, ...`` in the segment's order); exponential in its
        length."""
        segment = np.sort(np.asarray(segment, int))
        if len(segment) > 20:
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
                B = B.replace_label('p', f'p{k}')
                k += 1
                rho = npc.tensordot(rho, B, axes=[['vR'], ['vL']])
                rho = npc.tensordot(rho, B.conj(), axes=[['vR*'], ['vL*']])
            else:
                rho = npc.tensordot(rho, B, axes=[['vR'], ['vL']])
                rho = npc.tensordot(rho, B.conj(),
                                    axes=[['vR*', 'p'], ['vL*', 'p*']])
        B = self.get_B(int(segment[-1]), 'B').replace_label('p', f'p{k}')
        rho = npc.tensordot(rho, B, axes=[['vR'], ['vL']])
        return npc.tensordot(rho, B.conj(),
                             axes=[['vR*', 'vR'], ['vL*', 'vR*']])

    def expectation_value(self, ops, sites=None):
        """``<psi|op_i|psi>`` per site ``i`` of ``sites`` (default all);
        ``ops`` is an operator (or name), or a list cycling over the
        sites.  An ``n``-site operator has legs ``p0, p0*, ...``."""
        if isinstance(ops, (str, npc.Array)):
            ops = [ops]
        if sites is None:
            sites = range(self.L)
        res = []
        for i in sites:
            op = self.get_op(ops, i)
            n = op.rank // 2
            if n == 1:
                theta = self.get_theta(i, 1)
                val = npc.tensordot(op, theta, axes=[['p*'], ['p0']])
                val = npc.tensordot(
                    theta.conj(), val,
                    axes=[['vL*', 'p0*', 'vR*'], ['vL', 'p', 'vR']])
            else:
                theta = self.get_theta(i, n)
                p = [f'p{k}' for k in range(n)]
                ps = [f'{l}*' for l in p]
                val = npc.tensordot(op, theta, axes=[ps, p])
                val = npc.tensordot(theta.conj(), val,
                                    axes=[['vL*', 'vR*'] + ps,
                                          ['vL', 'vR'] + p])
            res.append(complex(val))
        res = np.array(res)
        if np.allclose(res.imag, 0., atol=1e-14):
            res = res.real
        return res

    def expectation_value_multi_sites(self, operators, i0):
        """``<psi| op_0 op_1 ... |psi>`` for operators on the consecutive
        sites ``i0, i0 + 1, ...``: the same contraction as with the
        ``n``-site theta, done site by site (``O(n chi^3)``)."""
        ops = [self.get_op([op], i0 + k) if isinstance(op, str) else op
               for k, op in enumerate(operators)]
        rho = None
        for B, op in zip(self._theta_tensors(i0, len(ops), label_p=False),
                         ops):
            C = B if rho is None else \
                npc.tensordot(rho, B, axes=[['vR'], ['vL']])
            C = npc.tensordot(op, C, axes=[['p*'], ['p']])
            if rho is None:
                rho = npc.tensordot(B.conj(), C, axes=[['vL*', 'p*'],
                                                       ['vL', 'p']])
            else:
                rho = npc.tensordot(B.conj(), C, axes=[['vL*', 'p*'],
                                                       ['vR*', 'p']])
        return complex(npc.trace(rho, 'vR*', 'vR'))

    def expectation_value_term(self, term, autoJW=True):
        """The expectation value of a term ``[(opname, i), ...]``; with
        ``autoJW`` sorted with its fermionic sign and Jordan-Wigner strings
        inserted between fermionic operators."""
        term = list(term)
        if autoJW:
            term, sign = order_combine_term(term, self.sites)
        else:
            term = sorted(term, key=lambda x: x[1])
            sign = 1.
        idx = [i for _, i in term]
        i0, i1 = min(idx), max(idx)
        ops = []
        for x in range(i0, i1 + 1):
            ops_x = [op for op, i in term if i == x]
            opname = ops_x[0] if ops_x else 'Id'
            if autoJW:
                n_JW_left = sum(1 for op, i in term if i <= x and
                                self.get_site(i).op_needs_JW(op))
                later = [op for op, i in term if i > x and
                         self.get_site(i).op_needs_JW(op)]
                in_string = n_JW_left % 2 == 1 and len(later) > 0
                if ops_x:
                    if in_string:
                        opname = self.get_site(x).multiply_op_names(
                            ops_x + ['JW'])
                    elif len(ops_x) > 1:
                        opname = self.get_site(x).multiply_op_names(ops_x)
                else:
                    opname = 'JW' if in_string else 'Id'
            ops.append(opname)
        return sign * self.expectation_value_multi_sites(ops, i0)

    def correlation_function(self, ops1, ops2, sites1=None, sites2=None,
                             opstr=None, str_on_first=True, hermitian=False,
                             autoJW=True):
        """``<op1_i op2_j>`` for ``i`` in ``sites1`` and ``j`` in ``sites2``
        (default all sites); ``ops1``, ``ops2`` a name or a list cycling
        over the sites; ``opstr`` an explicit string operator between ``i``
        and ``j`` (then no automatic Jordan-Wigner strings).  Real where
        every imaginary part is below 1e-14."""
        sites1 = list(range(self.L) if sites1 is None else sites1)
        sites2 = list(range(self.L) if sites2 is None else sites2)
        res = np.empty((len(sites1), len(sites2)), dtype=complex)
        for a, i in enumerate(sites1):
            for b, j in enumerate(sites2):
                op1 = ops1 if isinstance(ops1, str) else ops1[i % len(ops1)]
                op2 = ops2 if isinstance(ops2, str) else ops2[j % len(ops2)]
                if i == j:
                    op = self.get_site(i).multiply_op_names([op1, op2])
                    res[a, b] = complex(self.expectation_value([op], [i])[0])
                    continue
                term = [(op1, i), (op2, j)] if i < j else \
                    [(op2, j), (op1, i)]
                if opstr is not None:
                    term = term + [(opstr, x)
                                   for x in range(min(i, j) + 1, max(i, j))]
                    res[a, b] = self.expectation_value_term(term,
                                                            autoJW=False)
                else:
                    res[a, b] = self.expectation_value_term(term,
                                                            autoJW=autoJW)
        if np.allclose(res.imag, 0., atol=1e-14):
            res = res.real
        return res

    def correlation_length(self, target=1, tol_ev0=1e-8, **kwargs):
        """``-L / log|eta_k|`` of the subleading transfer-matrix eigenvalues
        ``eta_1..eta_target`` (infinite bc; a float for ``target=1``).

        ``kwargs`` go to the Arnoldi solver.  By default, as in
        ``tenpy_tpu``, it stops once the dominant eigenpair has converged,
        so the subleading eigenvalues may not have: ``N_min = N_max = 30``
        converges them on the chi=256 Hubbard cylinder state, where the
        default is 7.2e-3 off (``tests/test_torch_state_distance.py``).
        ``tenpy_tpu``'s ``charge_sector`` option is not ported: its transfer
        matrix ignores it, so any sector but 0 gave a wrong answer."""
        assert not self.finite
        etas, _ = TransferMatrix(self, self).eigenvectors(
            num_ev=max(target + 2, 3), which='LM', **kwargs)
        etas = np.asarray(etas)
        if abs(np.abs(etas[0]) - 1.) > tol_ev0:
            warnings.warn(f"dominant TM eigenvalue not 1: {etas[0]}")
        if np.abs(etas[1]) > 1. - 1e-10:
            warnings.warn(
                "degenerate dominant transfer-matrix eigenvalue: the "
                "state is non-injective (a symmetry-broken cat state); "
                "the reported correlation length diverges")
        abs_etas = np.abs(etas[1:target + 1])
        with np.errstate(divide='ignore'):
            xi = np.where(abs_etas >= 1., np.inf, -self.L / np.log(abs_etas))
        return float(xi[0]) if target == 1 else xi

    def overlap(self, other):
        """``<self|other>``: for finite bc the full contraction of an
        :class:`MPSEnvironment`; for infinite bc the overlap per unit cell,
        the dominant eigenvalue of the mixed :class:`TransferMatrix`."""
        if self.finite:
            return MPSEnvironment(self, other).full_contraction(0)
        etas, _ = TransferMatrix(self, other).eigenvectors(which='LM')
        return complex(etas[0])

    # --------------------------------------------------------- canonical form
    def canonical_form(self, **kwargs):
        """Bring the MPS into canonical form, in place (finite: QR and SVD
        sweeps; infinite: :meth:`canonical_form_infinite`).  A real state
        stays real."""
        orig_complex = self.dtype.is_complex
        res = self.canonical_form_finite(**kwargs) if self.finite \
            else self.canonical_form_infinite(**kwargs)
        if not orig_complex:
            self.real_if_close()
        return res

    def _stripped_tensors(self, pinv_cutoff=None):
        """Chain tensors whose plain product is the state: B forms if every
        form is known, else the stored tensors (then the caller guarantees
        their product is the state).  With ``pinv_cutoff`` (relative),
        Schmidt directions below ``pinv_cutoff * max(S)`` give zero rows in
        the conversion instead of noise amplified by 1/S."""
        if any(f is None for f in self.form):
            return list(self._B)
        if pinv_cutoff is None:
            return [self.get_B(i, 'B') for i in range(self.L)]
        Ms = []
        for i in range(self.L):
            fL, fR = self.form[i]
            M = self._B[i].copy(deep=False)
            for exp, S, ax in [(-fL, self.get_SL(i), 'vL'),
                               (1. - fR, self.get_SR(i), 'vR')]:
                if exp == 0.:
                    continue
                S = np.asarray(S)
                if exp < 0:
                    fac = np.where(S > pinv_cutoff * np.max(S),
                                   np.where(S > 0, S, 1.) ** exp, 0.)
                else:
                    fac = S ** exp
                M = M.iscale_axis(fac, ax)
            Ms.append(M)
        return Ms

    def canonical_form_finite(self, renormalize=True, cutoff=0.,
                              envs_to_update=None):
        """QR sweep left to right, then SVD sweep right to left; every
        tensor ends in B form.

        On a segment (bc ``'segment'``) the state carries the boundary
        Schmidt values of its infinite surroundings, and the sweeps rotate
        its two boundary bases: the rotations ``(U_L, V_R)`` are returned,
        composed into :attr:`segment_boundaries` (from the original
        embedding's Schmidt states to the new ones), and applied to the
        start environments of every environment in ``envs_to_update``, so
        that the embedding stays what it was."""
        L = self.L
        if self.bc not in ('finite', 'segment'):
            raise ValueError("canonical_form_finite needs finite or "
                             "segment bc")
        seg = self.bc == 'segment'
        cut = cutoff if cutoff else None
        if seg:
            for i, S in ((0, self.get_SL(0)), (L, self.get_SR(L - 1))):
                S = np.asarray(S)
                self._S[i] = S / np.linalg.norm(S)
        Ms = self._stripped_tensors()
        if seg:     # the segment's wave function holds the left weights
            Ms[0] = Ms[0].scale_axis(np.asarray(self.get_SL(0)), 'vL')
        R = None
        for i in range(L):
            M = Ms[i]
            if R is not None:
                M = npc.tensordot(R, M, axes=[['vR'], ['vL']])
            Q, R = npc.qr(M.combine_legs([['vL', 'p']]),
                          inner_labels=['vR', 'vL'])
            Ms[i] = Q.split_legs([0])
        norm_fact = npc.norm(R)
        self.norm = 1. if renormalize else self.norm * norm_fact
        M = npc.tensordot(Ms[L - 1], R / norm_fact, axes=[['vR'], ['vL']])
        V_R = None
        if seg:     # the new right weights and the right basis rotation
            U, S, V_R = npc.svd(M.combine_legs([['vL', 'p']]), cutoff=cut,
                                qtotal_LR=[M.qtotal, None],
                                inner_labels=['vR', 'vL'])
            S = S / np.linalg.norm(S)
            self.set_SR(L - 1, S)
            M = U.iscale_axis(S, 'vR').split_legs([0])
        else:
            self.set_SR(L - 1, np.ones(M.get_leg('vR').ind_len))
        for i in range(L - 1, 0, -1):
            U, S, VH = npc.svd(M.combine_legs([['p', 'vR']], qconj=[-1]),
                               cutoff=cut,
                               qtotal_LR=[None, M.qtotal] if seg
                               else (None, None),
                               inner_labels=['vR', 'vL'])
            S = S / np.linalg.norm(S)
            self._B[i] = VH.split_legs([1])
            self.form[i] = self._valid_forms['B']
            self.set_SL(i, S)
            M = npc.tensordot(Ms[i - 1], U.iscale_axis(S, 'vR'),
                              axes=[['vR'], ['vL']])
        if seg:     # split off the left rotation: M = U_L S_0 B_0
            U_L, S0, VH = npc.svd(M.combine_legs([['p', 'vR']], qconj=[-1]),
                                  cutoff=cut, qtotal_LR=[None, M.qtotal],
                                  inner_labels=['vR', 'vL'])
            self.set_SL(0, S0 / np.linalg.norm(S0))
            self._B[0] = VH.split_legs([1])
            self.form[0] = self._valid_forms['B']
            for env in envs_to_update or ():
                env._update_gauge_boundaries(self, U_L, V_R)
            old_UL, old_VR = self.segment_boundaries
            if old_UL is not None:
                U_L_total = npc.tensordot(old_UL, U_L, axes=[['vR'], ['vL']])
                V_R_total = npc.tensordot(V_R, old_VR, axes=[['vR'], ['vL']])
                self.segment_boundaries = (U_L_total, V_R_total)
            else:
                self.segment_boundaries = (U_L, V_R)
            return U_L, V_R
        # M is site 0 in 'Th' form, with S_0 = 1 for finite bc
        self._B[0] = M.copy(deep=False).iscale_axis(
            self._scale_S(self.get_SL(0), -1.), 'vL')
        self.form[0] = self._valid_forms['B']
        return self

    def canonical_form_infinite(self, renormalize=True, tol=1e-14,
                                cutoff=1e-15, arnoldi_params=None):
        """Canonicalize an infinite MPS by iterated QR orthogonalization
        (inverse free, so noise-floor Schmidt values do no harm), in place.

        An already canonical state (``norm_test`` and
        :meth:`gauge_consistency_error` small) is left untouched.  A state
        with garbage in noise-floor Schmidt directions is first compressed
        by one SVD sweep (``svd_min=3e-8``).  If the QR gauge iteration
        stalls on a plateau, :meth:`canonical_form_infinite1` (the
        transfer-matrix fixed-point gauge) takes over, with a warning."""
        assert self.bc == 'infinite'
        L = self.L
        p_label = list(self._p_label)
        if all(f is not None for f in self.form):
            # idempotence: the gauge iteration can cycle between equivalent
            # gauges on exactly degenerate spectra, so don't enter it
            # needlessly
            if float(np.max(self.norm_test())) < 1e-12 and \
                    self.gauge_consistency_error() < 1e-6:
                return self
        Ms = self._stripped_tensors(pinv_cutoff=1e-8)
        if all(f is not None for f in self.form):
            # noise-floor Schmidt directions leave junk rows that the gauge
            # iteration would canonicalize into a wrong state: drop them by
            # one theta-level compression sweep first
            iso_err = 0.
            for M in Ms:
                c = npc.tensordot(M, M.conj(),
                                  axes=[p_label + ['vR'],
                                        [l + '*' for l in p_label] + ['vR*']])
                iso_err = max(iso_err, npc.norm(c - npc.eye_like(c, 0)))
            if iso_err > 1e-3:
                nt = float(np.max(self.norm_test()))
                log = logger.info if nt < 1e-4 else logger.warning
                log("canonical_form_infinite: noise-floor Schmidt directions "
                    "(stripped-isometry err=%.2e, norm_test=%.2e); "
                    "compressing them away before gauging", iso_err, nt)
                self.compress_svd({'chi_max': max(self.chi),
                                   'svd_min': 3e-8, 'trunc_cut': None})
                Ms = self._stripped_tensors(pinv_cutoff=1e-8)
        if any(f is None for f in self.form):
            self._S[0] = np.ones(Ms[0].get_leg('vL').ind_len)
        try:
            # right-orthogonalize: M_i R_{i+1} = R_i B_i
            R = npc.diag(1., Ms[0].get_leg('vL'), labels=['vL', 'vR'])
            Bs, R, norm_fact = _cf_orthogonalize(Ms, R, tol, p_label,
                                                 left=False,
                                                 arnoldi_params=arnoldi_params)
            # left-orthogonalize the new Bs: C_i B_i = A_i C_{i+1}
            SL0 = np.asarray(self.get_SL(0))
            legB0 = Bs[0].get_leg('vL')
            if SL0.ndim == 1 and SL0.shape[0] == legB0.ind_len:
                C = npc.diag(SL0 / np.linalg.norm(SL0), legB0,
                             labels=['vL', 'vR'])
            else:
                C = npc.diag(1., legB0, labels=['vL', 'vR'])
            As, C, _ = _cf_orthogonalize(Bs, C, tol, p_label, left=True,
                                         arnoldi_params=arnoldi_params)
        except _GaugePlateauError as e:
            logger.warning("canonical_form_infinite: %s -- falling back to "
                           "the transfer-matrix fixed-point gauge", e)
            return self.canonical_form_infinite1(
                renormalize=renormalize, cutoff=cutoff,
                arnoldi_params=arnoldi_params)
        # diagonalize the gauge C = U S V, then SVDs right to left store B
        # forms and diagonal S on every bond
        C.itranspose(['vL', 'vR'])
        U, S, V = npc.svd(C, cutoff=cutoff, inner_labels=['vR', 'vL'])
        As[0] = npc.tensordot(U.conj().ireplace_label('vR*', 'vL'), As[0],
                              axes=[['vL*'], ['vL']])
        for i in range(L - 1, -1, -1):
            th = npc.tensordot(As[i], U.scale_axis(S, 'vR'),
                               axes=[['vR'], ['vL']])
            th = th.combine_legs([p_label + ['vR']], qconj=[-1])
            U, S, V = npc.svd(th, cutoff=cutoff, inner_labels=['vR', 'vL'])
            S = S / np.linalg.norm(S)
            self._B[i] = V.split_legs([1])
            self.form[i] = self._valid_forms['B']
            self.set_SL(i, S)
        self._B[L - 1] = npc.tensordot(self._B[L - 1], U,
                                       axes=[['vR'], ['vL']])
        self.norm = 1. if renormalize else self.norm * norm_fact
        if any(len(self._S[i]) != As[i].get_leg('vL').ind_len
               for i in range(L)):
            # a cut mid-gauge perturbs the canonical form; one more pass,
            # free of truncation, restores it
            return self.canonical_form_infinite(
                renormalize=renormalize, tol=tol, cutoff=None,
                arnoldi_params=arnoldi_params)
        return self

    def canonical_form_infinite1(self, renormalize=True, cutoff=1e-16,
                                 arnoldi_params=None):
        """Gauge fixing on bond 0 per charge sector from the dominant
        transfer-matrix fixed points, then QR and SVD sweeps through the
        unit cell; in place."""
        assert self.bc == 'infinite'
        L = self.L
        Ms = self._stripped_tensors()
        psi_B = self.copy()
        for i in range(L):
            psi_B._B[i] = Ms[i]
            psi_B.form[i] = self._valid_forms['B']
        opts = dict(arnoldi_params or {})
        opts.setdefault('N_max', 40)
        opts.setdefault('P_tol', 1e-16)
        eta_R, vecs_R = TransferMatrix(psi_B, psi_B, transpose=False,
                                       form='B').eigenvectors(which='LM',
                                                              **opts)
        _, vecs_L = TransferMatrix(psi_B, psi_B, transpose=True,
                                   form='B').eigenvectors(which='LM', **opts)
        eta = float(np.abs(eta_R[0]))
        S_new, G, Ginv = _gauge_fixed_point_bond(vecs_L[0], vecs_R[0],
                                                 Ms[0].get_leg('vL'))
        # the chain becomes Ginv . chain . G on bond 0
        Ms[0] = npc.tensordot(Ginv, Ms[0], axes=[[1], [0]])
        Ms[0].iset_leg_labels(['vL', 'p', 'vR'])
        Ms[L - 1] = npc.tensordot(Ms[L - 1], G, axes=[[2], [0]])
        Ms[L - 1].iset_leg_labels(['vL', 'p', 'vR'])
        Ms[L - 1] = Ms[L - 1] / np.sqrt(eta)
        self.set_SL(0, S_new)
        R = npc.diag(S_new, Ms[0].get_leg('vL'), labels=['vL', 'vR'])
        As = []
        for i in range(L):
            M = npc.tensordot(R, Ms[i], axes=[['vR'], ['vL']])
            Q, R = npc.qr(M.combine_legs([['vL', 'p']]),
                          inner_labels=['vR', 'vL'])
            As.append(Q.split_legs([0]))
        Vt = R       # the leftover R on bond L (= bond 0)
        for i in range(L - 1, -1, -1):
            M = npc.tensordot(As[i], Vt, axes=[['vR'], ['vL']])
            U, S, VH = npc.svd(M.combine_legs([['p', 'vR']], qconj=[-1]),
                               cutoff=cutoff, inner_labels=['vR', 'vL'])
            S = S / np.linalg.norm(S)
            self._B[i] = VH.split_legs([1])
            self.form[i] = self._valid_forms['B']
            self.set_SL(i, S)
            Vt = U.iscale_axis(S, 'vR')
        # the leftover gauge U_0 diag(S_0) on bond 0: its unitary goes into
        # B_{L-1}, so bond L's basis is bond 0's
        U0 = Vt.copy(deep=False).iscale_axis(
            self._scale_S(self.get_SL(0), -1.), 'vR')
        self._B[L - 1] = npc.tensordot(self._B[L - 1], U0,
                                       axes=[['vR'], ['vL']])
        self._B[L - 1].iset_leg_labels(['vL', 'p', 'vR'])
        if renormalize:
            self.norm = 1.
        return self

    def compress_svd(self, trunc_par):
        """Compress by a sweep of truncated two-site SVDs, in place;
        returns the :class:`~tenpy_tpu_torch.linalg.truncation.
        TruncationError`."""
        trunc_par = asConfig(trunc_par, 'trunc_params')
        err = TruncationError()
        if self.finite:
            self.canonical_form_finite()
        for i in range(self.L - 1 if self.finite else self.L):
            theta = self.get_theta(i, 2).combine_legs(
                [['vL', 'p0'], ['p1', 'vR']], qconj=[+1, -1])
            U, S, VH, err_i, _ = svd_theta(theta, trunc_par)
            err += err_i
            A_L = U.split_legs([0]).ireplace_label('p0', 'p')
            B_R = VH.split_legs([1]).ireplace_label('p1', 'p')
            if self.finite:
                self.set_B(i, A_L, 'A')
                self.set_SR(i, S)
                self.set_B(i + 1, B_R, 'B')
            else:
                self.set_SR(i, S)
                self.set_B(i + 1, B_R, 'B')
                B_L = A_L.iscale_axis(self._scale_S(self.get_SL(i), -1.),
                                      'vL')
                self.set_B(i, B_L.iscale_axis(S, 'vR'), 'B')
        if self.finite:
            self.canonical_form_finite()
        return err


    def compress(self, options):
        """Compress in place: ``compression_method`` 'SVD'
        (:meth:`compress_svd` with ``trunc_params``) or 'variational'
        (:class:`~tenpy_tpu_torch.algorithms.mps_common.
        VariationalCompression`); returns the truncation error."""
        options = asConfig(options, 'MPS_compress')
        method = options.get('compression_method', 'SVD')
        if method == 'SVD':
            return self.compress_svd(options.subconfig('trunc_params'))
        if method == 'variational':
            from ..algorithms.mps_common import VariationalCompression
            return VariationalCompression(self, options).run()
        raise ValueError(f"unknown compression method {method!r}")

    # ------------------------------------------------------- local operators
    def apply_local_op(self, i, op, unitary=None, renormalize=False,
                       cutoff=1e-13):
        """Apply an operator (a name, or an Array with legs ``p, p*`` or
        ``p0, p1, ..., p0*, p1*, ...``) at site ``i`` (and the following
        ones), in place: a one-site operator keeps each tensor's form; an
        ``n``-site one is split back by SVDs (singular values up to
        ``cutoff`` dropped).

        A non-unitary operator (``unitary=None``: detected as
        ``|op^dagger op - 1| > cutoff``) is followed by ``canonical_form``,
        which moves the state's new norm into ``psi.norm``, or with
        ``renormalize`` drops it, as TeNPy does.  (``tenpy_tpu`` leaves
        the norm in the tensors, where the next truncated SVD of a time
        evolution drops it: its ``C(t)`` of a non-unitary ``A`` is
        ``C(t) / |A psi|``.)"""
        i = self._to_valid_index(i)
        if isinstance(op, str):
            op = self.sites[i].get_op(op)
        n = op.rank // 2
        if unitary is None:
            labels = [f'p{k}' for k in range(n)] if n > 1 else ['p']
            opo = op.copy(deep=False)
            if n > 1:
                opo.iset_leg_labels(labels + [lab + '*' for lab in labels])
            dd = npc.tensordot(opo.conj(), opo,
                               axes=[labels, [lab + '*' for lab in labels]])
            dd = dd.combine_legs([[lab + '*' for lab in labels], labels],
                                 qconj=[+1, -1]) if n > 1 else dd
            unitary = npc.norm(dd - npc.eye_like(dd, 0)) <= cutoff
        if n == 1:
            opB = npc.tensordot(op, self.get_B(i, None), axes=[['p*'],
                                                               ['p']])
            self.set_B(i, opB.itranspose(['vL', 'p', 'vR']), self.form[i])
        else:
            th = self.get_theta(i, n)
            labels = [f'p{k}' for k in range(n)]
            op = op.copy(deep=False)
            op.iset_leg_labels(labels + [lab + '*' for lab in labels])
            th = npc.tensordot(op, th, axes=[[lab + '*' for lab in labels],
                                             labels])
            th.itranspose(['vL'] + labels + ['vR'])
            self._set_theta_split(i, th, n, cutoff)
        if renormalize or not unitary:
            self.canonical_form(renormalize=renormalize)
        return self

    def _set_theta_split(self, i, theta, n, cutoff):
        """Split an ``n``-site theta back into B tensors by SVDs."""
        trunc_par = {'chi_max': None, 'svd_min': cutoff, 'trunc_cut': None}
        rest = theta
        for k in range(n - 1, 0, -1):
            rest = rest.combine_legs([['vL'] + [f'p{x}' for x in range(k)],
                                      [f'p{k}', 'vR']], qconj=[+1, -1])
            U, S, VH, _, _ = svd_theta(rest, trunc_par)
            self.set_B(i + k, VH.split_legs([1]).ireplace_label(f'p{k}',
                                                                'p'), 'B')
            self.set_SL(i + k, S)
            rest = U.split_legs([0]).iscale_axis(np.asarray(S), 'vR')
        rest = rest.copy(deep=False).iscale_axis(
            self._scale_S(self.get_SL(i), -1.), 'vL')
        rest.ireplace_label('p0', 'p')
        self.set_B(i, rest, 'B')

    def apply_product_op(self, ops, unitary=None, renormalize=False):
        """Apply one-site operators on every site (``ops`` a name or an
        Array, or a list cycling over the sites), in place."""
        for i in range(self.L):
            self.apply_local_op(i, ops[i % len(ops)] if isinstance(ops, list)
                                else ops, unitary=True)
        if renormalize:
            self.canonical_form(renormalize=True)
        return self

    # ------------------------------------------------------ charges, segments
    def probability_per_charge(self, bond=0):
        """``[(charge, probability), ...]``: the weight of each charge
        sector of the Schmidt states on ``bond`` (a finite state's bond
        ``L`` is the right end)."""
        if self.finite and bond == self.L:
            leg = self.get_B(self.L - 1, None).get_leg('vR').conj()
        else:
            leg = self.get_B(bond % self.L, None).get_leg('vL')
        S2 = np.asarray(self._S[bond % (self.L + 1) if self.finite
                                else bond % self.L]) ** 2
        res = []
        for qi in range(leg.block_number):
            sl = leg.get_slice(qi)
            q = self.chinfo.make_valid(leg.charges[qi] * leg.qconj)
            res.append((q, float(np.sum(S2[sl]))))
        return res

    def average_charge(self, bond=0):
        """The mean charge of the Schmidt states on ``bond``."""
        probs = self.probability_per_charge(bond)
        if not probs:
            return np.zeros(self.chinfo.qnumber)
        return sum(np.asarray(q, float) * p for q, p in probs)

    def charge_variance(self, bond=0):
        """``<Q^2> - <Q>^2`` of the Schmidt states' charge on ``bond``,
        per charge."""
        probs = self.probability_per_charge(bond)
        if not probs:
            return np.zeros(self.chinfo.qnumber)
        mean = self.average_charge(bond)
        return sum(np.asarray(q, float) ** 2 * p for q, p in probs) \
            - mean ** 2

    def get_total_charge(self, only_physical_legs=False):
        """The sum of the tensors' total charges; with
        ``only_physical_legs`` (finite or segment bc) less the charges of
        the two outer virtual legs' first sectors, which gives the
        physical charge of a state that keeps some of it on a boundary
        leg."""
        q = np.zeros(self.chinfo.qnumber, np.int64)
        for B in self._B:
            q += np.asarray(B.qtotal, np.int64)
        if only_physical_legs:
            if not self.finite:
                raise ValueError("only_physical_legs is not defined for "
                                 "infinite bc")
            for leg in (self._B[0].get_leg('vL'),
                        self._B[-1].get_leg('vR')):
                q -= np.asarray(leg.to_qflat()[0], np.int64) * leg.qconj
        return self.chinfo.make_valid(q)

    def extract_segment(self, first, last):
        """The sites ``[first, last]`` (of an infinite state, indices
        taken modulo ``L``) as a segment MPS in B form, with the Schmidt
        values of its two outer bonds."""
        sites = [self.get_site(i) for i in range(first, last + 1)]
        Bs = [self.get_B(i, 'B', copy=True) for i in range(first, last + 1)]
        SVs = [np.asarray(self.get_SL(i)) for i in range(first, last + 1)]
        SVs.append(np.asarray(self.get_SR(last)))
        return MPS(sites, Bs, SVs, bc='segment', form='B', norm=self.norm)


class BaseEnvironment:
    """Partial contractions ``LP[i]`` / ``RP[i]`` of ``<bra|ket>``, kept
    with their ages in a cache.

    ``LP[i]`` contracts everything left of site ``i`` (legs ``vR*, vR``),
    ``RP[i]`` everything right of site ``i`` (legs ``vL, vL*``);
    :class:`~tenpy_tpu_torch.networks.mpo.MPOEnvironment` adds the MPO leg
    and the start tensors.  ``cache``: a
    :class:`~tenpy_tpu_torch.tools.cache.DictCache` (or a sub-cache of one)
    to keep them in; default a new in-memory one.  The age of a tensor
    counts the sites contracted into it since its start tensor; an absent
    tensor has age None.
    """

    def __init__(self, bra, ket, cache=None, **init_env_data):
        self.bra = bra
        self.ket = ket
        assert bra.L == ket.L
        self.L = L = bra.L
        self.finite = bra.finite
        self.dtype = npc.result_type(bra.dtype, ket.dtype)
        self.cache = cache if cache is not None else DictCache.trivial()
        self._LP_keys = [f'LP_{i}' for i in range(L)]
        self._RP_keys = [f'RP_{i}' for i in range(L)]
        self._LP_age = [None] * L
        self._RP_age = [None] * L
        self.init_first_LP_last_RP(**init_env_data)

    def init_first_LP_last_RP(self, init_LP=None, init_RP=None, age_LP=0,
                              age_RP=0, start_env_sites=None):
        """Set ``LP[0]`` and ``RP[L-1]``: given, or the start tensors
        ``start_env_sites`` sites outside contracted in."""
        if init_LP is None:
            init_LP = self.init_LP(0, start_env_sites or 0)
        if init_RP is None:
            init_RP = self.init_RP(self.L - 1, start_env_sites or 0)
        self.set_LP(0, init_LP, age=age_LP)
        self.set_RP(self.L - 1, init_RP, age=age_RP)

    def _update_gauge_boundaries(self, psi, U_L, V_R):
        """Rotate the stored boundary environments after a gauge change of
        ``psi``'s boundary bases by ``(U_L, V_R)`` (a segment's
        ``canonical_form_finite``)."""
        LP = self.get_LP(0, store=False)
        RP = self.get_RP(self.L - 1, store=False)
        ageL = self.get_LP_age(0)
        ageR = self.get_RP_age(self.L - 1)
        self.clear()
        if self.ket is psi:
            LP = npc.tensordot(LP, U_L, axes=[['vR'], ['vL']])
            RP = npc.tensordot(V_R, RP, axes=[['vR'], ['vL']])
        if self.bra is psi:
            LP = npc.tensordot(LP, U_L.conj(), axes=[['vR*'], ['vL*']])
            RP = npc.tensordot(V_R.conj(), RP, axes=[['vR*'], ['vL*']])
        LP.itranspose(['vR*', 'wR', 'vR'] if 'wR' in LP.get_leg_labels()
                      else ['vR*', 'vR'])
        RP.itranspose(['wL', 'vL', 'vL*'] if 'wL' in RP.get_leg_labels()
                      else ['vL', 'vL*'])
        self.set_LP(0, LP, age=ageL)
        self.set_RP(self.L - 1, RP, age=ageR)

    def get_LP(self, i, store=True):
        """LP[i], contracted (and stored, with ``store``) from the nearest
        one available to its left."""
        i0 = i
        while self._LP_age[i0 % self.L] is None or \
                self._LP_keys[i0 % self.L] not in self.cache:
            i0 -= 1
            if i - i0 > 2 * self.L:
                raise ValueError("no LP available")
        LP = self.cache[self._LP_keys[i0 % self.L]]
        age = self._LP_age[i0 % self.L]
        for j in range(i0, i):
            LP = self._contract_LP(j, LP)
            age += 1
            if store:
                self.set_LP(j + 1, LP, age=age)
        return LP

    def get_RP(self, i, store=True):
        """RP[i], contracted (and stored) from the nearest one to its
        right."""
        i0 = i
        while self._RP_age[i0 % self.L] is None or \
                self._RP_keys[i0 % self.L] not in self.cache:
            i0 += 1
            if i0 - i > 2 * self.L:
                raise ValueError("no RP available")
        RP = self.cache[self._RP_keys[i0 % self.L]]
        age = self._RP_age[i0 % self.L]
        for j in range(i0, i, -1):
            RP = self._contract_RP(j, RP)
            age += 1
            if store:
                self.set_RP(j - 1, RP, age=age)
        return RP

    def set_LP(self, i, LP, age=0):
        i = i % self.L
        self.cache[self._LP_keys[i]] = LP
        self._LP_age[i] = age

    def set_RP(self, i, RP, age=0):
        i = i % self.L
        self.cache[self._RP_keys[i]] = RP
        self._RP_age[i] = age

    def get_LP_age(self, i):
        return self._LP_age[i % self.L]

    def get_RP_age(self, i):
        return self._RP_age[i % self.L]

    def has_LP(self, i):
        return self._LP_age[i % self.L] is not None

    def has_RP(self, i):
        return self._RP_age[i % self.L] is not None

    def del_LP(self, i):
        i = i % self.L
        if self._LP_keys[i] in self.cache:
            del self.cache[self._LP_keys[i]]
        self._LP_age[i] = None

    def del_RP(self, i):
        i = i % self.L
        if self._RP_keys[i] in self.cache:
            del self.cache[self._RP_keys[i]]
        self._RP_age[i] = None

    def clear(self):
        for i in range(self.L):
            self.del_LP(i)
            self.del_RP(i)

    def cache_optimize(self, short_term_LP=(), short_term_RP=(),
                       preload_LP=None, preload_RP=None):
        """Tell the cache which tensors to keep in RAM and which to load
        next."""
        keys = [self._LP_keys[i % self.L] for i in short_term_LP] + \
            [self._RP_keys[i % self.L] for i in short_term_RP]
        self.cache.set_short_term_keys(*keys)
        pre = []
        if preload_LP is not None:
            pre.append(self._LP_keys[preload_LP % self.L])
        if preload_RP is not None:
            pre.append(self._RP_keys[preload_RP % self.L])
        if pre:
            self.cache.preload(*pre)


    def expectation_value(self, ops, sites=None):
        """``<bra|op_i|ket>`` (times both norms) for each site ``i`` of
        ``sites`` (default all); ``ops`` an operator (or name) or a list
        cycling over the sites."""
        if sites is None:
            sites = range(self.L)
        res = []
        for i in sites:
            op = ops[i % len(ops)] if isinstance(ops, (list, tuple)) else ops
            if isinstance(op, str):
                op = self.ket.get_site(i).get_op(op)
            C = npc.tensordot(self.get_LP(i), self.ket.get_B(i, 'Th'),
                              axes=[['vR'], ['vL']])
            C = npc.tensordot(op, C, axes=[['p*'], ['p']])
            C = npc.tensordot(C, self.get_RP(i), axes=[['vR'], ['vL']])
            val = npc.tensordot(self.bra.get_B(i, 'Th').conj(), C,
                                axes=[['vL*', 'p*', 'vR*'],
                                      ['vR*', 'p', 'vL*']])
            res.append(complex(val) * self.bra.norm * self.ket.norm)
        res = np.array(res)
        if np.allclose(res.imag, 0, atol=1e-14):
            res = res.real
        return res


class MPSEnvironment(BaseEnvironment):
    """Partial contractions of ``<bra|ket>`` with no operator between:
    ``LP[i]`` (legs ``vR*, vR``) from the A forms, ``RP[i]`` (legs ``vL,
    vL*``) from the B forms, starting from the identity; every physical
    leg of the state (``p``, and ``q`` of a purification) is contracted
    bra with ket."""

    def init_LP(self, i, start_env_sites=0):
        i0 = i - start_env_sites
        leg = self.ket.get_B(i0, None).get_leg('vL')
        LP = npc.diag(1., leg, dtype=self.dtype, labels=['vR*', 'vR'])
        for j in range(i0, i):
            LP = self._contract_LP(j, LP)
        return LP

    def init_RP(self, i, start_env_sites=0):
        i0 = i + start_env_sites
        leg = self.ket.get_B(i0, None).get_leg('vR')
        RP = npc.diag(1., leg.conj(), dtype=self.dtype, labels=['vL', 'vL*'])
        for j in range(i0, i, -1):
            RP = self._contract_RP(j, RP)
        return RP

    def _contract_LP(self, i, LP):
        p = list(getattr(self.ket, '_p_label', ['p']))
        LP = npc.tensordot(LP, self.ket.get_B(i, 'A'), axes=[['vR'], ['vL']])
        return npc.tensordot(self.bra.get_B(i, 'A').conj(), LP,
                             axes=[['vL*'] + [l + '*' for l in p],
                                   ['vR*'] + p])

    def _contract_RP(self, i, RP):
        p = list(getattr(self.ket, '_p_label', ['p']))
        RP = npc.tensordot(self.ket.get_B(i, 'B'), RP, axes=[['vR'], ['vL']])
        return npc.tensordot(RP, self.bra.get_B(i, 'B').conj(),
                             axes=[p + ['vL*'], [l + '*' for l in p]
                                   + ['vR*']])

    def full_contraction(self, i0):
        """``<bra|ket>`` (times both norms), split at bond ``i0``: for
        ``i0 == 0`` (or ``L - 1`` for finite bc) the whole chain contracted
        into ``LP`` and traced (for a segment weighted by the right
        boundary's Schmidt values, which ``tenpy_tpu`` leaves out), else
        ``LP[i0]`` and ``RP[i0-1]`` with the Schmidt values of bond ``i0``
        between them."""
        if i0 == 0 or (self.ket.finite and i0 + 1 == self.L):
            LP = self._contract_LP(self.L - 1, self.get_LP(self.L - 1))
            if self.ket.bc == 'segment':
                # the A forms end in the right boundary's Schmidt basis,
                # whose weights the trace has to carry
                L = self.L - 1
                LP = LP.scale_axis(np.conj(np.asarray(self.bra.get_SR(L))),
                                   'vR*')
                LP = LP.iscale_axis(np.asarray(self.ket.get_SR(L)), 'vR')
            contr = npc.trace(LP, 'vR*', 'vR')
        else:
            LP = self.get_LP(i0).scale_axis(
                np.conj(np.asarray(self.bra.get_SL(i0))), 'vR*')
            LP = LP.iscale_axis(np.asarray(self.ket.get_SL(i0)), 'vR')
            contr = npc.tensordot(LP, self.get_RP(i0 - 1),
                                  axes=[['vR*', 'vR'], ['vL*', 'vL']])
        return complex(contr) * self.bra.norm * self.ket.norm


class _DeflatedLinearOperator:
    """``(1 - P) T (1 - P)``, ``P`` the projector onto found eigenvectors:
    degenerate copies of a dominant eigenvalue show up in its spectrum."""

    def __init__(self, op, basis):
        self.op = op
        self.basis = basis

    def project(self, v):
        for u in self.basis:
            v = v - complex(npc.inner(u.conj(), v, axes='range')) * u
        return v

    def matvec(self, v):
        return self.project(self.op.matvec(self.project(v)))


def _random_like(a, seed):
    """A copy of ``a`` whose blocks are standard normal numbers drawn from
    ``np.random.default_rng(seed)`` block by block (as ``tenpy_tpu``)."""
    rng = np.random.default_rng(seed)
    res = a.copy(deep=False)
    res._data = [torch.from_numpy(rng.standard_normal(tuple(b.shape))).to(
        a.dtype) for b in a._data]
    return res


class TransferMatrix:
    r"""Transfer matrix of ``<bra|ket>`` over one unit cell, a linear
    operator on 2-leg Arrays.

    ``transpose=False``: acts on ``(vL, vL*)`` vectors from the right
    (``X -> sum_p B X B^dagger``); ``True``: on ``(vR, vR*)`` from the left.
    ``form`` is the canonical form of the tensors it applies."""

    def __init__(self, bra, ket, transpose=False, form='B'):
        self.bra = bra
        self.ket = ket
        self.transpose = transpose
        self.L = ket.L
        self.form = form
        self.dtype = npc.result_type(bra.dtype, ket.dtype)

    def initial_guess(self, diag=1.):
        """The identity in the vectors' leg structure.  Where bra and ket
        have different bond legs (two states whose truncations kept
        different sectors), the identity on the sectors both legs hold."""
        i, lab = (0, 'vL') if not self.transpose else (self.L - 1, 'vR')
        leg = self.ket.get_B(i, self.form).get_leg(lab)
        leg_bra = self.bra.get_B(i, self.form).get_leg(lab)
        labels = [lab, lab + '*']
        if leg_bra == leg:
            return npc.diag(diag, leg, dtype=self.dtype, labels=labels)
        res = npc.Array([leg, leg_bra.conj()], self.dtype, None, labels)
        chinfo = leg.chinfo
        pos = {tuple(chinfo.make_valid(leg_bra.charges[b] * leg_bra.qconj)):
               b for b in range(leg_bra.block_number)}
        rows, blocks = [], []
        for a in range(leg.block_number):
            b = pos.get(tuple(chinfo.make_valid(leg.charges[a] * leg.qconj)))
            if b is None:
                continue
            rows.append((a, b))
            blocks.append(diag * torch.eye(
                int(leg.slices[a + 1] - leg.slices[a]),
                int(leg_bra.slices[b + 1] - leg_bra.slices[b]),
                dtype=self.dtype))
        res._set_blocks(np.array(rows, np.intp).reshape(len(rows), 2),
                        blocks)
        return res

    def matvec(self, vec):
        X = vec
        if not self.transpose:
            for j in range(self.L - 1, -1, -1):
                B = self.ket.get_B(j, self.form)
                Bc = self.bra.get_B(j, self.form).conj()
                X = npc.tensordot(B, X, axes=[['vR'], ['vL']])
                X = npc.tensordot(X, Bc, axes=[['p', 'vL*'], ['p*', 'vR*']])
            return X.iset_leg_labels(['vL', 'vL*'])
        for j in range(self.L):
            B = self.ket.get_B(j, self.form)
            Bc = self.bra.get_B(j, self.form).conj()
            X = npc.tensordot(X, B, axes=[['vR'], ['vL']])
            X = npc.tensordot(Bc, X, axes=[['vL*', 'p*'], ['vR*', 'p']])
        return X.iset_leg_labels(['vR*', 'vR']).itranspose(['vR', 'vR*'])

    def eigenvectors(self, num_ev=1, which='LM', **kwargs):
        """Dominant eigenpairs ``(etas, vecs)`` by Arnoldi.

        With ``num_ev > 1`` the identity guess (the exact dominant
        eigenvector of a canonical transfer matrix) gets a seeded random
        part, and a second Arnoldi pass on the operator deflated against the
        first pass's eigenvectors finds degenerate copies; the ``num_ev``
        largest of both passes are returned."""
        v0 = self.initial_guess()
        if num_ev > 1:
            rnd = _random_like(v0, 42)
            v0 = v0 + rnd * (0.5 / max(npc.norm(rnd), 1e-300))
        opts = dict(kwargs)
        opts.setdefault('N_max', max(20, 2 * num_ev + 10))
        opts['which'] = which
        opts['num_ev'] = num_ev
        if num_ev == 1:
            eta, vec, _ = Arnoldi(self, v0, opts).run()
            return np.array([eta]), [vec]
        etas, vecs, _ = Arnoldi(self, v0, opts).run()
        etas, vecs = list(np.asarray(etas)), list(vecs)
        deflated = _DeflatedLinearOperator(
            self, gram_schmidt([v.copy() for v in vecs]))
        v1 = deflated.project(_random_like(self.initial_guess(), 7))
        nrm = npc.norm(v1)
        if nrm > 1e-12:
            etas2, vecs2, _ = Arnoldi(deflated, v1 / nrm, opts).run()
            etas += list(np.asarray(etas2))
            vecs += list(vecs2)
        order = np.argsort(-np.abs(np.asarray(etas)))[:num_ev]
        return np.asarray(etas)[order], [vecs[i] for i in order]


def _gauge_fixed_point_bond(rho_L, rho_R, leg, cutoff=1e-14):
    """Per charge sector, the gauge that makes bond 0 canonical.

    ``rho_L`` (legs ``vR, vR*``) and ``rho_R`` (``vL, vL*``) are the
    dominant left and right fixed points of a B-form chain.  Per sector,
    ``X = sqrt(l)``, ``Y = sqrt(r)``, ``U S V^dagger = X Y`` and ``G = Y V``;
    returns ``(S, G, Ginv)`` such that ``Ginv . chain . G`` is right
    canonical with Schmidt values ``S`` on bond 0 (G and Ginv have legs
    ``[leg, leg.conj()]``).  A sector the state does not reach gets the
    identity and zero weight."""
    R_blocks = {int(r[0]): b for r, b in zip(rho_R._qdata, rho_R._data)}
    # the transpose TM's fixed point is the transpose of the standard one
    L_blocks = {int(r[0]): b.T for r, b in zip(rho_L._qdata, rho_L._data)}
    # fix each fixed point's global phase (Arnoldi's is arbitrary)
    phases = []
    for blocks in (R_blocks, L_blocks):
        tr = sum(torch.trace(b) for b in blocks.values())
        phases.append(tr / abs(tr) if abs(tr) > 0 else 1.)
    phR, phL = phases

    def sqrt_psd(m):
        w, v = torch.linalg.eigh(0.5 * (m + m.conj().T))
        return (v * torch.sqrt(torch.clamp(w, min=0.))) @ v.conj().T

    S_parts, G_blocks, Ginv_blocks = [], [], []
    for qi in range(leg.block_number):
        n = int(leg.slices[qi + 1] - leg.slices[qi])
        r, l = R_blocks.get(qi), L_blocks.get(qi)
        if r is None or l is None:
            G_blocks.append(torch.eye(n, dtype=torch.float64))
            Ginv_blocks.append(torch.eye(n, dtype=torch.float64))
            S_parts.append(torch.zeros(n, dtype=torch.float64))
            continue
        Y, X = sqrt_psd(r / phR), sqrt_psd(l / phL)
        _, S, Vh = torch.linalg.svd(X @ Y)
        V = Vh.conj().T
        G_blocks.append(Y @ V)
        # pinv(Y V) = V^dagger pinv(Y)
        Ginv_blocks.append(V.conj().T @ torch.linalg.pinv(Y, rtol=cutoff))
        S_parts.append(S.to(torch.float64))
    S_full = torch.cat(S_parts).numpy() if S_parts else np.zeros(0)
    nrm = np.linalg.norm(S_full)
    if nrm > 0:
        S_full = S_full / nrm
    dtype = torch.complex128 if any(b.is_complex() for b in G_blocks) \
        else torch.float64
    rows = np.array([(qi, qi) for qi in range(leg.block_number)],
                    np.intp).reshape(-1, 2)
    G = npc.zeros([leg, leg.conj()], dtype=dtype)
    Ginv = npc.zeros([leg, leg.conj()], dtype=dtype)
    G._set_blocks(rows, [b.to(dtype) for b in G_blocks])
    Ginv._set_blocks(rows, [b.to(dtype) for b in Ginv_blocks])
    return S_full, G, Ginv


class _OrthoTM:
    """Mixed transfer matrix between fixed isometries ``Qs`` (bra) and
    tensors ``Ms`` (ket): the operator whose fixed point is the gauge of
    :func:`_cf_orthogonalize` (Arnoldi accelerates the iteration)."""

    def __init__(self, Qs, Ms, left):
        self.Qs = Qs
        self.Ms = Ms
        self.left = left

    def matvec(self, x):
        if self.left:   # x legs (vL=new, vR=old), left to right
            for Q, M in zip(self.Qs, self.Ms):
                x = npc.tensordot(x, M, axes=[['vR'], ['vL']])
                inner = list(Q.get_leg_labels()[:-1])
                x = npc.tensordot(Q.conj(), x,
                                  axes=[[l + '*' for l in inner], inner])
                x.ireplace_label('vR*', 'vL')
                x.itranspose(['vL', 'vR'])
        else:           # x legs (vL=old, vR=new), right to left
            for Q, M in zip(reversed(self.Qs), reversed(self.Ms)):
                x = npc.tensordot(M, x, axes=[['vR'], ['vL']])
                inner = list(Q.get_leg_labels()[1:])
                x = npc.tensordot(x, Q.conj(),
                                  axes=[inner, [l + '*' for l in inner]])
                x.ireplace_label('vL*', 'vR')
                x.itranspose(['vL', 'vR'])
        return x


def _cf_orthogonalize(Ms, X, tol, p_label, left, arnoldi_params=None,
                      max_iters=1000):
    """Iterated QR orthogonalization of an infinite unit cell
    (vanderstraeten2019, Alg. 1 and 2): isometries ``Qs`` and gauge ``X``
    with ``X_i M_i = Q_i X_{i+1}`` (left) or ``M_i X_{i+1} = X_i Q_i``
    (right).  Returns ``(Qs, X, norm)``, ``norm`` the converged factor per
    unit cell.  Once roughly converged, Arnoldi on :class:`_OrthoTM`
    accelerates it; a plateau below 1e-6 is accepted with a warning, a
    higher one raises :class:`_GaugePlateauError`."""
    L = len(Ms)
    err = np.inf
    best = (np.inf, None, None, 1.)
    for _ in range(max_iters):
        X = X / npc.norm(X)
        X_old = X
        Qs = [None] * L
        if left:
            for i in range(L):
                XM = npc.tensordot(X, Ms[i], axes=[['vR'], ['vL']])
                XM = XM.combine_legs([['vL'] + p_label], qconj=[+1])
                Q, X = npc.qr(XM, inner_labels=['vR', 'vL'], pos_diag_R=True,
                              qtotal_Q=XM.qtotal)
                Qs[i] = Q.split_legs([0])
        else:
            for i in range(L - 1, -1, -1):
                MX = npc.tensordot(Ms[i], X, axes=[['vR'], ['vL']])
                MX = MX.combine_legs([p_label + ['vR']], qconj=[-1])
                # the carry X stays charge neutral (Q takes the site's
                # charge), else a charged unit cell grows its qtotal by the
                # cell's charge every sweep
                X, Q = npc.lq(MX, inner_labels=['vR', 'vL'], pos_diag_L=True,
                              qtotal_L=MX.chinfo.make_valid())
                Qs[i] = Q.split_legs([1])
        norm = npc.norm(X)
        X = X / norm
        try:
            X_old_t = X_old.transpose(X.get_leg_labels())
            for la, lb in zip(X.legs, X_old_t.legs):
                # the same leg, not only a compatible one: the first sweep
                # changes the inner legs' convention
                if la.qconj != lb.qconj or \
                        not np.array_equal(la.charges, lb.charges) or \
                        not np.array_equal(la.slices, lb.slices):
                    raise ValueError("leg mismatch")
            err = npc.norm(X - X_old_t)
        except (ValueError, KeyError):
            err = np.inf
        if err <= tol:
            return Qs, X, norm
        if err < best[0]:
            best = (err, Qs, X, norm)
        if err < 1e-2:
            opts = dict(arnoldi_params or {})
            opts.setdefault('N_max', 20)
            opts['E_tol'] = max(err / 10., 1e-16)
            opts.setdefault('which', 'LM')
            try:
                _, X_acc, _ = Arnoldi(_OrthoTM(Qs, Ms, left), X, opts).run()
                X_acc.itranspose(['vL', 'vR'])
                if left:
                    _, X_acc = npc.qr(X_acc, inner_labels=['vR', 'vL'],
                                      pos_diag_R=True)
                else:
                    X_acc, _ = npc.lq(X_acc, inner_labels=['vR', 'vL'],
                                      pos_diag_L=True)
                X = X_acc.iset_leg_labels(['vL', 'vR'])
            except (ValueError, KeyError, ArithmeticError, RuntimeError,
                    np.linalg.LinAlgError):
                pass   # the plain power iteration goes on
    if best[0] < 1e-6:
        # degenerate singular values leave a residual gauge-phase noise
        # floor; the state is canonical to about best err
        logger.warning("canonical_form_infinite: gauge iteration plateaued "
                       "at err=%.2e (tol=%.0e)", best[0], tol)
        return best[1], best[2], best[3]
    raise _GaugePlateauError(f"canonical_form_infinite did not converge to "
                             f"tol={tol}; last err={err}")


class _GaugePlateauError(RuntimeError):
    """The QR gauge iteration plateaued (degenerate or near-critical
    transfer matrix)."""


def _random_gate(leg0, leg1, rng, a, real):
    """A random two-site gate ``exp(a X)`` on the legs ``p0, p1`` that
    conserves their charges: X is antisymmetric (``real``) or
    anti-hermitian with normal entries within each charge sector of the
    pair.  Legs ``p0, p1, p0*, p1*``."""
    import scipy.linalg
    d0, d1 = leg0.ind_len, leg1.ind_len
    chinfo = leg0.chinfo
    q = (leg0.to_qflat()[:, None, :] * leg0.qconj
         + leg1.to_qflat()[None, :, :] * leg1.qconj).reshape(
             d0 * d1, chinfo.qnumber)
    q = chinfo.make_valid(q)
    U = np.zeros((d0 * d1, d0 * d1), np.float64 if real else np.complex128)
    for qs in np.unique(q, axis=0):
        idx = np.nonzero(np.all(q == qs, axis=1))[0]
        n = len(idx)
        X = rng.standard_normal((n, n))
        if not real:
            X = X + 1j * rng.standard_normal((n, n))
        X = (X - X.conj().T) * 0.5
        U[np.ix_(idx, idx)] = scipy.linalg.expm(a * X)
    # zero outside the sectors by construction (the check's roundoff
    # would warn)
    return npc.Array.from_ndarray(U.reshape(d0, d1, d0, d1),
                                  [leg0, leg1, leg0.conj(), leg1.conj()],
                                  labels=['p0', 'p1', 'p0*', 'p1*'],
                                  warn_wrong_sector=False)


class InitialStateBuilder:
    """The initial MPS of a simulation, from options.

    Options: ``method``, one of 'lat_product_state' (``product_state`` in
    lattice order, ``allow_incommensurate``), 'mps_product_state'
    (``product_state`` in MPS order), 'randomized' (the state of
    ``randomized_from_method`` perturbed by ``randomize_params``,
    ``randomize_close_1``), 'desired_bond_dimension' (``chi``) and
    'from_file' (``filename``, ``data_key`` 'psi': a result file of this
    package, or an HDF5 file of the JAX package or the reference
    library)."""

    def __init__(self, lattice, options, model_dtype=np.float64):
        self.lattice = lattice
        self.options = asConfig(options, 'InitialStateBuilder')
        self.model_dtype = model_dtype

    def run(self):
        method_name = self.options.get('method', 'lat_product_state', str)
        method = getattr(self, method_name, None)
        if method is None or method_name.startswith('_') or \
                method_name in ('run', 'check_total_charge'):
            raise ValueError(f"unknown InitialStateBuilder method "
                             f"{method_name!r}")
        psi = method()
        self.check_total_charge(psi)
        return psi

    def check_total_charge(self, psi):
        psi.test_sanity()
        return True

    def lat_product_state(self, p_state=None):
        if p_state is None:
            p_state = self.options['product_state']
        allow = self.options.get('allow_incommensurate', False)
        return MPS.from_lat_product_state(self.lattice, p_state,
                                          allow_incommensurate=allow,
                                          dtype=self.model_dtype)

    def mps_product_state(self, p_state=None):
        if p_state is None:
            p_state = self.options['product_state']
        return MPS.from_product_state(self.lattice.mps_sites(), p_state,
                                      bc=self.lattice.bc_MPS,
                                      dtype=self.model_dtype)

    def randomized(self):
        method = self.options.get('randomized_from_method',
                                  'lat_product_state', str)
        psi = getattr(self, method)()
        randomize_params = self.options.subconfig('randomize_params')
        close_1 = self.options.get('randomize_close_1', False)
        psi.perturb(randomize_params, close_1=close_1)
        return psi

    def desired_bond_dimension(self):
        return MPS.from_desired_bond_dimension(
            self.lattice.mps_sites(), self.options['chi'],
            bc=self.lattice.bc_MPS, dtype=self.model_dtype)

    def from_file(self):
        from ..tools.io import load
        data = load(self.options['filename'])
        data_key = self.options.get('data_key', 'psi', str)
        return data[data_key] if isinstance(data, dict) else data


def build_initial_state(size, states, filling, mode='random', seed=None):
    """``size`` entries of ``states`` in the fractions ``filling``
    (rounded; the first state takes the remainder), shuffled with
    ``mode='random'``."""
    n_each = np.array(np.round(np.asarray(filling) * size), int)
    n_each[0] += size - int(np.sum(n_each))
    result = []
    for st, n in zip(states, n_each):
        result.extend([st] * int(n))
    if mode == 'random':
        np.random.default_rng(seed).shuffle(result)
    return result
