r"""Device-resident TEBD on the bucket-packed layout.

Port of ``DeviceTEBDEngine`` from ``tenpy_tpu/algorithms/packed_tebd.py``.
The sweep state (the B tensors and the bond Schmidt values) lives on one
device, in fixed-capacity bond layouts
(:func:`~tenpy_tpu_torch.algorithms.packed_dmrg.capacity_bond_layouts`),
and one bond update is

    C      = U . (B_i . B_{i+1})          (packed tensordots; no left S)
    theta  = S_i . C                      (bond scale: the SVD input)
    A,S',B = split_truncate(theta)        (batched SVD per charge sector)
    B_L    = (C . B'^H) / renorm          (inverse-free left tensor)

Each of the three tensordots is one launch of the hand-written kernel of
:mod:`~tenpy_tpu_torch.linalg.grouped_gemm` on a CUDA device.  PyTorch runs
eagerly, so the JAX version's cache of jitted bond steps becomes a cache of
split plans; the host receives nothing per update: the truncation errors
stay on the device and come to the host once per :meth:`evolve`.

Real-time evolution runs on native complex128 (the state and the gates are
promoted once, in the setup); imaginary time stays float64.  Trotter orders
1, 2, 4 and ``'4_opt'`` (:mod:`~tenpy_tpu_torch.algorithms.tebd`), finite
and infinite bc.  :meth:`DeviceTEBDEngine.run` ends in
:meth:`DeviceTEBDEngine.write_back`, which writes the state into the
caller's MPS and re-gauges it with ``MPS.canonical_form`` where the
truncation left it off canonical form.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..linalg import packed as pk
from ..linalg import packed_split as ps
from ..linalg.charges import QTYPE
from ..linalg.padding import embed_array
from ..linalg.truncation import TruncationError
from .packed_dmrg import capacity_bond_layouts, pack_bond_S
from .tebd import calc_U_bond, suzuki_trotter_decomposition, \
    suzuki_trotter_time_steps

logger = logging.getLogger(__name__)

__all__ = ['DeviceTEBDEngine']


def _bond_step(B0, B1, S_left, U, plan, chi_max, svd_min, backend):
    """One bond update on the device: ``(B_L, S, B_R, err, renorm)``, with
    ``err`` and ``renorm`` 0-dim device tensors."""
    C = pk.tensordot(B0.replace_labels(['p'], ['p0']),
                     B1.replace_labels(['p'], ['p1']), axes=(['vR'], ['vL']))
    C = pk.tensordot(U, C, axes=(['p0*', 'p1*'], ['p0', 'p1']))
    C = C.transpose(['vL', 'p0', 'p1', 'vR'])
    theta = ps.scale_bond(C, S_left, ps.scale_bond_plan(C, 'vL'))
    _, S, Bn, err, renorm, _ = ps.split_truncate(theta, plan, chi_max,
                                                 svd_min, backend)
    BL = pk.tensordot(C, Bn.conj(), axes=(['p1', 'vR'], ['p*', 'vR*']))
    BL = BL.replace_labels(['p0', 'vL*'], ['p', 'vR'])
    BL = BL.transpose(['vL', 'p', 'vR'])
    inv = torch.where(renorm > 0.,
                      1. / torch.where(renorm > 0., renorm, 1.), 0.)
    return BL * inv, S, Bn, err, renorm


class DeviceTEBDEngine:
    """Device-resident TEBD starting from a canonical MPS.

    Parameters
    ----------
    psi : :class:`~tenpy_tpu_torch.networks.mps.MPS`
        Finite or infinite MPS in canonical form; updated in place by
        :meth:`write_back` (called from :meth:`run`).
    model : :class:`~tenpy_tpu_torch.models.model.NearestNeighborModel`
        Provides ``H_bond``.
    options : dict
        dt : float -- time step (default 0.1).
        N_steps : int -- Trotter steps per :meth:`run` (default 5).
        order : 1, 2, 4 or '4_opt' -- Trotter order (default 2).
        type_evo : 'real' | 'imag' (default 'real').
        chi_max, svd_min, backend, multiple, cap_factor, total_cap_factor :
            as for :class:`~tenpy_tpu_torch.algorithms.packed_dmrg.
            DeviceSweepEngine` (``backend``: ``'svd'``, the default,
            ``'qr_eigh'``, ``'qr_eigh32'``, ``'jacobi'``, ``'jacobi32'`` or
            ``'auto'``; the capacity layouts are
            fixed for the engine's life: a state that grows past them needs
            a new engine built from the written-back state).
    device : str or torch.device
        Where the state lives: the card by default, where every packed
        tensordot is one launch of the CUDA kernel; raises where there is no
        card.  ``'cpu'`` runs the kernel's plain version.

    ``write_back_stats`` holds the last write-back's seconds and
    ``norm_test`` before and after its re-gauge.
    """

    def __init__(self, psi, model, options=None, device='cuda'):
        self.device = pk.checked_device(device)
        self.psi = psi
        self.model = model
        opts = dict(options or {})
        self.chi_max = int(opts.get('chi_max', max(psi.chi)))
        self.svd_min = float(opts.get('svd_min', 1e-10))
        self.dt = float(opts.get('dt', 0.1))
        self.N_steps = int(opts.get('N_steps', 5))
        self.order = opts.get('order', 2)
        if self.order != '4_opt':
            self.order = int(self.order)
        self.type_evo = opts.get('type_evo', 'real')
        self.backend = opts.get('backend', None)
        self.multiple = int(opts.get('multiple', 64))
        self.cap_factor = float(opts.get('cap_factor', 1.2))
        self.total_cap_factor = float(opts.get('total_cap_factor', 1.5))
        self.finite = psi.bc == 'finite'
        self.L = psi.L
        if self.L < 2:
            raise ValueError("DeviceTEBDEngine needs L >= 2")
        self.n_bonds = self.L + 1 if self.finite else self.L
        self.evolved_time = 0.
        self.trunc_err = TruncationError()
        self.write_back_stats = {}
        self._plan_cache = {}
        self._setup()

    # ------------------------------------------------------------ setup
    def _bond(self, i):
        return self.bond[i if self.finite else i % self.L]

    def _setup(self):
        """The capacity layouts, the packed state (promoted to complex128
        once for real time) and the packed gates."""
        psi, L = self.psi, self.L
        psi.real_if_close()
        self.bond, _ = capacity_bond_layouts(
            psi, chi_max=self.chi_max, multiple=self.multiple,
            cap_factor=self.cap_factor,
            total_cap_factor=self.total_cap_factor)
        complex_evo = self.type_evo == 'real'
        self.Bp = []
        self.qtotal_site = []
        for i in range(L):
            B = psi.get_B(i, 'B').transpose(['vL', 'p', 'vR'])
            if complex_evo and not B.dtype.is_complex:
                B = B.astype(torch.complex128)
            self.qtotal_site.append(
                tuple(int(x) for x in np.asarray(B.qtotal, QTYPE).ravel()))
            padded = embed_array(B, {'vL': self._bond(i),
                                     'vR': self._bond(i + 1).conj()})
            self.Bp.append(pk.pack(padded, pad=False, device=self.device))
        self.Sp = [pack_bond_S(psi, i, self._bond(i), self.device)
                   for i in range(self.n_bonds)]
        self._calc_U()

    def _calc_U(self):
        """The packed bond gates of every Trotter substep (host eigh, then
        one pack each)."""
        self.Up = []
        for dt_frac in suzuki_trotter_time_steps(self.order):
            row = [None] * self.L
            for i, h in enumerate(self.model.H_bond):
                if h is None:
                    continue
                U = calc_U_bond(h, dt_frac * self.dt, self.type_evo)
                U.itranspose(['p0', 'p1', 'p0*', 'p1*'])
                row[i] = pk.pack(U, pad=False, device=self.device)
            self.Up.append(row)

    # ------------------------------------------------------ bond update
    def update_bond(self, i, Up):
        """Update bond ``i`` (sites ``i-1, i``) with the packed gate
        ``Up``; returns the device scalars ``(err, renorm)`` without a
        host sync."""
        L = self.L
        i0, i1 = (i - 1) % L, i % L
        B0, B1 = self.Bp[i0], self.Bp[i1]
        S_left = self.Sp[i - 1 if self.finite else (i - 1) % self.n_bonds]
        mid = i if self.finite else i % self.n_bonds
        # the split plan of theta's structure (U keeps the p legs, qtotal 0)
        pkey = (B0.struct_sig(), B1.struct_sig(), Up.struct_sig(), mid)
        plan = self._plan_cache.get(pkey)
        if plan is None:
            plan = ps.split_plan(self._theta_struct(B0, B1, Up),
                                 self._bond(i), self.qtotal_site[i0])
            self._plan_cache[pkey] = plan
        BL, S, Bn, err, renorm = _bond_step(B0, B1, S_left, Up, plan,
                                            self.chi_max, self.svd_min,
                                            self.backend)
        self.Bp[i0] = BL
        self.Bp[i1] = Bn
        self.Sp[mid] = S
        return err, renorm

    def _theta_struct(self, B0, B1, Up):
        """Structure-only packed theta of ``U . (B0 . B1)``."""
        chinfo = B0.legs[0].chinfo
        out_legs = (B0.legs[0], B0.legs[1], B1.legs[1], B1.legs[2])
        qtotal = tuple(int(x) for x in chinfo.make_valid(
            np.asarray(B0.qtotal, QTYPE) + np.asarray(B1.qtotal, QTYPE)
            + np.asarray(Up.qtotal, QTYPE)))
        shapes, qdatas = pk.complete_structure(out_legs, qtotal)
        dtype = torch.promote_types(torch.promote_types(B0.dtype, B1.dtype),
                                    Up.dtype)
        return pk.PackedArray(out_legs, qtotal, ('vL', 'p0', 'p1', 'vR'),
                              shapes, qdatas, [], dtype, B0.device)

    # -------------------------------------------------------- evolution
    def evolve_step(self, U_idx, odd):
        """Apply the gates ``Up[U_idx]`` to all odd or even bonds (one
        brickwall layer); returns the bonds' device ``(err, renorm)``."""
        Us = self.Up[U_idx]
        bonds = range(1, self.L) if self.finite else range(0, self.L)
        out = []
        for i in bonds:
            if i % 2 == (1 if odd else 0):
                U = Us[i % self.L]
                if U is None:
                    continue
                out.append(self.update_bond(i, U))
        return out

    def evolve(self, N_steps=None, dt=None):
        """Trotter-evolve by ``N_steps * dt``; the truncation errors come to
        the host once, at the end.  Returns this call's
        :class:`~tenpy_tpu_torch.linalg.truncation.TruncationError`."""
        if N_steps is None:
            N_steps = self.N_steps
        if dt is not None and dt != self.dt:
            self.dt = float(dt)
            self._calc_U()
        scalars = []
        for U_idx, odd in suzuki_trotter_decomposition(self.order, N_steps):
            scalars.extend(self.evolve_step(U_idx, odd))
        err = TruncationError()
        if scalars:
            eps = torch.stack([e for e, _ in scalars]).cpu().numpy()
            for e in eps:
                err = err + TruncationError(float(e), 1. - 2. * float(e))
        self.evolved_time += N_steps * self.dt
        self.trunc_err = self.trunc_err + err
        return err

    def run(self):
        """:meth:`evolve` by ``N_steps``, then :meth:`write_back`; returns
        the truncation error of the evolution."""
        t0 = time.time()
        err = self.evolve(self.N_steps)
        logger.info("device TEBD: %d steps dt=%s in %.2fs (trunc_err %.2e)",
                    self.N_steps, self.dt, time.time() - t0, err.eps)
        self.write_back()
        return err

    # ------------------------------------------------------- write-back
    def write_back(self):
        """Write the device state into the caller's MPS ``self.psi``.

        One move to the host: the zero Schmidt values are pruned, the B
        tensors and Schmidt values set, and a real-time state that stayed
        real is made real again (``real_if_close``).  The inverse-free
        update keeps the tensors isometric only up to the truncation, so
        where ``max(norm_test) > 1e-12`` the state is re-gauged with
        ``MPS.canonical_form`` (``tenpy_tpu`` leaves it as it is).
        ``write_back_stats`` gets the seconds of the move (``unpack_s``)
        and of the re-gauge (``canonical_form_s``) and ``norm_test`` before
        and after it."""
        psi, L = self.psi, self.L
        t0 = time.time()
        Ss = [s.cpu().numpy() for s in self.Sp]
        keeps = []
        for S in Ss:
            keep = S > 0.
            if not keep.any():
                keep[0] = True
            keeps.append(keep)

        def keep_at(i):
            return keeps[i if self.finite else i % L]

        for i in range(L):
            T = pk.unpack(self.Bp[i])
            T.iproject(keep_at(i), 'vL')
            T.iproject(keep_at(i + 1), 'vR')
            psi.set_B(i, T, form='B')
        for i in range(self.n_bonds):
            if self.finite and i == self.n_bonds - 1:
                psi.set_SR(L - 1, Ss[i][keeps[i]])
            else:
                psi.set_SL(i % L, Ss[i][keeps[i]])
        psi.real_if_close()
        st = {'unpack_s': time.time() - t0,
              'norm_test_before': float(np.max(psi.norm_test()))}
        if st['norm_test_before'] > 1e-12:
            t1 = time.time()
            psi.canonical_form()
            st['canonical_form_s'] = time.time() - t1
        st['norm_test_after'] = float(np.max(psi.norm_test()))
        self.write_back_stats = st
