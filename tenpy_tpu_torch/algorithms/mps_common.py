r"""Sweeps, effective Hamiltonians, mixers, compression, and the packed
Krylov solvers.

Port of ``tenpy_tpu/algorithms/mps_common.py``, in two parts.

The host engines' machinery: the plain effective-Hamiltonian matvecs on
:class:`~tenpy_tpu_torch.linalg.np_conserved.Array` s,
:class:`EffectiveH` (:class:`TwoSiteH`, :class:`OneSiteH`,
:class:`ZeroSiteH`), the mixers (:class:`DensityMatrixMixer`,
:class:`SubspaceExpansion`), and :class:`Sweep` / :class:`IterativeSweeps`,
on which :mod:`~tenpy_tpu_torch.algorithms.dmrg` stands, and the
compression engines (:class:`VariationalCompression`,
:class:`VariationalApplyMPO`, :class:`QRBasedVariationalApplyMPO`) of
``MPS.compress`` and ``MPO.apply``.  ``tenpy_tpu``
also ``jax.jit`` s the plain matvec per block structure above a size
threshold (``JIT_SIZE_THRESHOLD``, 2**62: off by default) and has a
per-block jitted Lanczos; neither is ported, the plain matvec is their
counterpart.

The device path (``BUCKET_MULTIPLE``, ``_matvec_2site_packed``,
``_matvec_1site_packed``, ``_matvec_0site_packed``, the ground-state
Lanczos :func:`lanczos_ground_packed` of any packed matvec, with its
two-site forms ``_lanczos_K_2site_packed_impl`` and
:func:`lanczos_K_2site_packed` for the DMRG eigensolve, and TDVP's Krylov
exponential
:func:`lanczos_evolve_packed`): every two-site matvec is four packed
tensordots, every one-site matvec three, every zero-site (bond matrix)
matvec two, each one launch of the hand-written kernel on a CUDA device.
:meth:`EffectiveH.pack_operands` packs an effective H's LP, RP and W once
for its ``packed_matvec``.  The
``lax.scan`` / ``lax.while_loop`` of the JAX version become Python loops
over device tensors; the K x K tridiagonal eigenproblem runs on a host f64
copy.  The early-exit loop reads one scalar pair per iteration from the
device.  A complex Hamiltonian or guess runs the same loop on complex128
vectors: alpha = Re<v|Hv> and beta = |w| are real, so the tridiagonal
problem stays real.  ``DEVICE_LANCZOS_THRESHOLD`` is the size of the
effective problem from which :class:`~tenpy_tpu_torch.algorithms.dmrg.
DMRGEngine` sends a two-site update there by default: the card's own
crossover against the host Lanczos, not ``tenpy_tpu``'s TPU value;
``DEVICE_EVOLUTION_THRESHOLD`` the one from which the TDVP engines send a
local evolution there.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .algorithm import Algorithm
from ..linalg import np_conserved as npc
from ..linalg import packed as pk
from ..linalg.charges import QTYPE, LegCharge
from ..linalg.krylov_based import lanczos_evolve
from ..linalg.sparse import NpcLinearOperator, OrthogonalNpcLinearOperator
from ..linalg.truncation import TruncationError, svd_theta, eigh_rho
from ..networks.mpo import MPOEnvironment
from ..networks.mps import MPSEnvironment
from ..tools.cache import DictCache
from ..tools.events import EventHandler
from ..tools.misc import find_subclass
from ..tools.params import asConfig

logger = logging.getLogger(__name__)

__all__ = ['BUCKET_MULTIPLE', 'DEVICE_LANCZOS_THRESHOLD',
           'DEVICE_EVOLUTION_THRESHOLD', 'DEVICE_SPLIT_THRESHOLD',
           'DEVICE_EXCITATION_THRESHOLD',
           '_matvec_2site_packed', '_matvec_1site_packed',
           '_matvec_0site_packed', '_lanczos_K_2site_packed_impl',
           'lanczos_K_2site_packed', 'lanczos_ground_packed',
           'use_device_lanczos',
           'lanczos_evolve_packed', 'PackedVectorOps', 'pack_virtual',
           'pack_W', 'Sweep', 'IterativeSweeps',
           'EffectiveH', 'OneSiteH', 'TwoSiteH', 'ZeroSiteH', 'Mixer',
           'DensityMatrixMixer', 'SubspaceExpansion',
           'VariationalCompression', 'VariationalApplyMPO',
           'QRBasedVariationalApplyMPO']

# Sector sizes of virtual legs are rounded up to this multiple on the packed
# path; the same constant as tenpy_tpu's default, so both packages build the
# same layouts.
BUCKET_MULTIPLE = 64
# The size N of a two-site effective problem from which the DMRG engines
# send its eigensolve to the packed Lanczos on a CUDA device by default: the
# card's crossover, measured by chip_smoke.py phase 9 on an H100 80GB HBM3
# at 700 W (PERF.md): 10 Lanczos steps, the card's first call (packing and
# plan builds included) against the host Lanczos on the same effective H of
# the chi=512 XX chain.  The card won in every run from N=256 up (0.52-0.91x
# the host's time at N=256; at N=64 it lost a cold first call, 1.62x); below
# N=64 the engines take ED_block anyway.  lanczos_params['device_K'] forces
# (> 0) or disables (0) the route.
DEVICE_LANCZOS_THRESHOLD = 256
# The size N of a two- or one-site effective problem from which the TDVP
# engines send its Krylov evolution to the card.  chip_smoke.py phase 11
# times it on an H100 80GB HBM3 at 700 W (PERF.md): 6 Krylov steps of
# exp(-0.5j dt H) theta on the chi=256 XX chain, the card against the
# host's LanczosEvolution, the table three times, in two runs.  The card's
# first call with its structure's tensordot plans cached (what a TDVP run
# pays: at saturated chi it builds about 100 plans for 21,900 hits) won
# every two-site run from N=256 up (0.15-0.76 the host's time); at N=64 it
# read 0.56-0.68 in five runs and 1.02 in one, and with the plans built
# anew 0.98-1.11, a tie.  So the card costs nothing at 64, but it does not
# win every run there, the rule DEVICE_LANCZOS_THRESHOLD was read by.  64
# rather than 256 is set by phase 11's check that 90% of the two-site
# evolutions of the L=32 chain run on the card: at 256 the chain's ends
# keep 12.9% of them on the host.
DEVICE_EVOLUTION_THRESHOLD = 64
# The number of entries N of a purification bond update's theta (vL p0 q0
# p1 q1 vR) from which PurificationTEBD sends the gate contraction and the
# truncated split to the card by default; None: no update.  chip_smoke.py
# phase 13c times the card's update against the host's on the same theta
# of the L=32 XX chain at beta=10, chi up to 256, on an H100 80GB HBM3 at
# 700 W (PERF.md): the card lost at every N from 256 to 1,048,576 (1.09-5.3
# times the host's time, its plans cached or built anew), bound by
# cuSOLVER's batched Jacobi SVD (130 ms of a 160 ms update at chi=256,
# against 23-27 ms for the host's whole SVD).  So no update goes to the
# card unless device_threshold asks for it.
DEVICE_SPLIT_THRESHOLD = None
# The number of entries N of a plane-wave excitation's X tensors (summed over
# the unit cell) from which PlaneWaveExcitationEngine sends a solve to the
# card by default.  chip_smoke.py phase 14c times one matvec of the card's
# route (its plans cached, and its first call, which builds them) against
# the host's on the same X, with the explicit sums, on an H100 80GB HBM3 at
# 700 W (PERF.md): the S=1 chain's VUMPS states at chi 32, 64 and 128 (N =
# 551-708, 2824, 10676-10792) and the TFI chain at chi 11 (N = 242), in
# six runs.  The card won every run at N=551-708 (0.35-0.67 the host's
# time) and N=10676-10792 (0.28-0.70), five of six at N=2824 (0.64-0.97)
# and lost the sixth by 2.6% (1.026), and lost every run at N=242
# (1.25-1.68).  So 708, not 10676 (from which the card won every run, the
# rule DEVICE_LANCZOS_THRESHOLD was read by): between them the card never
# lost by more than 3%, while the host's own time there varied 2x from
# run to run.  The first call's plan builds (0.88-1.22 the host's time at
# N=2824, 0.45-0.46 at 551) are paid once in a solve of 20-60 matvecs.
# Both routes are host-bound, the card's at 0.8-1.4 ms of host time per
# tensordot.
DEVICE_EXCITATION_THRESHOLD = 708

_VIRT = ('vL', 'vR', 'vL*', 'vR*')


def pack_virtual(a, device, dtype=None):
    """An LP, RP or theta for the packed matvecs on ``device``: converted
    to ``dtype`` on the host first (if given), its virtual legs padded to
    ``BUCKET_MULTIPLE``."""
    if dtype is not None:
        a = a.astype(dtype)
    return pk.pack(a, multiple=BUCKET_MULTIPLE, pad_labels=_VIRT,
                   device=device)


def pack_W(W, device, dtype=None):
    """A W tensor for the packed matvecs on ``device`` (no padding),
    converted to ``dtype`` on the host first (if given)."""
    if dtype is not None:
        W = W.astype(dtype)
    return pk.pack(W, pad=False, device=device)


def _matvec_2site_plain_impl(LP, RP, W0, W1, theta):
    """``(LP W0 W1 RP) theta`` for theta with legs ``(vL, p0, p1, vR)``."""
    x = npc.tensordot(LP, theta, axes=[['vR'], ['vL']])
    x = npc.tensordot(x, W0, axes=[['wR', 'p0'], ['wL', 'p0*']])
    x = npc.tensordot(x, W1, axes=[['wR', 'p1'], ['wL', 'p1*']])
    x = npc.tensordot(x, RP, axes=[['wR', 'vR'], ['wL', 'vL']])
    x.ireplace_labels(['vR*', 'vL*'], ['vL', 'vR'])
    return x.itranspose(['vL', 'p0', 'p1', 'vR'])


def _matvec_2site_combined_impl(LHeff, RHeff, theta):
    """``LHeff theta RHeff`` for theta with legs ``((vL.p0), (p1.vR))``."""
    x = npc.tensordot(LHeff, theta, axes=[['(vR.p0*)'], ['(vL.p0)']])
    x = npc.tensordot(x, RHeff, axes=[['wR', '(p1.vR)'], ['wL', '(p1*.vL)']])
    x.ireplace_labels(['(vR*.p0)', '(p1.vL*)'], ['(vL.p0)', '(p1.vR)'])
    return x


def _matvec_1site_plain_impl(LP, RP, W0, theta):
    """theta with legs ``(vL, p0, vR)``."""
    x = npc.tensordot(LP, theta, axes=[['vR'], ['vL']])
    x = npc.tensordot(x, W0, axes=[['wR', 'p0'], ['wL', 'p0*']])
    x = npc.tensordot(x, RP, axes=[['wR', 'vR'], ['wL', 'vL']])
    x.ireplace_labels(['vR*', 'vL*'], ['vL', 'vR'])
    return x.itranspose(['vL', 'p0', 'vR'])


def _matvec_0site_impl(LP, RP, theta):
    """theta with legs ``(vL, vR)``."""
    x = npc.tensordot(LP, theta, axes=[['vR'], ['vL']])
    x = npc.tensordot(x, RP, axes=[['wR', 'vR'], ['wL', 'vL']])
    x.ireplace_labels(['vR*', 'vL*'], ['vL', 'vR'])
    return x.itranspose(['vL', 'vR'])


def _matvec_2site_packed(LPp, RPp, W0p, W1p, v):
    """Two-site effective-H matvec on packed arrays; theta legs
    ``(vL, p0, p1, vR)``."""
    x = pk.tensordot(LPp, v, axes=(['vR'], ['vL']))
    x = pk.tensordot(x, W0p, axes=(['wR', 'p0'], ['wL', 'p0*']))
    x = pk.tensordot(x, W1p, axes=(['wR', 'p1'], ['wL', 'p1*']))
    x = pk.tensordot(x, RPp, axes=(['wR', 'vR'], ['wL', 'vL']))
    x = x.replace_labels(['vR*', 'vL*'], ['vL', 'vR'])
    return x.transpose(['vL', 'p0', 'p1', 'vR'])


def _tridiag_ground(alphas, betas, diag_live, off_live):
    """Lowest eigenpair of the K x K tridiagonal matrix on the host.

    Dead diagonal slots are shifted just above the spectrum by a Gershgorin
    bound, so the lowest eigenvalue comes from the live block."""
    big = np.max(np.abs(alphas)) + 2. * np.max(np.abs(betas)) + 1.
    diag = np.where(diag_live, alphas, big)
    off = np.where(off_live, betas[:-1], 0.)
    T = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
    evals, evecs = np.linalg.eigh(T)
    return float(evals[0]), evecs[:, 0]


def _matvec_1site_packed(LPp, RPp, W0p, v):
    """One-site effective-H matvec on packed arrays; theta legs ``(vL, p0,
    vR)``: three packed tensordots."""
    x = pk.tensordot(LPp, v, axes=(['vR'], ['vL']))
    x = pk.tensordot(x, W0p, axes=(['wR', 'p0'], ['wL', 'p0*']))
    x = pk.tensordot(x, RPp, axes=(['wR', 'vR'], ['wL', 'vL']))
    x = x.replace_labels(['vR*', 'vL*'], ['vL', 'vR'])
    return x.transpose(['vL', 'p0', 'vR'])


def _matvec_0site_packed(LPp, RPp, v):
    """Zero-site effective-H matvec on packed arrays; the bond matrix has
    legs ``(vL, vR)``: two packed tensordots."""
    x = pk.tensordot(LPp, v, axes=(['vR'], ['vL']))
    x = pk.tensordot(x, RPp, axes=(['wR', 'vR'], ['wL', 'vL']))
    x = x.replace_labels(['vR*', 'vL*'], ['vL', 'vR'])
    return x.transpose(['vL', 'vR'])


def _combine(vs, c):
    """``sum_j c[j] vs[j]`` for a list of packed vectors and real or
    complex coefficients ``c`` (complex ones make the sum complex)."""
    c = np.asarray(c)
    dtype = vs[0].dtype
    if np.iscomplexobj(c):
        dtype = torch.promote_types(dtype, torch.complex128)
    out = [torch.zeros_like(d, dtype=dtype) for d in vs[0].data]
    for cj, v in zip(c, vs):
        a = complex(cj) if dtype.is_complex else float(cj)
        for o, d in zip(out, v.data):
            o.add_(d.to(dtype), alpha=a)
    return vs[0]._like(out)


class PackedVectorOps:
    """The vector operations of
    :func:`~tenpy_tpu_torch.linalg.krylov_based.lanczos_evolve` on packed
    arrays: ``norm`` and ``inner_re`` stay on the device, ``read`` brings
    a step's ``(alpha, beta)`` to the host in one copy."""
    norm = staticmethod(pk.norm)
    inner_re = staticmethod(pk.inner_re)
    combine = staticmethod(_combine)

    @staticmethod
    def axpy(a, x, y):
        return y + x * a

    @staticmethod
    def scale(v, a):
        return v * a

    @staticmethod
    def read(*xs):
        return [float(x) for x in torch.stack(xs).cpu()]


def lanczos_evolve_packed(matvec, theta0, delta, N_min=2, N_max=20,
                          P_tol=1e-14, cutoff=1e-12, E_shift=None,
                          normalize=None):
    """``exp(delta (H + E_shift)) theta0`` in the Krylov space of ``H``, on
    packed vectors: the loop of
    :meth:`~tenpy_tpu_torch.linalg.krylov_based.LanczosEvolution.run`
    (:func:`~tenpy_tpu_torch.linalg.krylov_based.lanczos_evolve`: the same
    steps, stopping rule, ``E_shift`` and ``normalize``), each ``matvec`` a
    few packed tensordots (one kernel launch each on a CUDA device), one
    host sync per Krylov step.  Returns ``(theta, N)``, ``N`` the Krylov
    steps (matvecs) taken.
    """
    return lanczos_evolve(matvec, theta0, delta, PackedVectorOps, N_min,
                          N_max, P_tol, cutoff, E_shift, normalize)


def _lanczos_K_2site_packed_impl(LPp, RPp, W0p, W1p, theta0, K,
                                 P_tol=0., N_min=2, reortho=False,
                                 matvec_mode=None, exact_E=False,
                                 ortho=None):
    """Lanczos + Ritz ground state of the two-site effective H, packed:
    :func:`lanczos_ground_packed` with :func:`_matvec_2site_packed`."""
    return lanczos_ground_packed(_matvec_2site_packed,
                                 (LPp, RPp, W0p, W1p), theta0, K, P_tol,
                                 N_min, reortho, matvec_mode, exact_E,
                                 ortho)


def use_device_lanczos(lanczos_params, device, N):
    """Whether an eigensolve of an effective H of size ``N`` runs as the
    packed Lanczos on ``device``: ``lanczos_params['device_K']`` 0
    disables, > 0 forces; otherwise never on the CPU, and from
    ``DEVICE_LANCZOS_THRESHOLD`` up (the card's crossover with the first
    call's packing and plan builds included, so new structures do not
    change the choice)."""
    device_K = lanczos_params.silent_get('device_K', None)
    if device_K == 0:
        return False
    if device_K is not None:
        return True
    if device.type == 'cpu':
        return False
    return N >= DEVICE_LANCZOS_THRESHOLD


def project_out_packed(v, ortho):
    """``v`` with each packed vector ``o`` of ``ortho`` projected out in
    turn, ``v - o <o|v>``, as the host's
    :class:`~tenpy_tpu_torch.linalg.sparse.OrthogonalNpcLinearOperator`
    does; the coefficients stay on the device."""
    for o in ortho:
        v = v - o * pk.vdot(o, v)
    return v


def lanczos_ground_packed(matvec_packed, operands, theta0, K, P_tol=0.,
                          N_min=2, reortho=False, matvec_mode=None,
                          exact_E=False, ortho=None):
    """Lanczos + Ritz ground state of a packed effective H, whose matvec is
    ``matvec_packed(*operands, v)`` (:func:`_matvec_2site_packed`,
    :func:`_matvec_1site_packed` or :func:`_matvec_0site_packed`; VUMPS's
    eigensolves take an effective H's ``packed_matvec`` and
    :meth:`EffectiveH.pack_operands`).

    With ``P_tol > 0`` (or ``reortho``) the loop takes up to ``K`` steps and
    exits once the ground Ritz value is converged
    (``|E_i - E_{i-1}| <= P_tol |E_i|`` after at least ``N_min`` steps) or
    the Krylov space is exhausted; otherwise it takes exactly ``K`` steps
    and solves the tridiagonal problem once.  ``reortho`` orthogonalizes
    every new vector against the stored basis.  ``matvec_mode='f32'`` runs
    the matvecs' GEMMs in float32 while the scalar algebra stays f64; with
    ``exact_E`` the returned E0 is then the f64 Rayleigh quotient of the
    Ritz vector (one extra f64 matvec).

    ``ortho``: packed vectors in the layout of ``theta0`` (states of
    ``orthogonal_to``, packed by :func:`pack_ortho`): every matvec is
    then ``P H P v`` with ``P`` the projection of
    :func:`project_out_packed`, the recursion of the host's
    ``LanczosGroundState`` with ``orthogonal_to`` (the guess is not
    projected, as there).

    Returns ``(E0, theta_gs, N_used, resid)``: floats ``E0`` and ``resid``
    (the residual bound ``|beta_N <e_N, gs>|``), the normalized packed Ritz
    vector and the iteration count as an int.

    The Krylov vectors take the result type of the operands (float64, or
    complex128 when any of them is complex; a float32 guess is promoted),
    as in ``tenpy_tpu``.  ``reortho`` with complex vectors raises, as
    there.
    """
    ortho = list(ortho or ())
    dtype = torch.float64
    for x in (*operands, theta0, *ortho):
        dtype = torch.promote_types(dtype, x.dtype)
    if theta0.dtype != dtype:
        theta0 = theta0._like([d.to(dtype) for d in theta0.data])
    ortho = [o if o.dtype == dtype else o._like([d.to(dtype) for d in o.data])
             for o in ortho]
    if reortho and dtype.is_complex:
        raise NotImplementedError("reortho with complex Krylov vectors "
                                  "(complex Gram-Schmidt coefficients) is "
                                  "not ported; run without reortho")
    v0 = theta0 * (1. / pk.norm(theta0))

    def matvec(v, mode=matvec_mode):
        if ortho:
            v = project_out_packed(v, ortho)
        with pk.matmul_mode(mode):
            hw = matvec_packed(*operands, v)
        return project_out_packed(hw, ortho) if ortho else hw

    def final_E(E_T, theta_gs):
        if not (exact_E and matvec_mode is not None):
            return E_T
        hw = matvec(theta_gs, None)
        return float(pk.inner_re(theta_gs, hw))

    def normalized(v):
        return v * (1. / pk.norm(v))

    # Krylov noise floor: once beta drops to the matvec's GEMM noise the next
    # basis vector is pure noise; stop there (scaled by |alpha| + beta_prev)
    mv_eps = 2e-7 if matvec_mode == 'f32' else 0.

    if not (P_tol and P_tol > 0) and not reortho:
        # fixed-K path: no host sync inside the loop
        v_prev, v = v0 * 0., v0
        beta_prev = torch.zeros((), dtype=torch.float64, device=v0.device)
        vs, alphas, betas = [], [], []
        for _ in range(K):
            hw = matvec(v)
            alpha = pk.inner_re(v, hw)
            hw = hw - v * alpha
            hw = hw - v_prev * beta_prev
            beta = pk.norm(hw)
            floor = torch.clamp(30. * mv_eps * (alpha.abs() + beta_prev),
                                min=1e-14)
            ok = beta > floor
            inv = torch.where(ok, 1. / torch.where(ok, beta, 1.), 0.)
            vs.append(v)
            alphas.append(alpha)
            betas.append(beta)
            v_prev, v = v, hw * inv
            beta_prev = torch.where(ok, beta, 0.)
        alphas = torch.stack(alphas).cpu().numpy()
        betas = torch.stack(betas).cpu().numpy()
        # slots after an early Krylov breakdown are dead (zero vectors)
        live = np.concatenate([[True], np.cumprod(betas[:-1] > 0) > 0])
        E0, c = _tridiag_ground(alphas, betas, live, np.ones(K - 1, bool))
        theta_gs = normalized(_combine(vs, c))
        return final_E(E0, theta_gs), theta_gs, K, abs(betas[-1] * c[-1])

    vs = []
    alphas = np.zeros(K)
    betas = np.zeros(K)
    v_prev, v, beta_prev = v0 * 0., v0, 0.
    E_prev = np.inf
    i = 0
    while i < K:
        vs.append(v)
        hw = matvec(v)
        alpha_t = pk.inner_re(v, hw)
        hw = hw - v * alpha_t
        hw = hw - v_prev * beta_prev
        if reortho:
            cs = torch.stack([pk.inner_re(u, hw) for u in vs]).cpu().numpy()
            hw = hw - _combine(vs, cs)
        beta_t = pk.norm(hw)
        alpha, beta = (float(x) for x in torch.stack([alpha_t, beta_t]).cpu())
        ok = beta > max(1e-14, 30. * mv_eps * (abs(alpha) + beta_prev))
        alphas[i] = alpha
        betas[i] = beta if ok else 0.
        v_prev, v = v, (hw * (1. / beta) if ok else hw * 0.)
        beta_prev = betas[i]
        n = i + 1
        E, _ = _tridiag_ground(alphas, betas, np.arange(K) < n,
                               np.arange(K - 1) < n - 1)
        conv = P_tol > 0 and n >= N_min and abs(E - E_prev) <= P_tol * abs(E)
        E_prev = E
        i = n
        if conv or not ok:
            break
    E0, c = _tridiag_ground(alphas, betas, np.arange(K) < i,
                            np.arange(K - 1) < i - 1)
    resid = abs(betas[max(i - 1, 0)] * c[max(i - 1, 0)])
    theta_gs = normalized(_combine(vs, c[:len(vs)]))
    return final_E(E0, theta_gs), theta_gs, i, resid


def lanczos_K_2site_packed(LPp, RPp, W0p, W1p, theta0, K, P_tol=0.,
                           N_min=2, reortho=False, matvec_mode=None,
                           exact_E=False, ortho=None):
    """The packed two-site Lanczos: :func:`_lanczos_K_2site_packed_impl`
    (``tenpy_tpu`` compiles it once per ``K`` and options; here it is a
    plain call)."""
    return _lanczos_K_2site_packed_impl(LPp, RPp, W0p, W1p, theta0, K,
                                        P_tol, N_min, reortho, matvec_mode,
                                        exact_E, ortho)


def pack_ortho(vecs, like, device):
    """The vectors of an orthogonalized effective H
    (:class:`~tenpy_tpu_torch.linalg.sparse.OrthogonalNpcLinearOperator`'s
    ``ortho_vecs``) packed for :func:`lanczos_ground_packed`: each by
    :func:`pack_virtual`, which gives the layout of the packed guess
    ``like`` to a vector with its legs and charge; a vector of another
    charge sector is orthogonal to every vector of the solve and is
    skipped, as the host's projection skips it.  Any other layout
    raises."""
    out = []
    for o in vecs:
        if not np.array_equal(np.asarray(o.qtotal).ravel(),
                              np.asarray(like.qtotal).ravel()):
            continue
        if list(o.get_leg_labels()) != like.get_leg_labels():
            o = o.copy(deep=False).itranspose(like.get_leg_labels())
        op = pack_virtual(o, device)
        if not op._same_struct(like):
            raise ValueError("a state of orthogonal_to does not pack into "
                             "the layout of the update's theta")
        out.append(op)
    return out


# ================================================== effective Hamiltonians
class EffectiveH(NpcLinearOperator):
    """Base of the effective Hamiltonians of a few sites between their
    environments: ``length`` sites, vectors with legs ``acts_on``.

    ``packed_matvec(*operands, v)`` is the matvec on packed arrays, whose
    operands :meth:`pack_operands` packs onto a device once per effective
    H (the plain one, without ``combine``)."""

    length = None
    acts_on = None
    packed_matvec = None

    def __init__(self, env, i0, combine=False, move_right=True):
        raise NotImplementedError

    def combine_theta(self, theta):
        return theta

    def to_matrix(self):
        raise NotImplementedError

    def _operands(self):
        """``(LP, RP)`` and the W tensors, in the order of
        ``packed_matvec``."""
        raise NotImplementedError

    def pack_operands(self, device):
        """The operands of :attr:`packed_matvec` on ``device``: LP and RP
        padded to ``BUCKET_MULTIPLE`` (:func:`pack_virtual`), each W as it
        is (:func:`pack_W`); packed at the first call, then kept."""
        if getattr(self, '_device_packed', None) is None:
            self._device_packed = tuple(
                pack_virtual(x, device) if k < 2 else pack_W(x, device)
                for k, x in enumerate(self._operands()))
        return self._device_packed


class TwoSiteH(EffectiveH):
    r"""Two-site effective Hamiltonian ``LP -- W0 -- W1 -- RP``.

    With ``combine=True``, ``LHeff = LP W0`` and ``RHeff = W1 RP`` are
    contracted once with their legs combined, so each matvec is two
    contractions of pipe legs.  ``N`` is the dimension of the vectors.
    """

    length = 2
    acts_on = ['vL', 'p0', 'p1', 'vR']
    packed_matvec = staticmethod(_matvec_2site_packed)

    def __init__(self, env, i0, combine=False, move_right=True):
        self.i0 = i0
        self.combine = combine
        self.LP = env.get_LP(i0)
        self.RP = env.get_RP(i0 + 1)
        self.W0 = env.H.get_W(i0).replace_labels(['p', 'p*'], ['p0', 'p0*'])
        self.W1 = env.H.get_W(i0 + 1).replace_labels(['p', 'p*'],
                                                    ['p1', 'p1*'])
        self.dtype = npc.result_type(self.LP.dtype, self.RP.dtype,
                                     self.W0.dtype, self.W1.dtype)
        self.N = (self.LP.get_leg('vR').ind_len
                  * self.W0.get_leg('p0').ind_len
                  * self.W1.get_leg('p1').ind_len
                  * self.RP.get_leg('vL').ind_len)
        if combine:
            self.combine_Heff(env)

    def _operands(self):
        return self.LP, self.RP, self.W0, self.W1

    def combine_Heff(self, env):
        """Contract ``LHeff`` / ``RHeff`` with combined pipe legs."""
        LHeff = npc.tensordot(self.LP, self.W0, axes=[['wR'], ['wL']])
        LHeff = LHeff.combine_legs([['vR*', 'p0'], ['vR', 'p0*']],
                                   qconj=[+1, -1])
        self.LHeff = LHeff.itranspose(['(vR*.p0)', 'wR', '(vR.p0*)'])
        RHeff = npc.tensordot(self.W1, self.RP, axes=[['wR'], ['wL']])
        RHeff = RHeff.combine_legs([['p1', 'vL*'], ['p1*', 'vL']],
                                   qconj=[-1, +1])
        self.RHeff = RHeff.itranspose(['(p1*.vL)', 'wL', '(p1.vL*)'])
        self.acts_on = ['(vL.p0)', '(p1.vR)']
        self.pipeL = self.LHeff.get_leg('(vR*.p0)')
        self.pipeR = self.RHeff.get_leg('(p1.vL*)')

    def matvec(self, theta):
        if self.combine:
            return _matvec_2site_combined_impl(self.LHeff, self.RHeff, theta)
        return _matvec_2site_plain_impl(self.LP, self.RP, self.W0, self.W1,
                                        theta)

    def combine_theta(self, theta):
        """theta with its legs combined as the matvec takes them."""
        if self.combine:
            theta = theta.combine_legs([['vL', 'p0'], ['p1', 'vR']],
                                       pipes=[self.pipeL, self.pipeR])
        return theta.itranspose(self.acts_on)

    def to_matrix(self):
        if self.combine:
            mat = npc.tensordot(self.LHeff, self.RHeff, axes=[['wR'], ['wL']])
            return mat.combine_legs([['(vR*.p0)', '(p1.vL*)'],
                                     ['(vR.p0*)', '(p1*.vL)']],
                                    qconj=[+1, -1])
        mat = npc.tensordot(self.LP, self.W0, axes=[['wR'], ['wL']])
        mat = npc.tensordot(mat, self.W1, axes=[['wR'], ['wL']])
        mat = npc.tensordot(mat, self.RP, axes=[['wR'], ['wL']])
        return mat.combine_legs([['vR*', 'p0', 'p1', 'vL*'],
                                 ['vR', 'p0*', 'p1*', 'vL']], qconj=[+1, -1])

    def update_LP(self, env, i, U=None):
        """Set ``env``'s LP[i] (from ``LHeff`` and ``U`` if combined)."""
        if self.combine and U is not None:
            LP = npc.tensordot(self.LHeff, U, axes=[['(vR.p0*)'],
                                                    ['(vL.p0)']])
            LP = npc.tensordot(U.conj(), LP, axes=[['(vL*.p0*)'],
                                                   ['(vR*.p0)']])
            LP.iset_leg_labels(['vR*', 'wR', 'vR'])
            env.set_LP(i, LP, age=env.get_LP_age(i - 1) + 1)
        else:
            # from LP[i-1] (the slot itself may hold stale data)
            LP = env._contract_LP(i - 1, env.get_LP(i - 1, store=False))
            env.set_LP(i, LP, age=env.get_LP_age(i - 1) + 1)

    def update_RP(self, env, i, VH=None):
        if self.combine and VH is not None:
            RP = npc.tensordot(VH, self.RHeff, axes=[['(p1.vR)'],
                                                     ['(p1*.vL)']])
            RP = npc.tensordot(RP, VH.conj(), axes=[['(p1.vL*)'],
                                                    ['(p1*.vR*)']])
            RP.iset_leg_labels(['vL', 'wL', 'vL*'])
            RP.itranspose(['vL*', 'wL', 'vL'])
            env.set_RP(i, RP, age=env.get_RP_age(i + 1) + 1)
        else:
            RP = env._contract_RP(i + 1, env.get_RP(i + 1, store=False))
            env.set_RP(i, RP, age=env.get_RP_age(i + 1) + 1)


class OneSiteH(EffectiveH):
    """One-site effective Hamiltonian ``LP -- W0 -- RP``."""

    length = 1
    acts_on = ['vL', 'p0', 'vR']
    packed_matvec = staticmethod(_matvec_1site_packed)

    def __init__(self, env, i0, combine=False, move_right=True):
        self.i0 = i0
        self.combine = combine
        self.move_right = move_right
        self.LP = env.get_LP(i0)
        self.RP = env.get_RP(i0)
        self.W0 = env.H.get_W(i0).replace_labels(['p', 'p*'], ['p0', 'p0*'])
        self.dtype = npc.result_type(self.LP.dtype, self.RP.dtype,
                                     self.W0.dtype)
        self.N = (self.LP.get_leg('vR').ind_len
                  * self.W0.get_leg('p0').ind_len
                  * self.RP.get_leg('vL').ind_len)
        if combine:
            self.combine_Heff(env)

    def _operands(self):
        return self.LP, self.RP, self.W0

    def combine_Heff(self, env):
        if self.move_right:
            LHeff = npc.tensordot(self.LP, self.W0, axes=[['wR'], ['wL']])
            LHeff = LHeff.combine_legs([['vR*', 'p0'], ['vR', 'p0*']],
                                       qconj=[+1, -1])
            self.LHeff = LHeff.itranspose(['(vR*.p0)', 'wR', '(vR.p0*)'])
            self.pipeL = self.LHeff.get_leg('(vR*.p0)')
            self.acts_on = ['(vL.p0)', 'vR']
        else:
            RHeff = npc.tensordot(self.W0, self.RP, axes=[['wR'], ['wL']])
            RHeff = RHeff.combine_legs([['p0', 'vL*'], ['p0*', 'vL']],
                                       qconj=[-1, +1])
            self.RHeff = RHeff.itranspose(['(p0*.vL)', 'wL', '(p0.vL*)'])
            self.pipeR = self.RHeff.get_leg('(p0.vL*)')
            self.acts_on = ['vL', '(p0.vR)']

    def matvec(self, theta):
        if not self.combine:
            return _matvec_1site_plain_impl(self.LP, self.RP, self.W0, theta)
        if self.move_right:
            x = npc.tensordot(self.LHeff, theta, axes=[['(vR.p0*)'],
                                                       ['(vL.p0)']])
            x = npc.tensordot(x, self.RP, axes=[['wR', 'vR'], ['wL', 'vL']])
            x.ireplace_labels(['(vR*.p0)', 'vL*'], ['(vL.p0)', 'vR'])
            return x.itranspose(['(vL.p0)', 'vR'])
        x = npc.tensordot(theta, self.RHeff, axes=[['(p0.vR)'], ['(p0*.vL)']])
        x = npc.tensordot(self.LP, x, axes=[['wR', 'vR'], ['wL', 'vL']])
        x.ireplace_labels(['vR*', '(p0.vL*)'], ['vL', '(p0.vR)'])
        return x.itranspose(['vL', '(p0.vR)'])

    def combine_theta(self, theta):
        if self.combine:
            if self.move_right:
                theta = theta.combine_legs([['vL', 'p0']], pipes=[self.pipeL])
            else:
                theta = theta.combine_legs([['p0', 'vR']], pipes=[self.pipeR])
        return theta.itranspose(self.acts_on)

    def to_matrix(self):
        mat = npc.tensordot(self.LP, self.W0, axes=[['wR'], ['wL']])
        mat = npc.tensordot(mat, self.RP, axes=[['wR'], ['wL']])
        return mat.combine_legs([['vR*', 'p0', 'vL*'], ['vR', 'p0*', 'vL']],
                                qconj=[+1, -1])

    def update_LP(self, env, i, U=None):
        LP = env._contract_LP(i - 1, env.get_LP(i - 1, store=False))
        env.set_LP(i, LP, age=env.get_LP_age(i - 1) + 1)

    def update_RP(self, env, i, VH=None):
        RP = env._contract_RP(i + 1, env.get_RP(i + 1, store=False))
        env.set_RP(i, RP, age=env.get_RP_age(i + 1) + 1)


class ZeroSiteH(EffectiveH):
    """Zero-site effective Hamiltonian ``LP -- RP`` on bond ``i0``."""

    length = 0
    acts_on = ['vL', 'vR']
    packed_matvec = staticmethod(_matvec_0site_packed)

    def __init__(self, env, i0):
        self.i0 = i0
        self.LP = env.get_LP(i0)
        self.RP = env.get_RP(i0 - 1)
        self.dtype = npc.result_type(self.LP.dtype, self.RP.dtype)
        self.N = self.LP.get_leg('vR').ind_len * self.RP.get_leg('vL').ind_len

    @classmethod
    def from_LP_RP(cls, LP, RP, i0=0):
        """The zero-site H between a given ``LP`` and ``RP`` (no
        environment)."""
        self = cls.__new__(cls)
        self.i0 = i0
        self.LP = LP
        self.RP = RP
        self.dtype = npc.result_type(LP.dtype, RP.dtype)
        self.N = LP.get_leg('vR').ind_len * RP.get_leg('vL').ind_len
        return self

    def _operands(self):
        return self.LP, self.RP

    def matvec(self, theta):
        return _matvec_0site_impl(self.LP, self.RP, theta)

    def to_matrix(self):
        mat = npc.tensordot(self.LP, self.RP, axes=[['wR'], ['wL']])
        return mat.combine_legs([['vR*', 'vL*'], ['vR', 'vL']],
                                qconj=[+1, -1])


# ================================================================== mixers
class Mixer:
    """Base of the mixers, which perturb the split of a local update to let
    it reach charge sectors the state lacks.

    Options: ``amplitude`` (1e-5), ``decay`` (2.: the amplitude is divided
    by it per sweep), ``disable_after`` (15 sweeps).
    """

    can_decompose_theta = False
    update_sites = 2

    def __init__(self, options, sweep_activated=0):
        self.options = options = asConfig(options, 'Mixer')
        self.amplitude = options.get('amplitude', 1e-5, 'real')
        self.decay = options.get('decay', 2., 'real')
        self.disable_after = options.get('disable_after', 15, int)
        self.sweep_activated = sweep_activated
        self.current_amplitude = self.amplitude

    def update_amplitude(self, sweeps):
        """Lower the amplitude; None once the mixer is to be disabled."""
        amp = self.amplitude / self.decay ** max(0, sweeps
                                                 - self.sweep_activated)
        if self.disable_after is not None and \
                sweeps >= self.sweep_activated + self.disable_after:
            return None
        self.current_amplitude = amp
        return self

    def perturb_svd(self, engine, theta, i0, update_LP, update_RP):
        raise NotImplementedError


class DensityMatrixMixer(Mixer):
    r"""Perturb the two-site reduced density matrices by the environment's
    channels: ``rho_L = tr_R |theta><theta| + a sum_w (LP W0 theta)
    (LP W0 theta)^dagger`` (and mirrored for ``rho_R``), then truncate each
    by its eigendecomposition."""

    def perturb_svd(self, engine, theta, i0, update_LP, update_RP):
        """``(U, S, VH, err, S_approx)`` as a truncated SVD of theta; ``S``
        is the bond matrix ``U^dagger theta VH^dagger``."""
        amp = self.current_amplitude
        env = engine.env
        theta_s = theta.split_legs() if theta.rank == 2 else theta
        rho_L = npc.tensordot(theta_s, theta_s.conj(),
                              axes=[['p1', 'vR'], ['p1*', 'vR*']])
        rho_L = rho_L.combine_legs([['vL', 'p0'], ['vL*', 'p0*']],
                                   qconj=[+1, -1])
        rho_R = npc.tensordot(theta_s, theta_s.conj(),
                              axes=[['vL', 'p0'], ['vL*', 'p0*']])
        rho_R = rho_R.combine_legs([['p1', 'vR'], ['p1*', 'vR*']],
                                   qconj=[-1, +1])
        if update_LP:
            LP = env.get_LP(i0)
            W0 = env.H.get_W(i0).replace_labels(['p', 'p*'], ['p0', 'p0*'])
            mixL = npc.tensordot(LP, theta_s, axes=[['vR'], ['vL']])
            mixL = npc.tensordot(mixL, W0, axes=[['wR', 'p0'],
                                                 ['wL', 'p0*']])
            add = npc.tensordot(mixL, mixL.conj(),
                                axes=[['p1', 'vR', 'wR'],
                                      ['p1*', 'vR*', 'wR*']])
            add.iset_leg_labels(['vL', 'p0', 'vL*', 'p0*'])
            add = add.combine_legs([['vL', 'p0'], ['vL*', 'p0*']],
                                   qconj=[+1, -1])
            rho_L = rho_L + amp * add
        if update_RP:
            RP = env.get_RP(i0 + 1)
            W1 = env.H.get_W(i0 + 1).replace_labels(['p', 'p*'],
                                                    ['p1', 'p1*'])
            mixR = npc.tensordot(theta_s, RP, axes=[['vR'], ['vL']])
            mixR = npc.tensordot(mixR, W1, axes=[['wL', 'p1'],
                                                 ['wR', 'p1*']])
            add = npc.tensordot(mixR, mixR.conj(),
                                axes=[['vL', 'p0', 'wL'],
                                      ['vL*', 'p0*', 'wL*']])
            add.iset_leg_labels(['vL', 'p1', 'vL*', 'p1*'])
            add.ireplace_labels(['vL', 'vL*'], ['vR', 'vR*'])
            add = add.combine_legs([['p1', 'vR'], ['p1*', 'vR*']],
                                   qconj=[-1, +1])
            rho_R = rho_R + amp * add
        # U: legs ('(vL.p0)', inner 'vR'); V: ('(p1.vR)', inner 'vL')
        trunc_par = engine.trunc_params
        W_L, U, errL, _ = eigh_rho(rho_L, trunc_par, sort='m>')
        W_R, V, errR, _ = eigh_rho(rho_R, trunc_par, sort='m>')
        U.iset_leg_labels(['(vL.p0)', 'vR'])
        V.iset_leg_labels(['(p1.vR)', 'vL'])
        # charges as svd_theta: U carries the old A tensor's, VH the rest
        chinfo = theta.chinfo
        qtotal_L = engine.psi.get_B(i0, None).qtotal
        U = U.gauge_total_charge('vR', chinfo.make_valid(qtotal_L))
        VH = V.transpose(['vL', '(p1.vR)'])
        VH = VH.gauge_total_charge('vL', chinfo.make_valid(
            chinfo.make_valid(theta.qtotal) - qtotal_L))
        theta_c = theta if theta.rank == 2 else \
            theta_s.combine_legs([['vL', 'p0'], ['p1', 'vR']],
                                 qconj=[+1, -1])
        # theta in the mixed bases is a non-diagonal bond matrix; keeping it
        # (not re-SVDing) keeps the sectors the mixer added
        S_mat = npc.tensordot(U.conj(), theta_c,
                              axes=[['(vL*.p0*)'], ['(vL.p0)']])
        S_mat = npc.tensordot(S_mat, VH.conj(), axes=[['(p1.vR)'],
                                                      ['(p1*.vR*)']])
        S_mat.ireplace_labels(['vR*', 'vL*'], ['vL', 'vR'])
        S_mat = S_mat / npc.norm(S_mat)
        S_approx = np.sqrt(np.maximum(np.asarray(W_L), 0.))
        nrm = np.linalg.norm(S_approx)
        if nrm > 0:
            S_approx = S_approx / nrm
        err = TruncationError(errL.eps + errR.eps,
                              (1 - errL.eps) * (1 - errR.eps))
        return U, S_mat, VH, err, S_approx


def _isometry_with_complement(M, side='left'):
    """The full left basis of a 2-leg ``M`` (K x n, norm 1):
    ``(U_full, S_padded, C)`` with ``U_full`` a K x K unitary, block
    diagonal by charge sector, whose first columns are M's left singular
    vectors; ``S_padded`` M's singular values padded with exact zeros; and
    ``C = U_full^dagger M``.  ``side='right'`` mirrors it (``C = M
    V_full``)."""
    if side == 'right':
        V_full, S_pad, Ct = _isometry_with_complement(M.transpose([1, 0]),
                                                      'left')
        C = Ct.transpose([1, 0])
        C.iset_leg_labels(['vL', 'vR'])
        return V_full, S_pad, C
    leg = M.legs[0]
    chinfo = M.chinfo
    by_row = {}
    for bi, row in enumerate(M._qdata):
        by_row.setdefault(int(row[0]), []).append(bi)
    rows_u, blocks_u, s_parts, charges, sizes = [], [], [], [], []
    for qi in range(leg.block_number):
        m = int(leg.slices[qi + 1] - leg.slices[qi])
        q_row = chinfo.make_valid(leg.charges[qi] * leg.qconj)
        s_full = np.zeros(m)
        if qi in by_row:
            sub = np.concatenate([M._data[bi].numpy() for bi in by_row[qi]],
                                 axis=1)
            u, s, _ = np.linalg.svd(sub, full_matrices=True)
            s_full[:min(sub.shape)] = s
        else:
            u = np.eye(m)
        rows_u.append((qi, len(charges)))
        blocks_u.append(torch.from_numpy(np.ascontiguousarray(u)))
        s_parts.append(s_full)
        charges.append(q_row)       # the inner leg: qconj -1, charge q_row
        sizes.append(m)
    leg_inner = LegCharge(chinfo, np.concatenate([[0], np.cumsum(sizes)]),
                          np.array(charges, QTYPE).reshape(len(charges),
                                                           chinfo.qnumber),
                          -1)
    U_full = npc.Array([leg, leg_inner], M.dtype, None, [None, None])
    U_full._set_blocks(np.array(rows_u, QTYPE).reshape(len(rows_u), 2),
                       [b.to(M.dtype) for b in blocks_u])
    S_pad = np.concatenate(s_parts) if s_parts else np.zeros(0)
    C = npc.tensordot(U_full.conj(), M, axes=[[0], [0]])
    C.iset_leg_labels(['vL', 'vR'])
    return U_full, S_pad, C


class SubspaceExpansion(Mixer):
    """The single-site mixer: expand the kept space by the environment's
    channels ``LP W0 theta`` (moving right) or ``theta W0 RP`` (left)."""

    can_decompose_theta = True
    update_sites = 1

    @staticmethod
    def _trunc(engine):
        return engine.trunc_params

    def perturb_svd(self, engine, theta, i0, move_right, next_B):
        """One-site subspace expansion of theta (legs ``vL, p0, vR``).

        The SVD of theta with the ``amp * LP W0`` channels stacked on gives
        the new isometry; the bond matrix is the ORIGINAL theta projected
        onto it, rotated into its singular basis padded with the orthogonal
        complement, so the neighbour's legs stay as they are and the
        expanded directions enter with weight zero.  Returns ``(A, S,
        VH_eff, err)`` moving right, ``(U_eff, S, B, err)`` moving left.
        """
        amp = np.sqrt(self.current_amplitude)
        env = engine.env
        theta = theta.itranspose(['vL', 'p0', 'vR'])
        W0 = env.H.get_W(i0).replace_labels(['p', 'p*'], ['p0', 'p0*'])
        if move_right:
            LP = env.get_LP(i0)
            expand = npc.tensordot(LP, theta, axes=[['vR'], ['vL']])
            expand = npc.tensordot(expand, W0, axes=[['wR', 'p0'],
                                                     ['wL', 'p0*']])
            expand = expand.combine_legs([['wR', 'vR']], qconj=[-1])
            expand.ireplace_labels(['vR*', '(wR.vR)'], ['vL', 'vR'])
            expand = (expand * amp).itranspose(['vL', 'p0', 'vR'])
            theta_ex = npc.concatenate([theta, expand], axis='vR')
            theta_c = theta_ex.combine_legs([['vL', 'p0']], qconj=[+1])
            U, _, _, err, _ = svd_theta(theta_c, self._trunc(engine))
            A = U.split_legs([0])
            M = npc.tensordot(A.conj(), theta, axes=[['vL*', 'p0*'],
                                                     ['vL', 'p0']])
            M.iset_leg_labels(['vL', 'vR'])
            M = M / max(npc.norm(M), 1e-300)
            U_full, S_pad, C = _isometry_with_complement(M, 'left')
            A_f = npc.tensordot(A, U_full, axes=[['vR'], [0]])
            A_f.iset_leg_labels(['vL', 'p0', 'vR'])
            return A_f, S_pad, C, err
        RP = env.get_RP(i0)
        expand = npc.tensordot(theta, RP, axes=[['vR'], ['vL']])
        expand = npc.tensordot(expand, W0, axes=[['wL', 'p0'],
                                                 ['wR', 'p0*']])
        expand = expand.combine_legs([['wL', 'vL']], qconj=[+1])
        expand.ireplace_label('(wL.vL)', 'vL')
        expand.ireplace_label('vL*', 'vR')
        expand = (expand * amp).itranspose(['vL', 'p0', 'vR'])
        theta_ex = npc.concatenate([theta, expand], axis='vL')
        theta_c = theta_ex.combine_legs([['p0', 'vR']], qconj=[-1])
        theta_c.itranspose(['vL', '(p0.vR)'])
        _, _, VH, err, _ = svd_theta(theta_c, self._trunc(engine))
        B = VH.split_legs([1])
        M = npc.tensordot(theta, B.conj(), axes=[['p0', 'vR'],
                                                 ['p0*', 'vR*']])
        M.iset_leg_labels(['vL', 'vR'])
        M = M / max(npc.norm(M), 1e-300)
        V_full, S_pad, C = _isometry_with_complement(M, 'right')
        B_f = npc.tensordot(V_full, B, axes=[[0], ['vL']])
        B_f.iset_leg_labels(['vL', 'p0', 'vR'])
        return C, S_pad, B_f, err

    def mixed_svd_2site(self, engine, theta, i0):
        """The two-site split with the enclosed bond's right basis expanded
        by the ``W(i0+1) RP`` channels; the ORIGINAL theta is then split
        exactly inside the expanded basis, so both tensors are isometries
        and ``S`` holds theta's Schmidt values.  ``theta`` has legs
        ``('(vL.p0)', '(p1.vR)')``; returns ``(U, S, VH, err, S)``."""
        amp = np.sqrt(self.current_amplitude)
        env = engine.env
        th = theta
        if '(vL.p0)' not in th.get_leg_labels():
            th = th.combine_legs([['vL', 'p0'], ['p1', 'vR']],
                                 qconj=[+1, -1])
        th_r = th.split_legs(['(p1.vR)']).itranspose(['(vL.p0)', 'p1', 'vR'])
        RP = env.get_RP(i0 + 1)
        W1 = env.H.get_W(i0 + 1).replace_labels(['p', 'p*'], ['p1', 'p1*'])
        ex = npc.tensordot(th_r, RP, axes=[['vR'], ['vL']])
        ex = npc.tensordot(ex, W1, axes=[['wL', 'p1'], ['wR', 'p1*']])
        ex = ex.combine_legs([['wL', '(vL.p0)']], qconj=[+1])
        ex.ireplace_labels(['(wL.(vL.p0))', 'vL*'], ['(vL.p0)', 'vR'])
        ex = (ex * amp).itranspose(['(vL.p0)', 'p1', 'vR'])
        th_ex = npc.concatenate([th_r, ex], axis='(vL.p0)')
        th_ex = th_ex.combine_legs([['p1', 'vR']], qconj=[-1])
        _, _, VH, err, _ = svd_theta(th_ex, self._trunc(engine),
                                     qtotal_LR=[th_ex.qtotal, None],
                                     inner_labels=['vR', 'vL'])
        M = npc.tensordot(th, VH.conj(), axes=[['(p1.vR)'], ['(p1*.vR*)']])
        M.ireplace_label('vL*', 'vR')
        qtotal_L = engine.psi.get_B(i0, None).qtotal
        U, S, V2 = npc.svd(M, qtotal_LR=[th.chinfo.make_valid(qtotal_L),
                                         None], inner_labels=['vR', 'vL'])
        S = np.asarray(S)
        nrm = np.linalg.norm(S)
        if nrm > 0:
            S = S / nrm
        VH_f = npc.tensordot(V2, VH, axes=[['vR'], ['vL']])
        return U, S, VH_f, err, S


# ================================================================== sweeps
class Sweep(Algorithm):
    """Sweeps left and right with local updates, environment updates and
    effective Hamiltonians.

    Options: ``combine`` (False), ``lanczos_params``, ``trunc_params``,
    ``chi_list`` ({sweep: chi_max}), ``mixer``, ``mixer_params``,
    ``start_env`` (infinite bc: sites contracted into the start
    environments, 1).  ``orthogonal_to``: states to stay orthogonal to
    (excited states).  ``tenpy_tpu``'s ``mixer_env_reseed='tm'`` (off by
    default, used by no test) is not ported: the environments restart
    from trivial boundaries when the mixer is switched off.
    """

    EffectiveH = None
    DefaultMixer = None
    use_mixer_by_default = False

    def __init__(self, psi, model, options, *, orthogonal_to=None, **kwargs):
        if self.EffectiveH is None:
            raise NotImplementedError(
                f"{self.__class__.__name__} needs EffectiveH")
        super().__init__(psi, model, options, **kwargs)
        options = self.options
        self.combine = options.get('combine', False, bool)
        self.finite = self.psi.finite
        self.lanczos_params = options.subconfig('lanczos_params')
        self.mixer = None
        self.env = None
        self.ortho_to_envs = []
        self.init_env(model, resume_data=self.resume_data,
                      orthogonal_to=orthogonal_to)
        self.i0 = 0
        self.move_right = True
        self.update_LP_RP = (True, False)
        self.sweeps = 0
        self.time0 = time.time()
        self.trunc_err_list = []
        self.e_L = self.e_R = None

    @property
    def n_optimize(self):
        return self.EffectiveH.length

    @property
    def S_inv_cutoff(self):
        return 1e-15

    def init_env(self, model=None, resume_data=None, orthogonal_to=None):
        """(Re)build the MPO environment (and those of ``orthogonal_to``)."""
        H = model.H_MPO if model is not None else self.env.H
        if resume_data is None:
            resume_data = {}
        init_env_data = resume_data.get('init_env_data', {})
        if not self.psi.finite:
            start_env = self.options.get('start_env', 1, int)
            init_env_data.setdefault('start_env_sites', start_env)
        cache = self.cache.create_subcache('env')
        self.env = MPOEnvironment(self.psi, H, self.psi, cache=cache,
                                  **init_env_data)
        if orthogonal_to:
            self.ortho_to_envs = [MPSEnvironment(self.psi, ortho)
                                  for ortho in orthogonal_to]
        self.reset_stats()

    def reset_stats(self, resume_data=None):
        self.sweeps = 0
        self.shelve = False
        self.chi_list = self.options.get('chi_list', None)
        if self.chi_list is not None:
            self.chi_list = dict(self.chi_list)

    def sweep(self, optimize=True):
        """One sweep left to right and back; returns the largest truncation
        error."""
        if optimize and self.chi_list is not None:
            new_chi = self.chi_list.get(self.sweeps, None)
            if new_chi is not None:
                self.trunc_params['chi_max'] = new_chi
                logger.info("sweep %d: setting chi_max=%d", self.sweeps,
                            new_chi)
        self.trunc_err_list = []
        for i0, move_right, update_LP_RP in self.get_sweep_schedule():
            self.i0 = i0
            self.move_right = move_right
            self.update_LP_RP = update_LP_RP
            self._cache_optimize()
            theta = self.prepare_update_local()
            update_data = self.update_local(theta, optimize=optimize)
            self.update_env(**update_data)
            self.post_update_local(**update_data)
            self.free_no_longer_needed_envs()
        if optimize:
            self.sweeps += 1
            self.mixer_cleanup_after_sweep()
        return np.max(self.trunc_err_list) if self.trunc_err_list else 0.

    def get_sweep_schedule(self):
        """The ``(i0, move_right, (update_LP, update_RP))`` of a sweep."""
        L = self.psi.L
        n = self.EffectiveH.length
        if self.finite:
            assert L > n - 1
            if n == 0:
                i0s = list(range(1, L)) + list(range(L - 1, 0, -1))
                move_right = [True] * (L - 1) + [False] * (L - 1)
                update_LP_RP = [[True, False]] * (L - 1) + \
                    [[False, True]] * (L - 1)
                return zip(i0s, move_right, update_LP_RP)
            if n == 1:
                i0s = list(range(0, L)) + list(range(L - 1, -1, -1))
                move_right = [True] * L + [False] * L
                update_LP_RP = [[True, False]] * L + [[False, True]] * L
            else:
                i0s = list(range(0, L - n)) + list(range(L - n, 0, -1))
                move_right = [True] * (L - n) + [False] * (L - n)
                update_LP_RP = [[True, False]] * (L - n) + \
                    [[False, True]] * (L - n)
        elif n == 2:
            i0s = list(range(0, L)) + list(range(L, 0, -1))
            move_right = [True] * L + [False] * L
            update_LP_RP = ([[True, True]] * 2 + [[True, False]] * (L - 2)
                            + [[True, True]] * 2 + [[False, True]] * (L - 2))
        elif n == 1:
            i0s = list(range(0, L)) + list(range(L, 0, -1))
            move_right = [True] * L + [False] * L
            update_LP_RP = ([[True, True]] + [[True, False]] * (L - 1)
                            + [[True, True]] + [[False, True]] * (L - 1))
        else:
            raise ValueError("n_optimize not in (1, 2)")
        return zip(i0s, move_right, update_LP_RP)

    def _cache_optimize(self):
        i0 = self.i0
        move_right = self.move_right
        if self.n_optimize == 2:
            kwargs = {'short_term_LP': [i0, i0 + 1],
                      'short_term_RP': [i0, i0 + 1]}
            if move_right:
                kwargs['preload_RP'] = i0 + 2
            elif move_right is False:
                kwargs['preload_LP'] = i0 - 1
        elif move_right:
            kwargs = {'short_term_LP': [i0, i0 + 1], 'short_term_RP': [i0],
                      'preload_RP': i0 + 1}
        elif move_right is None:
            kwargs = {'short_term_LP': [i0], 'short_term_RP': [i0]}
        else:
            kwargs = {'short_term_LP': [i0], 'short_term_RP': [i0 - 1, i0],
                      'preload_LP': i0 - 1}
        self.env.cache_optimize(**kwargs)

    def prepare_update_local(self):
        """Build ``eff_H`` and the current theta, the guess."""
        self.make_eff_H()
        theta = self.psi.get_theta(self.i0, n=self.n_optimize,
                                   cutoff=self.S_inv_cutoff)
        return self.eff_H.combine_theta(theta)

    def make_eff_H(self):
        self.eff_H = self.EffectiveH(self.env, self.i0, self.combine,
                                     self.move_right)
        if getattr(self.env.H, 'explicit_plus_hc', False) and \
                not hasattr(self.eff_H, 'matvec_hc'):
            raise NotImplementedError(
                "H has explicit_plus_hc=True, which no ported engine takes")
        if len(self.ortho_to_envs) > 0:
            self._wrap_ortho_eff_H()

    def _wrap_ortho_eff_H(self):
        """Project the states of ``orthogonal_to`` out of ``eff_H``."""
        ortho_vecs = []
        i0 = self.i0
        n = self.eff_H.length
        for o_env in self.ortho_to_envs:
            theta = o_env.ket.get_theta(i0, n=n)
            LP = o_env.get_LP(i0, store=True)
            RP = o_env.get_RP(i0 + n - 1, store=True)
            theta = npc.tensordot(LP, theta, axes=[['vR'], ['vL']])
            theta = npc.tensordot(theta, RP, axes=[['vR'], ['vL']])
            theta.ireplace_labels(['vR*', 'vL*'], ['vL', 'vR'])
            theta = self.eff_H.combine_theta(theta)
            if float(npc.norm(theta)) < 1e-30:
                continue        # e.g. a state in another charge sector
            ortho_vecs.append(theta)
        if ortho_vecs:
            self.eff_H = OrthogonalNpcLinearOperator(self.eff_H, ortho_vecs)

    def update_local(self, theta, optimize=True):
        raise NotImplementedError

    @property
    def _all_envs(self):
        return [self.env] + self.ortho_to_envs

    def update_env(self, **update_data):
        """Update the environments after the local update.

        Finite bc: every ``LP[j]`` with ``j > i0`` and ``RP[j]`` with
        ``j < i0 + n - 1`` was built from the old tensors and is dropped
        (one more on the far side of the bond for single-site updates and
        mixers).  Infinite bc keeps them: the iDMRG environments age
        towards the fixed point.
        """
        i0 = self.i0
        n = self.n_optimize
        L = self.psi.L
        update_LP, update_RP = self.update_LP_RP
        base_H = self.eff_H
        while not isinstance(base_H, EffectiveH) and \
                hasattr(base_H, 'orig_operator'):
            base_H = base_H.orig_operator
        if self.finite:
            lo_LP = i0 + 1            # del_LP(j) for j >= lo_LP
            hi_RP = i0 + n - 1        # del_RP(j) for j <  hi_RP
            if n == 1 or getattr(self, 'mixer', None) is not None:
                if self.move_right:
                    hi_RP += 1
                else:
                    lo_LP -= 1
            for env in self._all_envs:
                for j in range(max(lo_LP, 1), L):
                    env.del_LP(j)
                for j in range(0, min(hi_RP, L - 1)):
                    env.del_RP(j)
        # finite bc: LP[L] / RP[-1] do not exist (the keys wrap mod L)
        if self.finite and i0 + 1 > L - 1:
            update_LP = False
        if self.finite and i0 + n - 2 < 0:
            update_RP = False
        if update_LP:
            base_H.update_LP(self.env, i0 + 1, update_data.get('U', None))
            for o_env in self.ortho_to_envs:
                o_env.get_LP(i0 + 1, store=True)
        if update_RP:
            base_H.update_RP(self.env, i0 + n - 2, update_data.get('VH', None))
            for o_env in self.ortho_to_envs:
                o_env.get_RP(i0 + n - 2, store=True)

    def post_update_local(self, err=None, **update_data):
        self.trunc_err_list.append(err.eps if err is not None else 0.)

    def free_no_longer_needed_envs(self):
        """Stale environments are dropped in :meth:`update_env`."""
        return

    # ------------------------------------------------------------- mixer
    def mixer_activate(self):
        """Switch the mixer on where the options ask for one."""
        use_mixer = self.options.get('mixer', self.use_mixer_by_default)
        if use_mixer:
            if use_mixer is True:
                MixerCls = self.DefaultMixer
            elif isinstance(use_mixer, str):
                MixerCls = find_subclass(Mixer, use_mixer)
            else:
                MixerCls = use_mixer
            if MixerCls is None:
                return
            mixer_params = self.options.subconfig('mixer_params')
            self.mixer = MixerCls(mixer_params, self.sweeps)

    def mixer_deactivate(self):
        if self.mixer is not None:
            logger.info("disable mixer after %d sweeps", self.sweeps)
        self.mixer = None
        had_matrix = any(isinstance(s, npc.Array) for s in self.psi._S)
        self._absorb_matrix_S()
        if had_matrix and self.env is not None:
            # the absorption rotated bond bases: the environments are stale
            self.env.clear()
            self.env.init_first_LP_last_RP()
            for env in self.ortho_to_envs:
                env.clear()
                env.init_first_LP_last_RP()

    def _absorb_matrix_S(self):
        """SVD every bond matrix the mixer left back to diagonal Schmidt
        values, rotating the neighbours' bond bases (an A-form left
        neighbour by ``U``, a B-form one by ``VH^dagger``; mirrored on the
        right)."""
        psi = self.psi
        for b in range(psi.L + 1 if psi.finite else psi.L):
            S = psi._S[b]
            if not isinstance(S, npc.Array):
                continue
            # drop the numerically zero directions the mixer added
            U, s, VH = npc.svd(S, cutoff=1e-14, inner_labels=['vR', 'vL'])
            s = np.asarray(s)
            nrm = np.linalg.norm(s)
            s_diag = s / (nrm if nrm > 0 else 1.)
            if b == psi.L:
                psi._S[b] = s_diag
            else:
                psi.set_SL(b, s_diag)
            iL = (b - 1) % psi.L
            iR = b % psi.L
            fL = psi.form[iL]
            fR = psi.form[iR]
            if fL is None or fR is None or fL[1] not in (0., 1.) \
                    or fR[0] not in (0., 1.):
                raise ValueError("can't absorb matrix S next to form "
                                 f"{fL}, {fR}")
            TL = psi.get_B(iL, None)
            if fL[1] == 0.:
                TL = npc.tensordot(TL, U, axes=[['vR'], ['vL']])
            else:
                TL = npc.tensordot(TL, VH.conj(), axes=[['vR'], ['vR*']])
                TL.ireplace_label('vL*', 'vR')
            psi.set_B(iL, TL, psi.form[iL])
            TR = psi.get_B(iR, None)
            if fR[0] == 0.:
                TR = npc.tensordot(VH, TR, axes=[['vR'], ['vL']])
            else:
                TR = npc.tensordot(U.conj(), TR, axes=[['vL*'], ['vL']])
                TR.ireplace_label('vR*', 'vL')
            psi.set_B(iR, TR, psi.form[iR])

    def mixer_cleanup_after_sweep(self):
        if self.mixer is not None:
            mixer = self.mixer.update_amplitude(self.sweeps)
            if mixer is None:
                self.mixer_deactivate()
            else:
                self.mixer = mixer

    def mixer_cleanup(self):
        if self.mixer is not None:
            self.mixer_deactivate()

    def get_resume_data(self, sequential_simulations=False):
        data = super().get_resume_data(sequential_simulations)
        data['sweeps'] = self.sweeps
        return data

    def environment_sweeps(self, N_sweeps):
        """Sweeps that update only the environments."""
        for _ in range(max(N_sweeps, 0)):
            self.sweep(optimize=False)


class IterativeSweeps(Sweep):
    """``run()``: :meth:`run_iteration` until :meth:`stopping_criterion`."""

    def run(self):
        self.shelve = False
        self.pre_run_initialize()
        is_first_sweep = True
        result = None
        while True:
            iteration_start_time = time.time()
            if self.stopping_criterion(
                    iteration_start_time=iteration_start_time):
                break
            if not is_first_sweep:
                self.checkpoint.emit(self)
            result = self.run_iteration()
            self.status_update(iteration_start_time=iteration_start_time)
            is_first_sweep = False
        self.post_run_cleanup()
        return result

    def pre_run_initialize(self):
        self.time0 = time.time()

    def run_iteration(self):
        raise NotImplementedError

    def status_update(self, iteration_start_time):
        pass

    def is_converged(self):
        raise NotImplementedError

    def stopping_criterion(self, iteration_start_time):
        """Options ``min_sweeps`` (1), ``max_sweeps`` (1000), ``max_hours``;
        converged with the mixer on disables the mixer and goes on."""
        options = self.options
        min_sweeps = options.get('min_sweeps', 1, int)
        max_sweeps = options.get('max_sweeps', 1000, int)
        max_hours = options.get('max_hours', 24 * 365, 'real')
        if self.sweeps >= max_sweeps:
            return True
        if self.sweeps >= min_sweeps and self.is_converged():
            if self.mixer is None:
                return True
            logger.info("converged with mixer on: disable and continue")
            self.mixer_deactivate()
            return False
        if time.time() - self.time0 > max_hours * 3600:
            self.shelve = True
            logger.warning("max_hours exceeded: shelving")
            return True
        return False

    def post_run_cleanup(self):
        self.mixer_cleanup()


# ================================================================ compression
class VariationalCompression(IterativeSweeps):
    """Compress an MPS in place by maximizing its overlap with a copy of
    itself, bond by bond: each two-site update projects the old state onto
    the new state's environments and splits it by a truncated SVD.

    Options: ``trunc_params``, ``N_sweeps`` (2), ``tol_theta_diff``
    (1e-8).  ``run()`` returns the truncation error of the last sweep.
    """

    EffectiveH = TwoSiteH

    def __init__(self, psi, options, resume_data=None):
        self.options = asConfig(options, self.__class__.__name__)
        self.psi = psi
        self.old_psi = psi.copy()
        self.model = None
        self.trunc_params = self.options.subconfig('trunc_params')
        self.renormalize = []
        self.finite = psi.finite
        self.cache = DictCache.trivial()
        self.checkpoint = EventHandler("algorithm")
        self.env = MPSEnvironment(self.psi, self.old_psi)
        self.sweeps = 0
        self.mixer = None
        self.time0 = time.time()
        self.trunc_err_list = []
        self._theta_diff = None

    def run(self):
        N_sweeps = self.options.get('N_sweeps', 2, int)
        self.tol_theta_diff = self.options.get('tol_theta_diff', 1e-8,
                                               'real')
        trunc_err = TruncationError()
        for _ in range(N_sweeps):
            max_err = self.sweep()
            trunc_err = TruncationError(max_err, 1. - 2. * max_err)
            self.sweeps += 1
            if self._theta_diff is not None and \
                    self._theta_diff < self.tol_theta_diff:
                break
        if self.psi.finite:
            self.psi.norm *= max(self.renormalize, default=1.)
        return trunc_err

    def sweep(self, optimize=True):
        """Every bond left to right, then right to left; returns the
        largest truncation error."""
        self.renormalize = []
        self._theta_diff = 0.
        self.trunc_err_list = []
        bonds = list(range(self.psi.L - 1 if self.finite else self.psi.L))
        for i0 in bonds + bonds[::-1]:
            self.update_bond(i0)
        return np.max(self.trunc_err_list) if self.trunc_err_list else 0.

    def _theta(self, i0):
        """The old state's two-site theta at ``i0`` in the environments of
        the new state, legs ``(vL.p0), (p1.vR)``."""
        th = npc.tensordot(self.env.get_LP(i0),
                           self.old_psi.get_theta(i0, n=2),
                           axes=[['vR'], ['vL']])
        th = npc.tensordot(th, self.env.get_RP(i0 + 1),
                           axes=[['vR'], ['vL']])
        th.ireplace_labels(['vR*', 'vL*'], ['vL', 'vR'])
        return th.combine_legs([['vL', 'p0'], ['p1', 'vR']], qconj=[+1, -1])

    def update_bond(self, i0):
        U, S, VH, err, renorm = self._split_theta(self._theta(i0))
        self.trunc_err_list.append(err.eps)
        self.renormalize.append(renorm)
        self.psi.set_B(i0, U.split_legs([0]).ireplace_label('p0', 'p'), 'A')
        self.psi.set_SR(i0, S)
        self.psi.set_B(i0 + 1, VH.split_legs([1]).ireplace_label('p1', 'p'),
                       'B')
        self.env.del_LP(i0 + 1)
        self.env.del_RP(i0)

    def _split_theta(self, th):
        """The truncated decomposition of the two-site theta."""
        return svd_theta(th, self.trunc_params)

    def is_converged(self):
        return False

    def run_iteration(self):
        return self.sweep()


class VariationalApplyMPO(VariationalCompression):
    """``U|psi>`` for an MPO ``U``, in place, by variational compression:
    each update contracts ``LP W0 W1 RP`` with the old state's theta."""

    def __init__(self, psi, U_MPO, options, resume_data=None):
        super().__init__(psi, options, resume_data)
        self.env = MPOEnvironment(self.psi, U_MPO, self.old_psi)

    def _theta(self, i0):
        env = self.env
        W0 = env.H.get_W(i0).replace_labels(['p', 'p*'], ['p0', 'p0*'])
        W1 = env.H.get_W(i0 + 1).replace_labels(['p', 'p*'], ['p1', 'p1*'])
        th = _matvec_2site_plain_impl(env.get_LP(i0), env.get_RP(i0 + 1),
                                      W0, W1,
                                      self.old_psi.get_theta(i0, n=2))
        return th.combine_legs([['vL', 'p0'], ['p1', 'vR']], qconj=[+1, -1])


class QRBasedVariationalApplyMPO(VariationalApplyMPO):
    """:class:`VariationalApplyMPO` whose split is a QR of theta and a
    truncated SVD of the small R factor (arXiv:2212.09782)."""

    def _split_theta(self, th):
        Q, R = npc.qr(th, inner_labels=['vR', 'vL'])
        U2, S, VH, err, renorm = svd_theta(R, self.trunc_params,
                                           inner_labels=['vR', 'vL'])
        return npc.tensordot(Q, U2, axes=[['vR'], ['vL']]), S, VH, err, \
            renorm
