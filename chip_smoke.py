"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``tenpy_tpu_torch``'s main paths, the device-resident two-site iDMRG
sweep (``DeviceSweepEngine``) on the Fermi-Hubbard U=8 Ly=4 cylinder,
U(1)xU(1), at chi=256, and the chi ramp (``device_ramp``) to chi=256 from a
Neel product state; then its complex128 path, the ramp to chi=128 of the
Hofstadter cylinder (spinless fermions, flux 1/3, Lx=Ly=3, U(1) N).  The
port builds the models, their MPOs and the environments itself; the
committed exchange file
``tests/benchmark_data/hubbard_cyl_chi256_exchange.npz`` supplies the
chi=256 state (B and S) and the JAX package's values to hold the port to.
Phases (any failure exits nonzero):

1. device: card name and power limit, CUDA present, TF32 off;
2. build: the CUDA kernel library from ``tenpy_tpu_torch/csrc``;
3. the kernel against its plain PyTorch version (the table walker) on the
   card: f64, f32, f64 under the f32 matmul mode and complex128, at
   synthetic shapes,
   the main path's own and two multi-bucket-pair tensordots (one of them
   all-thin) written into NaN-filled outputs;
4. packed matvec at chi=256, CUDA against the CPU; for each of its four
   tensordots the kernel against the plain version, with the kernel's
   (also with its tasks shuffled), the plain version's and the library's
   (``torch.bmm`` per bucket pair) times beside the bound; the batched SVD
   time of one split;
5. the main path: ``FermiHubbardModel``, the MPS of the exchange file and
   ``DeviceSweepEngine(psi, model, OPTIONS, 'cuda')``; its host setup (W,
   charge gauge, environments) held to the file's JAX values, then
   ``E, psi = run()``, 3 sweeps, with the kernel's launches per sweep held
   to the tensordots run and the energies to JAX's; then the write-back
   into the caller's MPS (seconds of the move to the host and of
   ``canonical_form``, ``norm_test`` before and after) and what a user
   measures on it (TM energy, entropies, ``Ntot``, ``Sz``, correlation
   length, each timed), held to the JAX package's write-back of the same
   run (``tests/benchmark_data/hubbard_write_back_reference.npz``);
6. the ramp: ``device_ramp`` from the Neel product state to chi=256, with
   per-stage times, launches and energies per site, held to the committed
   chi=256 state's energy per site; its last stage, and only it, writes
   back: ``norm_test`` after the re-gauge, the TM energy against the
   ramp's own sweep estimate, the cell's total ``Ntot`` and ``Sz``;
7. the complex path: ``HofstadterFermions`` (complex MPO) from the product
   state at 1/3 filling, whose unit-cell charge (Q=3 on L=9 sites) takes
   the charge-unit rescale of the uniform gauge; ``device_ramp`` to
   chi=128 with per-stage times, launches (held to the tensordots run) and
   Lanczos steps, its first update held to JAX's (1e-10) and its energy
   per site to JAX's run of the same protocol
   (``tests/benchmark_data/hofstadter_reference.npz``); the written-back
   state complex128 with a nonzero imaginary part, canonical, N = 3 per
   cell, and measured (TM energy, entropies, N, correlation length); then
   the complex128 kernel against its plain version, timed, on that
   engine's chi=128 matvec;
8. the TEBD path (``bench_tebd.py``): the XXZ chain's Delta=1.5 ground
   state by ``device_ramp``, quenched under Delta=1 with
   ``DeviceTEBDEngine`` (real time, complex128, order 2, dt=0.05) in
   stages until every bond holds chi=512, each stage built from the last
   one's written-back state; then the median seconds of 5 Trotter steps
   beside the reference's 0.516 s/step, kernel launches per step held to
   the tensordots run, no sector at its capacity, the device share and the
   SVD's share of one profiled step, peak memory, Sz per cell, the sum of
   S^2 per bond and the energy drift against the truncation error; the
   committed real-time case of ``tests/benchmark_data/tebd_reference.npz``
   held to JAX's engine; and the kernel against its plain version on the
   three tensordots of one chi=512 bond update, timed;
9. TeNPy's own entry point: ``dmrg.run(psi, model, options,
   device='cuda')`` (``TwoSiteDMRGEngine``, host tensors, every two-site
   Lanczos update forced onto the packed Lanczos on the card by
   ``lanczos_params['device_K']``) on the open XX chain (L=32) from the
   Neel state, ramped by ``chi_list`` to chi_max=512 (the state needs 432
   above svd_min); held to the free-fermion
   energy, canonical, total Sz 0, the kernel's launches equal to 4 per
   device matvec and to the tensordots run; seconds per sweep, the time
   per update by part (ED_block, pack, device Lanczos, unpack, split,
   environment update), plan builds and cache hits, peak memory; at the
   centre bond of the result the card's ``_diag_device_lanczos`` against
   the host ``LanczosGroundState`` on the same effective H; the two
   routes timed against each other at several sizes N of one sweep (the
   crossover); one more sweep profiled (the device's idle share); and the
   kernel against its plain version on the centre update's matvec, timed;
10. TeNPy's simulation layer and command line (``console_main`` in this
   process, or where PyYAML is absent ``run_simulation`` and
   ``run_seq_simulations`` on copies of the files' options), with no
   ``device_K``: the engine's own ``DEVICE_LANCZOS_THRESHOLD`` sends the
   eigensolves to the card.  10a: the repo's ``minimal_DMRG.yml`` (L=32,
   chi=100) with ``device=cpu`` and on the card, energies held to each
   other, every update from the threshold up on the card; 10b:
   ``sequential_chi_ramp.yml`` on the XX chain at L=64, chi 128, 256, 512,
   each stage from the last one's state, per stage the phases' times,
   sweeps, the card's share of the updates, launches (4 per Lanczos step)
   and plan builds, the last energy held to free fermions and the state
   checked; 10c: the stage files loaded (``psi``, measurements, energy,
   resume data), the last one resumed on the card, the results as
   ``.h5`` where h5py imports; then the kernel against its plain version
   on the final state's chi=512 centre matvec, timed;
11. TeNPy's time evolution (``console_main``, no ``device_K`` or other
   option: the TDVP engine's own threshold sends the local evolutions to
   the card).  11a: ``minimal_DMRG.yml`` on the XX chain (L=32, Jz=0) at
   chi_max=256, svd_min=1e-12, held to free fermions; 11b:
   ``minimal_SpectralSimulation.yml`` from 11a's file with
   ``TwoSiteTDVPEngine`` at chi_max=256, dt=0.05 to ``TE_FINAL_TIME``:
   seconds per TDVP step, the share of two- and one-site evolutions on
   the card, Krylov steps and host syncs per update, launches held to 4
   x two-site + 3 x one-site Krylov steps on the card (each kind counted
   around the card's evolutions), plan builds, peak
   memory; ``C_j(t) = e^(i E0 t) <Sz_j(t) Sz_c(0)>`` at every measured
   time held to free fermions (Wick's theorem), ``<H>`` conserved within
   the accumulated truncation error, ``S(k, w)`` finite; 11c: one TDVP
   step by the card's route and by the host's from the same state (a
   profiled one on the card: idle share, device-to-host copies), their
   overlap, and the two routes timed by N for two- and one-site
   evolutions (the crossover; the card's call with its plans built anew
   and with them cached); then the kernel against its plain version
   on the centre's complex128 two- and one-site matvecs, timed;
12. TeNPy's VUMPS (no ``device_K``: the engines' own threshold sends the
   zero-, one- and two-site eigensolves to the packed Lanczos on the card;
   launches counted around each card eigensolve by kind and held to 2 x
   zero-site + 4 x two-site (3 x one-site) Lanczos steps; each update
   timed by part: the environment fixed point, the eigensolves (pack,
   Lanczos, unpack), the polar decompositions, the SVD).  12a:
   ``TwoSiteVUMPSEngine`` on the infinite XX chain (Sz) from the Neel
   state ramped by ``chi_list`` to chi=256 with the subspace-expansion
   mixer, held to -1/pi and to the port's iDMRG at the same chi_max
   (``dmrg.run``), canonical, split error under its option, the returned
   state's MPO and bond energies; its last update's zero- and two-site
   problems by the card's packed Lanczos against the host
   ``LanczosGroundState`` (E 1e-12, overlap 1 - 1e-10); the last sweep
   profiled (idle share).  12b: ``SingleSiteVUMPSEngine`` on phase 7's
   chi=128 complex128 Hofstadter state, two sweeps, held to phase 7's
   energy per site (at most + 1e-10), canonical, split errors
   non-increasing.  12c: ``minimal_DMRG.yml`` as ``TwoSiteVUMPSEngine``
   on the infinite Heisenberg chain (chi 64) through ``console_main``: the
   saved energy against the exact one, the measurements of the converged
   state.  Then the kernel against its plain version on the zero- and
   two-site (f64, chi=256) and zero- and one-site (complex128, chi=128)
   matvecs of the last updates, timed;
13. TeNPy's finite-temperature purification (``PurificationTEBD(psi,
   model, options, device='cuda')``; the engine's own
   ``DEVICE_SPLIT_THRESHOLD`` sends a bond update to the card: the gate
   ``U_p (x) 1_q`` on the (p, q) pipes as one packed tensordot, one launch
   of the kernel, and the batched split with the host's cut).  13a: the
   open XX chain (L=32, Sz) from the infinite-temperature state in
   imaginary-time stages to the beta where the central bonds hold chi=256,
   E(beta) held to the Trotterized free-fermion energy within the
   truncation's tolerance (the untrotterized one beside it),
   ``norm_test``, every update from the threshold up on the card, kernel
   launches equal to the card updates, the card's update of a saturated
   bond against the host's on the same theta (S and ``A S B``); 13b: the
   canonical ensemble at Sz=0 with conserved ancilla charges (doubled
   U(1)), L=12, every update on the card, held to exact diagonalization
   in the sector; 13c: one saturated update by part, the median of a few
   ``update_imag`` steps, one profiled step (idle share), peak memory,
   the card's update against the host's by N (the crossover) and the host
   SVD against the batched split; then the kernel against its plain
   version on the saturated bond's gate, timed;
14. TeNPy's plane-wave excitations (``PlaneWaveExcitationEngine(u, model,
   options, device='cuda')``; a solve's matvecs on the card, every
   tensordot one kernel launch, the Krylov vectors lists of packed X).
   14a: the S=1 Heisenberg chain (L=2, Sz) by two-site VUMPS stages at chi
   32, 64 and 128 and single-site sweeps at chi=128, all on the card; its
   magnon (``qtotal_change=[2]``) at pi/2 and pi, the gap at pi held to
   0.41047925 (1e-4) and the dispersion's minimum at pi, every solve on
   the card, launches equal to the tensordots run (matvecs and the
   guess's zero-site eigensolves), ``energy(p, X)`` against the Lanczos
   energy (1e-10), the card's matvec against the host's on the final X
   (1e-12); 14b: the TFI chain through ``PlaneWaveExcitations`` on the
   card at three momenta against the exact dispersion (1e-8), JAX's chi=24
   charged-magnon state (``tests/benchmark_data/excitation_reference.npz``)
   and its gap (1e-10), the GMRES sums against the explicit ones (1e-10);
   14c: one matvec by part with either sum method, launches and host
   reads per matvec, one profiled solve (idle share), the card's matvec
   against the host's by N (the crossover that sets
   ``DEVICE_EXCITATION_THRESHOLD``), and the kernel against its plain
   version on one transfer-matrix step of the right sum at chi=128,
   timed;
15. segment boundary conditions (``OrthogonalExcitations`` of an infinite
   ground state and ``TopologicalExcitations``, ``device='cuda'``; no
   ``device_K``: the DMRG engine's own threshold sends every two-site
   update from N=256 up to the packed Lanczos on the card, the
   orthogonalized ones projected there, ``P H P v`` per matvec).  15a:
   phase 14's chi=128 S=1 state (``to_MPS()``) cut to a segment of 16
   unit cells in its fixed-point environments, ``Sp`` at the centre
   site, two excitations in the Delta Sz = +1 sector at chi_max 128, the
   second projected against the first (eight sweeps each): the first gap
   above the Haldane gap and below it plus twice the box estimate, E2 >=
   E1 - 1e-8,
   |<psi2|psi1>| < 1e-6, both states of charge +2, every update from
   N=256 up on the card (the projected ones counted apart), launches 4
   per Lanczos step; at the centre the card's projected eigensolve
   against the host's on the same effective H (E 1e-10 relative, Ritz
   vectors 1 - 1e-8, their overlaps with the projected vectors equal),
   both routes timed; the kernel against its plain version on the
   centre's matvec, timed; 15b: the two broken ground states of the
   ferromagnetic TFI chain (g=0.7) by ``dmrg.run`` from the +-x product
   states, glued by ``TopologicalExcitations`` on 16 unit cells and
   relaxed on the card: the kink above 2(J - g) and within the box
   estimate, the glued state a valid segment; both routes of a projected
   update (the glued state against the kink) timed at a bond of N in
   256-1024;
then a JSON line on the kernels (the f64 mode, the complex128 mode, the
complex128 mode on the TEBD shapes, the f64 mode on the host DMRG's and
on the simulation's shapes, the complex128 mode on TDVP's two- and
one-site matvecs, VUMPS's four matvecs, the purification gate, the
plane-wave transfer step and the projected segment matvec) and, last,
``{"ok": true, "device": ...}``.

The phases run in three processes on the one card: this one runs 1-9 and
12b, worker B 10, 13, 12a and 12c, worker C 11, 14 and 15 (``WORKERS``);
a worker's failure fails the smoke, and the workers end with it.

Run from the root of a checkout: ``python3 chip_smoke.py``; one worker's
phases alone: ``python3 chip_smoke.py --worker C out.json``.
"""

import contextlib
import copy
import fcntl
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import tenpy_tpu_torch
from tenpy_tpu_torch import _build
from tenpy_tpu_torch.algorithms import dmrg
from tenpy_tpu_torch.algorithms import mps_common as mc
from tenpy_tpu_torch.algorithms.mps_common import _matvec_2site_packed
from tenpy_tpu_torch.algorithms.packed_dmrg import DeviceSweepEngine, \
    device_ramp
from tenpy_tpu_torch.algorithms.packed_tebd import DeviceTEBDEngine, \
    _bond_step
from tenpy_tpu_torch.linalg import grouped_gemm as gg
from tenpy_tpu_torch.linalg import np_conserved as npc
from tenpy_tpu_torch.linalg.krylov_based import LanczosGroundState
from tenpy_tpu_torch.linalg import packed as pk
from tenpy_tpu_torch.linalg import packed_split as ps
from tenpy_tpu_torch.models.hofstadter import HofstadterFermions
from tenpy_tpu_torch.models.hubbard import FermiHubbardModel
from tenpy_tpu_torch.models.spins import SpinChain
from tenpy_tpu_torch.models.xxz_chain import XXZChain
from tenpy_tpu_torch.networks import exchange
from tenpy_tpu_torch.networks.mps import MPS

ROOT = os.path.dirname(os.path.abspath(__file__))
STATE = os.path.join(ROOT, 'tests', 'benchmark_data',
                     'hubbard_cyl_chi256_exchange.npz')
WRITE_BACK_REF = os.path.join(ROOT, 'tests', 'benchmark_data',
                              'hubbard_write_back_reference.npz')
HOF_REF = os.path.join(ROOT, 'tests', 'benchmark_data',
                       'hofstadter_reference.npz')
# the options of the JAX reference stored in the exchange file (checked);
# the seam cap of 60 makes the wrap updates converge (tests/torch_exchange.py)
OPTIONS = {'chi_max': 256, 'svd_min': 1e-10, 'lanczos_K': 10,
           'lanczos_K_seam': 60, 'n_sweeps': 3, 'cap_factor': 1.3,
           'backend': 'svd'}
MODEL = {'lattice': 'Square', 'Lx': 2, 'Ly': 4, 'bc_y': 'cylinder',
         'bc_MPS': 'infinite', 't': 1., 'U': 8., 'mu': 0.}
# the Neel state in MPS order: x=0 up,down,up,down; x=1 down,up,down,up
NEEL = ['up', 'down', 'up', 'down', 'down', 'up', 'down', 'up']
RAMP_OPTIONS = {'chi_max': 256, 'svd_min': 1e-10, 'lanczos_K': 10,
                'lanczos_K_seam': 60, 'sweeps_per_stage': 2, 'n_sweeps': 4,
                'backend': 'svd'}
# energy per site of the committed chi=256 state: (E[n] - E[n-1]) / (2 L)
# of the JAX sweeps stored with it (checked below).  The ramp's 4 sweeps at
# chi=256 start from its chi=128 stage and land 2.3e-4 above it, while the
# chi=128 -> 256 step moves the energy per site by 9.9e-4 (PERF.md): 5e-4
# tells chi=256 physics from chi=128 physics with room for the ramp's
# unconverged remainder
E_SITE_REF = -0.5241574
E_SITE_TOL = 5e-4
# the chi=256 write-back against the JAX package's write-back of the same
# run: sorted Schmidt values per bond and entropies (absolute), the TM
# energy per site and the correlation length (relative).  Measured on an
# H100 (PERF.md): 7.5e-8, 1.8e-7, 3.9e-11 (GMRES against JAX's Arnoldi) and
# 2.5e-4 (Arnoldi with N_max=20 for the subleading eigenvalue, in both)
WB_TOL = {'S': 3e-7, 'tm_E': 1e-9, 'entropy': 5e-7, 'xi': 1e-3}
# the unit cell's total charges, exact under charge conservation: N = 8 at
# half filling, Sz = 0 (Neel)
CELL_N, CELL_TOL = 8., 1e-10
# the environments: JAX's come from its Arnoldi route, the port's from its
# GMRES builder (tests/test_torch_ramp.py measures 8.6e-13 on the CPU)
ENV_TOL = 1e-10
# (m, k, n), entries, fan-ins: synthetic shapes, then the main
# path's own (the MPO contractions' k = n = 1 rows of 4096 and 64, and the
# 32 and 8 x 16 sector blocks of the virtual-leg contractions)
KERNEL_SHAPES = [((64, 64, 64), 240, (1, 3, 40)),
                 ((128, 128, 128), 240, (1, 3, 40)),
                 ((256, 1024, 256), 32, (1, 3, 40)),
                 ((37, 129, 65), 50, (1, 3, 40)), ((1, 3, 5), 7, (1, 3, 40)),
                 ((4096, 1, 1), 2528, (10,)), ((64, 1, 1), 115120, (1, 3, 10)),
                 ((32, 32, 32), 664, (1, 3, 18)), ((8, 16, 8), 240, (1, 3, 18))]
# (data dtype, compute dtype): f64, f32, f64 under matmul_mode('f32') and
# complex128
MODES = [(torch.float64, torch.float64), (torch.float32, torch.float32),
         (torch.float64, torch.float32), (torch.complex128, torch.complex128)]
TOL = {torch.float64: 1e-12, torch.float32: 1e-5,    # summation order only
       torch.complex128: 1e-12}
SPIN_CYCLES = 10_000_000     # about 5 ms of the card's clock
# NVIDIA H100 SXM data sheet: HBM rate and peak rates (f64 tensor cores for
# f64 and complex128 sums, f32 CUDA cores for f32 sums)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12,
              torch.complex128: 67e12}
# the complex path (BASELINE config #5; tests/torch_exchange.py holds the
# same model, state and options, and the reference file is checked
# against them): the Hofstadter cylinder at 1/3 filling, ramped to chi=128
HOF_MODEL = {'lattice': 'Square', 'Lx': 3, 'Ly': 3, 'bc_y': 'cylinder',
             'bc_MPS': 'infinite', 'phi': [1, 3], 'conserve': 'N', 'mu': 0.,
             'v': 0.}
HOF_INIT = ['full', 'empty', 'empty'] * 3
HOF_OPTIONS = {'chi_max': 128, 'svd_min': 1e-10, 'lanczos_K': 10,
               'lanczos_K_seam': 60, 'sweeps_per_stage': 2, 'n_sweeps': 4,
               'backend': 'svd'}
# energy per site of the ramp's last stage against JAX's run of the same
# protocol on a CPU: measured 1.1e-12 apart on an H100 (PERF.md).  Below
# the exact regime a cut inside a degenerate multiplet is decided by
# roundoff; the last stage truncates 4.7e-11 per update, so such a cut
# moves the energy per site by about that: 1e-10 allows it
HOF_E_TOL = 1e-10
# the TPU's run of config #5 (conserve=None; BENCH_NORTHSTAR.json), logged
# beside the result as a sanity check, not a gate
HOF_E_TPU = -0.8654432647
HOF_CELL_N = 3.
# the correlation length's Arnoldi stops once the dominant eigenpair has
# converged; forced to 30 steps it converges the subleading one too
# (tests/test_torch_state_distance.py)
XI_STEPS = 30
# the TEBD path (bench_tebd.py, BASELINE's "TEBD step time at chi=512"): the
# ground state of the gapped XXZ chain (Delta=1.5) from device_ramp,
# quenched under the critical chain (Delta=1) until every bond holds
# chi=512 (Schmidt values above svd_min=1e-10), then timed
XXZ_GS = {'L': 2, 'Jxx': 1., 'Jz': 1.5, 'hz': 0., 'bc_MPS': 'infinite',
          'sort_charge': True}
XXZ_QUENCH = dict(XXZ_GS, Jz=1.0)
XXZ_RAMP_OPTIONS = {'chi_max': 64, 'svd_min': 1e-12, 'lanczos_K': 10,
                    'lanczos_K_seam': 60, 'sweeps_per_stage': 2,
                    'n_sweeps': 4, 'backend': 'svd'}
TEBD_CHI = 512
TEBD_OPTIONS = {'svd_min': 1e-10, 'dt': 0.05, 'order': 2, 'type_evo': 'real',
                'N_steps': 1, 'backend': 'svd'}
# growth: a stage doubles chi (capacity per sector grown by TEBD_GROW times
# the chi ratio, as device_ramp does) and ends when every bond holds its
# chi, a sector fills its capacity, or after TEBD_STAGE_T; the quench gives
# up at bench_tebd.py's evolved time of 60.  The timed engine is built from
# the grown state with bench_tebd.py's cap_factor of 1.2
TEBD_GROW, TEBD_STAGE_STEPS, TEBD_STAGE_T, TEBD_T_MAX = 1.2, 10, 5., 60.
TEBD_TIMED_STEPS = 5
# reference tenpy on one CPU core at chi=512 (BENCH_NORTHSTAR.json
# tebd_chi512)
TEBD_REF_S_PER_STEP = 0.516
TEBD_REF = os.path.join(ROOT, 'tests', 'benchmark_data',
                        'tebd_reference.npz')
TEBD_STEPS = ['B0.B1 over vR/vL', 'U.C over (p0*,p1*)',
              "C.B'^H over (p1,vR)"]
# the host DMRG path: dmrg.run on the open XX chain (Sz conserved) from the
# Neel state, ramped to chi=512 (the width phase 8 runs XXZChain at); every
# two-site Lanczos update is forced onto the card (device_K: at most that
# many Lanczos steps, with the early exit).  norm_tol: TeNPy's end-of-run
# canonicalization where the last sweep's bond-1 update left the norm test
# above it (tests/test_torch_host_dmrg.py: 1.3e-10 at L=16).  L=32, cut
# from 64 when phase 10 joined the smoke (the whole smoke took 620 s at
# L=64): the crossover's bonds remain, the chain's centre needs chi=432
# above svd_min, and phase 10 runs L=64 to chi=512
XX_MODEL = {'L': 32, 'Jxx': 1., 'Jz': 0., 'hz': 0., 'bc_MPS': 'finite'}
XX_DEVICE_K = 20
XX_OPTIONS = {'trunc_params': {'chi_max': 512, 'svd_min': 1e-12},
              'chi_list': {0: 64, 2: 256, 4: 512}, 'mixer': False,
              'max_E_err': 1e-11, 'max_sweeps': 10, 'norm_tol': 1e-10,
              'lanczos_params': {'device_K': XX_DEVICE_K}}
# |E - E_exact| / |E_exact|, the exact energy from free fermions
XX_E_TOL = 1e-8
XX_NORM_TOL = 1e-10
# the centre update, card against host: Lanczos steps, the guess's seeded
# perturbation (norm relative to theta) and the tolerances
XX_CHECK_K, XX_CHECK_NOISE, XX_CHECK_SEED = 40, 1e-2, 9
XX_CHECK_E_TOL, XX_CHECK_OV_TOL = 1e-10, 1e-8
# the crossover: both routes run XX_CROSS_K fixed Lanczos steps on the
# effective H of these bonds (N = 64, 256, 1024, 4096, ... up to the
# centre's; the chain's doubling bonds give no N between 64 and 256), the
# whole table XX_CROSS_REPEATS times
XX_CROSS_K = 10
XX_CROSS_BONDS = (1, 2, 3, 4, 6, 8, 10, None)    # None: the centre bond
XX_CROSS_REPEATS = 3


# the simulation layer and the command line (phase 10): the repo's own
# YAML files through console_main, as TeNPy users run them; no device_K, so
# the engine's own rule (DEVICE_LANCZOS_THRESHOLD) decides the route
SIM_MINIMAL_YML = os.path.join(ROOT, 'examples', 'yaml', 'minimal_DMRG.yml')
SIM_SEQ_YML = os.path.join(ROOT, 'examples', 'yaml',
                           'sequential_chi_ramp.yml')
# logging: no handler on stdout and no .log file (stdout keeps the smoke's
# lines; warnings still reach stderr)
SIM_LOG = {'to_stdout': None, 'to_file': None}
# 10b: the XX chain (Jz=0: free fermions) at L=64 up to chi=512, the width
# of phases 8 and 9.  The file's own norm_tol (TeNPy's default, 1e-5)
# applies, so the final state's norm_test is held as the sweeps left it,
# before the engine's end-of-run cleanup
SIM_SEQ_OVERRIDES = ['model_params.L=64', 'model_params.Jz=0.',
                     'algorithm_params.trunc_params.chi_max=[128, 256, 512]',
                     'algorithm_params.max_E_err=1e-11']
SIM_SEQ_CHIS = (128, 256, 512)
# where PyYAML is absent, run_simulation and run_seq_simulations take these
# copies of the two files with the same overrides (checked against the
# files where yaml imports)
SIM_MINIMAL_PARAMS = {
    'simulation_class': 'GroundStateSearch',
    'output_filename': 'results_minimal_DMRG.pkl',
    'model_class': 'SpinChain',
    'model_params': {'L': 32, 'bc_MPS': 'finite'},
    'initial_state_params': {'method': 'lat_product_state',
                             'product_state': [['up'], ['down']]},
    'algorithm_class': 'TwoSiteDMRGEngine',
    'algorithm_params': {'trunc_params': {'svd_min': 1e-8, 'chi_max': 100}},
}
SIM_SEQ_PARAMS = {
    'simulation_class': 'GroundStateSearch',
    'output_filename_params': {
        'prefix': 'results_sequential',
        'parts': {'algorithm_params.trunc_params.chi_max': 'chi_{0:04d}'},
        'suffix': '.pkl'},
    'model_class': 'SpinChain',
    'model_params': {'L': 64, 'bc_MPS': 'finite', 'Jz': 0.},
    'initial_state_params': {'method': 'lat_product_state',
                             'product_state': [['up'], ['down']]},
    'algorithm_class': 'TwoSiteDMRGEngine',
    'algorithm_params': {'trunc_params': {'chi_max': [128, 256, 512]},
                         'max_E_err': 1e-11},
    'sequential': {'recursive_keys':
                   ['algorithm_params.trunc_params.chi_max']},
}
# 10a: the card's run against the CPU run of the same file (svd_min 1e-8
# in the file, and the two runs' Lanczos stop differently); 10b: the last
# stage against free fermions; 10c: the resumed run against the loaded
# energy, two more sweeps at most
SIM_CPU_REL = 1e-8
SIM_E_REL = 1e-10
SIM_NORM_TOL = 1e-10
SIM_RESUME_REL = 1e-11
SIM_RESUME_SWEEPS = 2


def log(*a):
    print(*a, flush=True)


def check(ok, msg):
    """A phase check that also holds under ``python -O``."""
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, reps=20):
    """Median device milliseconds of ``fn()`` over ``reps`` runs (CUDA
    events).  A spin on the card queued ahead of the first event keeps it
    busy while the host enqueues ``fn``'s launches, so the events bracket
    device time and not the host's launch overhead (a function that
    synchronises with the host inside is timed with its host time).  The
    smoke's processes take turns here (``timing_lock``)."""
    with timing_lock():
        fn()
        times = []
        for _ in range(reps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            t0.record()
            fn()
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1))
    return statistics.median(times)


@contextlib.contextmanager
def timing_lock():
    """Hold the lock file that the smoke's processes share (``SMOKE_LOCK``
    in the environment), so that no two of them time the card at once."""
    path = os.environ.get('SMOKE_LOCK')
    if path is None:
        yield
        return
    with open(path, 'a') as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


@contextlib.contextmanager
def host_threads(n, tag):
    """Run the block on ``n`` torch host threads, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    log(f"[{tag}] host threads {n} (the process's default {threads})")
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def rel_err(x, ref):
    return float((x - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def packed_rel_err(p, ref):
    num = sum(float(((a.cpu() - b.cpu()).abs() ** 2).sum())
              for a, b in zip(p.data, ref.data))
    den = sum(float((b.cpu().abs() ** 2).sum()) for b in ref.data)
    return (num / max(den, 1e-300)) ** 0.5


def outs_err(outs, refs):
    """(max abs, max relative) difference of two lists of output buckets."""
    abs_e = max(float((o - r).abs().max()) if o.numel() else 0.
                for o, r in zip(outs, refs))
    scale = max(float(r.abs().max()) if r.numel() else 0. for r in refs)
    return abs_e, abs_e / max(scale, 1e-300)


def phase_device():
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this script measures the "
                           "card and does not run on the CPU")
    log(f"[1] nvidia-smi: {smi}")
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    log(f"[1] torch.backends.cuda.matmul.allow_tf32 = {tf32}")
    check(tf32 is False, "TF32 matmul must be off for the f32 comparisons")
    return smi


def phase_build():
    _, seconds, nvcc_log = _build.build()
    log(f"[2] kernel library built in {seconds:.2f} s")
    for line in nvcc_log.splitlines():
        if 'registers' in line or 'spill' in line or 'error' in line:
            log(f"[2] ptxas: {line.strip()}")
    _build.library()


def random_tensor(shape, dtype, rng):
    """Seeded normal entries on the card (complex: re and im each)."""
    x = rng.standard_normal(shape)
    if dtype.is_complex:
        x = x + 1j * rng.standard_normal(shape)
    return torch.from_numpy(x).to('cuda', dtype)


def random_case(m, k, n, B, fan_in, dtype, rng):
    U = max(1, B // fan_in)
    seg = np.sort(np.concatenate([np.arange(U), rng.integers(0, U, B - U)]))
    Na, Nb = max(1, B // 2), max(1, B // 2)
    dev = torch.device('cuda')
    a = random_tensor((Na, m, k), dtype, rng)
    b = random_tensor((Nb, k, n), dtype, rng)
    seg_ptr = np.concatenate([[0], np.cumsum(np.bincount(seg, minlength=U))])
    idx = [torch.from_numpy(x.astype(np.int32)).to(dev) for x in
           (seg_ptr, rng.integers(0, Na, B), rng.integers(0, Nb, B))]
    return (a, b, *idx, U)


def multi_group_case(dtype, rng, thin_only=False):
    """A whole-tensordot call: rows of output bucket 0 sum the entries of
    two bucket pairs (k = 32 and k = 8); bucket 1 is thin with k = n = 1,
    bucket 2 thin with k = 3, n = 5, bucket 3 a ragged block (k = 21) and
    bucket 4 gets no entry.  Pair p reads a bucket p and b bucket p.  With
    ``thin_only`` only the thin pairs have entries, so every bucket is thin
    (buckets 0, 3 and 4 unreached) and the thin kernel runs."""
    dev = torch.device('cuda')
    a_shapes = [(40, 32, 32), (40, 32, 8), (60, 64, 1), (30, 12, 3),
                (20, 24, 21)]
    b_shapes = [(30, 32, 32), (30, 8, 32), (10, 1, 1), (15, 3, 5),
                (12, 21, 40)]
    out_dims = [(50, 32, 32), (40, 64, 1), (30, 12, 5), (10, 24, 40),
                (25, 16, 16)]
    pairs = [(0, 0, 400), (0, 1, 300), (1, 2, 300), (2, 3, 90), (3, 4, 45)]
    if thin_only:
        pairs = pairs[2:4]
    a_bufs = [random_tensor(s, dtype, rng) for s in a_shapes]
    b_bufs = [random_tensor(s, dtype, rng) for s in b_shapes]
    cols, k_min = [], [np.inf] * len(out_dims)
    for so, pi, cnt in pairs:
        k = a_shapes[pi][2]
        k_min[so] = min(k_min[so], k)
        cols.append(np.stack([
            np.full(cnt, so), rng.integers(0, out_dims[so][0], cnt),
            np.full(cnt, pi), rng.integers(0, a_shapes[pi][0], cnt),
            np.full(cnt, pi), rng.integers(0, b_shapes[pi][0], cnt),
            np.full(cnt, k)]))
    cols = torch.from_numpy(np.concatenate(cols, axis=1)).to(dev)
    classes = [gg.shape_class(m, n, km) for (_, m, n), km
               in zip(out_dims, k_min)]
    return a_bufs, b_bufs, gg.build_tables(out_dims, classes, *cols)


def phase_kernel():
    """The kernel against the plain version (the table walker) on the card;
    returns the largest absolute difference of the f64 and of the
    complex128 mode."""
    rng = np.random.default_rng(0)
    max_abs = {torch.float64: 0., torch.complex128: 0.}
    for dtype, compute in MODES:
        mode = f"{str(dtype)[6:]}/{str(compute)[6:]}"
        for (m, k, n), B, fans in KERNEL_SHAPES:
            for f in fans:
                a, b, seg_ptr, ia, ib, U = random_case(m, k, n, B, f, dtype,
                                                       rng)
                tables = gg.segsum_tables(a, b, seg_ptr, ia, ib, U)
                args = ([a], [b], tables, compute)
                out = gg.packed_contract(*args)
                ref = gg.packed_contract_plain(*args)
                torch.cuda.synchronize()
                abs_e, err = outs_err(out, ref)
                ok = err <= TOL[compute] and torch.isfinite(out[0]).all()
                if compute == dtype:
                    # the one-pair API: the same tables, so the same bits
                    api = gg.grouped_gemm_segsum(a, b, seg_ptr, ia, ib, U)
                    ok = ok and torch.equal(api, out[0])
                ms = cuda_ms(lambda: gg.packed_contract(*args))
                plain_ms = cuda_ms(lambda: gg.packed_contract_plain(*args))
                log(f"[3] {mode} m,k,n={m},{k},{n} B={B} fan-in={f} "
                    f"tasks={tables.tasks.shape[0]} "
                    f"{'thin' if tables.thin else 'any'} kernel: rel_err "
                    f"{err:.2e} kernel "
                    f"{ms:.4f} ms plain {plain_ms:.4f} ms "
                    f"{'ok' if ok else 'FAIL'}")
                check(ok, f"kernel disagrees with plain: {err:.2e}")
                if compute in max_abs:
                    max_abs[compute] = max(max_abs[compute], abs_e)
        # several bucket pairs per output row and unreached buckets, written
        # into NaN-filled outputs: a row the kernel missed stays NaN
        for thin_only in (False, True):
            a_bufs, b_bufs, tables = multi_group_case(dtype, rng, thin_only)
            nan = [torch.full(d, float('nan'), dtype=dtype, device='cuda')
                   for d in tables.out_dims]
            out = gg.packed_contract(a_bufs, b_bufs, tables, compute, out=nan)
            ref = gg.packed_contract_plain(a_bufs, b_bufs, tables, compute)
            torch.cuda.synchronize()
            abs_e, err = outs_err(out, ref)
            unreached = [4, 0, 3] if thin_only else [4]
            ok = (err <= TOL[compute] and tables.thin == thin_only
                  and all(torch.isfinite(o).all() for o in out)
                  and not any(out[i].any() for i in unreached))
            log(f"[3] {mode} multi-group tensordot, "
                f"{'thin' if tables.thin else 'any'} kernel "
                f"({tables.tasks.shape[0]} tasks, {tables.entries.shape[0]} "
                f"entries, classes {sorted(set(tables.classes))}, unreached "
                f"buckets {unreached}): rel_err {err:.2e} "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"multi-group kernel disagrees with plain: {err:.2e}")
            if compute in max_abs:
                max_abs[compute] = max(max_abs[compute], abs_e)
    return max_abs


def contract_cost(args, groups):
    """(bytes, flops) a packed_contract call must move and compute: every
    operand bucket read once, every output written once, the least index
    of a block product (its a block, b block and output row: three int32),
    and 2 m k n real flops per block product (8 m k n for complex data: a
    complex multiply-add is 4 real multiplies and 4 adds).  The kernel's
    own schedule (its task table and the rest of its entry rows) is not
    counted."""
    a_bufs, b_bufs, tables, compute = args
    size = a_bufs[0].element_size()
    per_mac = 8 if compute.is_complex else 2
    out_dims = tables.out_dims
    nbytes = (sum(x.numel() for x in (*a_bufs, *b_bufs)) * size
              + sum(r * m * n for r, m, n in out_dims) * size
              + tables.entries.shape[0] * 3 * 4)
    flops = sum(per_mac * rows.numel() * out_dims[so][1] * k
                * out_dims[so][2] for so, _, _, k, rows, _, _ in groups)
    return nbytes, flops


def schedule_stats(args, groups):
    """What the kernel's schedule does beyond the bound's count: the operand
    bytes its tasks read, repeats included (each task reads its slice of
    every entry's A and B blocks, from L2 or HBM), the FLOPs its tiles
    execute (zero padding included), and the FLOPs a fixed 64 x 64 x 16
    tile per output block would execute."""
    a_bufs, _, tables, compute = args
    per_mac = 8 if compute.is_complex else 2
    out_dims = tables.out_dims
    t, k = tables.tasks.long().cpu(), tables.entries[:, 4].long().cpu()
    k_pre = torch.cat([k.new_zeros(1), torch.cumsum(k, 0)])
    k_sum = k_pre[t[:, 6]] - k_pre[t[:, 5]]       # sum of k over its entries
    dims = torch.tensor([d[1:] for d in out_dims])
    m, n = dims[t[:, 1], 0], dims[t[:, 1], 1]
    thin = t[:, 0] == 0
    tile = torch.tensor([(0, 0)] + [gg.class_tile(c) for c in range(1, 10)])
    # rows x columns of the output a task covers
    rows = torch.minimum(tile[t[:, 0], 0], m - t[:, 3])
    cols = torch.minimum(tile[t[:, 0], 1], n - t[:, 4])
    elems = torch.minimum(torch.full_like(m, gg.THIN_TILE), m * n - t[:, 3])
    rows = torch.where(thin, (elems + n - 1) // n, rows)
    cols = torch.where(thin, n, cols)
    reads = int(((rows + cols) * k_sum).sum()) * a_bufs[0].element_size()
    # block tiles run whole, each entry's k rounded up to the chunk of 8
    k8_pre = torch.cat([k.new_zeros(1), torch.cumsum((k + 7) // 8 * 8, 0)])
    k_pad = k8_pre[t[:, 6]] - k8_pre[t[:, 5]]
    area = tile[t[:, 0], 0] * tile[t[:, 0], 1]
    executed = per_mac * int(torch.where(thin, elems * k_sum,
                                         area * k_pad).sum())
    up = lambda x, q: -(-x // q) * q
    fixed = sum(per_mac * rows_g.numel() * up(out_dims[so][1], 64)
                * up(out_dims[so][2], 64) * up(k, 16)
                for so, _, _, k, rows_g, _, _ in groups)
    return reads, executed, fixed


def bound_ms(nbytes, flops, compute):
    """The card's least time for the work (ms) and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[compute] * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


MATVEC_STEPS = ['LP.theta over vR/vL', '.W0 over (wR,p0)', '.W1 over (wR,p1)',
                '.RP over (wR,vR)']


def to_cpu(p):
    """A CPU copy of a PackedArray."""
    return pk.PackedArray(p.legs, p.qtotal, p.get_leg_labels(), p.shapes,
                          p.qdatas, [d.cpu() for d in p.data], p.dtype,
                          'cpu')


def recorded_calls(fn):
    """``fn()`` and the arguments of every ``packed_contract`` call it
    made, in order."""
    calls = []
    orig = pk.packed_contract

    def recording(*args):
        calls.append(args)
        return orig(*args)

    pk.packed_contract = recording
    try:
        out = fn()
    finally:
        pk.packed_contract = orig
    torch.cuda.synchronize()
    return out, calls


def measure_contractions(calls, steps, tag, what='matvec'):
    """For each recorded ``packed_contract`` call (its arguments) of one
    ``what``: the kernel against its plain version, the kernel's time (also
    with its tasks shuffled), the plain version's, the library's and the
    bound; returns their sums over the calls and the largest error."""
    # per tensordot: the kernel against the plain version, its time, the
    # library's (one torch.bmm per bucket pair on operands gathered
    # beforehand: the same multiply-adds without gather or sum) and the bound
    tot = {'ms': 0., 'plain_ms': 0., 'library_ms': 0., 'bytes': 0,
           'flops': 0, 'executed': 0, 'fixed': 0, 'max_abs': 0.}
    per_class = {}
    for step, args in zip(steps, calls):
        a_bufs, b_bufs, tables, compute = args
        out_dims, tasks = tables.out_dims, tables.tasks
        groups = gg.table_groups(tables)
        k_out = gg.packed_contract(*args)
        p_out = gg.packed_contract_plain(*args)
        torch.cuda.synchronize()
        abs_e, rel_e = outs_err(k_out, p_out)
        check(rel_e <= TOL[compute], f"kernel disagrees at {step}: {rel_e}")
        ms = cuda_ms(lambda: gg.packed_contract(*args))
        plain_ms = cuda_ms(lambda: gg.packed_contract_plain(*args), reps=5)
        gathered = [(a_bufs[ab].reshape(-1, out_dims[so][1], k)[ia],
                     b_bufs[bb].reshape(-1, k, out_dims[so][2])[ib])
                    for so, ab, bb, k, _, ia, ib in groups]
        library_ms = cuda_ms(lambda: [torch.bmm(A, B) for A, B in gathered])
        del gathered
        # the same tasks in a random order: what the schedule's locality in
        # L2 is worth (each output tile has one writer, so the same bits)
        perm = torch.randperm(tasks.shape[0], generator=torch.Generator(
            ).manual_seed(0)).to(tasks.device)
        shuffled = tables._replace(tasks=tasks[perm].contiguous())
        sh_args = (a_bufs, b_bufs, shuffled, compute)
        check(all(torch.equal(x, y) for x, y in
                  zip(gg.packed_contract(*sh_args), k_out)),
              f"task order changed the result at {step}")
        shuffled_ms = cuda_ms(lambda: gg.packed_contract(*sh_args))
        nbytes, flops = contract_cost(args, groups)
        reads, executed, fixed = schedule_stats(args, groups)
        b_ms, b_by = bound_ms(nbytes, flops, compute)
        classes = sorted(set(tasks[:, 0].tolist()))
        cls = ('thin' if tables.thin else
               'block' if 0 not in classes else 'mixed')
        c = per_class.setdefault(cls, [0., 0, 0])
        c[0] += ms
        c[1] += nbytes
        c[2] += flops
        log(f"[{tag}] {step}: {cls} classes {classes}, {len(groups)} bucket "
            f"pairs, {tables.entries.shape[0]} entries, {tasks.shape[0]} "
            f"tasks; "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP; the tasks "
            f"read {reads / 1e6:.1f} MB of operands and execute "
            f"{executed / 1e9:.3f} GFLOP (a fixed 64x64x16 tile: "
            f"{fixed / 1e9:.2f} GFLOP); kernel "
            f"{ms:.4f} ms ({shuffled_ms:.4f} ms with its tasks shuffled), "
            f"plain {plain_ms:.3f} ms, library {library_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of bound; "
            f"rel_err {rel_e:.2e}")
        tot['ms'] += ms
        tot['plain_ms'] += plain_ms
        tot['library_ms'] += library_ms
        tot['bytes'] += nbytes
        tot['flops'] += flops
        tot['executed'] += executed
        tot['fixed'] += fixed
        tot['max_abs'] = max(tot['max_abs'], abs_e)
    tot['bound_ms'], tot['bound_by'] = bound_ms(tot['bytes'], tot['flops'],
                                                calls[0][3])
    for cls, (ms, nbytes, flops) in sorted(per_class.items()):
        log(f"[{tag}] {cls} class: {ms:.4f} ms per {what}, "
            f"{nbytes / ms / 1e6:.1f} GB/s, {flops / ms / 1e9:.3f} TFLOP/s")
    log(f"[{tag}] {what} total: kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.3f} ms, library {tot['library_ms']:.4f} ms, "
        f"bound {tot['bound_ms']:.4f} ms ({tot['bound_by']}; "
        f"{tot['bytes'] / 1e6:.1f} MB, {tot['flops'] / 1e9:.3f} GFLOP), "
        f"{100 * tot['bound_ms'] / tot['ms']:.1f}% of bound; kernel vs plain "
        f"max_abs_err {tot['max_abs']:.2e}")
    log(f"[{tag}] executed/useful FLOPs per {what}: the class tiles "
        f"{tot['executed'] / tot['flops']:.2f}x, a fixed 64x64x16 tile "
        f"{tot['fixed'] / tot['flops']:.1f}x")

    return tot


def phase_matvec(eng_c, tag=4, options=OPTIONS):
    """The matvec at ``options['chi_max']`` on an engine of the main path
    (read only) and on a CPU copy of its operands: the kernel per
    tensordot against its plain version, its time, the library's and the
    bound; logged under phase ``tag``."""
    ops_c = (eng_c.LPp[0], eng_c.RPp[1], eng_c.Wp[0], eng_c.Wp[1],
             eng_c.Bp[0], eng_c.Bp[1], eng_c.Sp[0])
    ops_h = [to_cpu(x) for x in ops_c[:-1]] + [ops_c[-1].cpu()]
    W0, W1, th = [], [], []
    for LP, RP, Wa, Wb, B0, B1, S0 in (ops_c, ops_h):
        W0.append(Wa.replace_labels(['p', 'p*'], ['p0', 'p0*']))
        W1.append(Wb.replace_labels(['p', 'p*'], ['p1', 'p1*']))
        C = ps.scale_bond(B0, S0, ps.scale_bond_plan(B0, 'vL'))
        th.append(pk.tensordot(C.replace_labels(['p'], ['p0']),
                               B1.replace_labels(['p'], ['p1']),
                               axes=(['vR'], ['vL'])))
    # record the kernel wrapper's calls of one matvec (one per tensordot)
    n0 = gg.LAUNCHES
    out_c, calls = recorded_calls(lambda: _matvec_2site_packed(
        ops_c[0], ops_c[1], W0[0], W1[0], th[0]))
    grew = gg.LAUNCHES - n0
    t0 = time.time()
    out_h = _matvec_2site_packed(ops_h[0], ops_h[1], W0[1], W1[1], th[1])
    cpu_s = time.time() - t0
    err = packed_rel_err(out_c, out_h)
    log(f"[{tag}] chi={options['chi_max']} matvec CUDA vs CPU: rel_err "
        f"{err:.2e} ({grew} kernel launches for {len(calls)} tensordots; "
        f"CPU matvec {cpu_s:.2f} s)")
    check(len(calls) == 4 and grew == 4 and err <= 1e-12,
          "packed matvec parity or launch count failed")
    for x in out_c.data:
        check(torch.isfinite(x).all(), "non-finite matvec output")

    tot = measure_contractions(calls, MATVEC_STEPS, tag)

    # batched SVD of the split (cuSOLVER via torch.linalg.svd)
    plan = ps.split_plan(th[0], eng_c._bond(1), eng_c.qtotal_site[0])
    tb = plan.tables(torch.device('cuda'))
    flat = torch.cat([d.reshape(-1) for d in th[0].data]
                     + [th[0].data[0].new_zeros(1)])
    Ms = [flat[gidx].reshape(g.N, g.R, g.C)
          for g, (gidx, _) in zip(plan.groups, tb['groups'])]
    svd_ms = cuda_ms(lambda: [torch.linalg.svd(M, full_matrices=False)
                              for M in Ms], reps=5)
    split_ms = cuda_ms(lambda: ps.split_truncate(
        th[0], plan, options['chi_max'], options['svd_min'], 'svd',
        expand=True), reps=5)
    S_dev = torch.cat([torch.linalg.svd(M, full_matrices=False)[1].reshape(-1)
                       for M in Ms]).cpu()
    S_cpu = torch.cat([torch.linalg.svdvals(M.cpu()).reshape(-1)
                       for M in Ms])
    svd_err = float((S_dev - S_cpu).abs().max() / S_cpu.max())
    log(f"[{tag}] split: {len(Ms)} SVD groups (N,R,C) "
        f"{[(g.N, g.R, g.C) for g in plan.groups]}")
    log(f"[{tag}] batched SVD {svd_ms:.2f} ms per update, whole split "
        f"{split_ms:.2f} ms; singular values vs CPU rel_err {svd_err:.2e}")
    check(svd_err < 1e-12, "cuSOLVER singular values disagree with LAPACK")
    return tot


def phase_setup(flat):
    """The main path's engine: the port's model, the MPS of the exchange
    file, ``DeviceSweepEngine(psi, model, OPTIONS, 'cuda')``; returns it
    with the host seconds of the model and of the MPS."""
    t0 = time.time()
    model = FermiHubbardModel(dict(MODEL))
    t1 = time.time()
    psi = exchange.load_mps(flat, model.lat.mps_sites())
    t2 = time.time()
    eng = DeviceSweepEngine(psi, model, OPTIONS, 'cuda')
    t3 = time.time()
    log(f"[5] host setup: model and MPO {t1 - t0:.3f} s, MPS {t2 - t1:.3f} s, "
        f"engine {t3 - t2:.3f} s ("
        + ', '.join(f'{k} {v:.3f} s' for k, v in eng.setup_seconds.items())
        + f"); bonds chi {psi.chi}, layout {eng.bond[0].block_number} "
        f"sectors, capacity {int(eng.bond[0].slices[-1])}")
    return eng


def check_setup(eng, state):
    """The engine's MPO, gauge and environments against the JAX values of
    the exchange file."""
    check(eng.gauge is not None
          and np.array_equal(eng.gauge['k'], state.gauge['k'])
          and all(np.array_equal(a, b)
                  for a, b in zip(eng.gauge['o'], state.gauge['o'])),
          "charge gauge differs from JAX's")
    w_err = 0.
    for i in range(eng.L):
        p, q = eng.Wp[i], pk.pack(state.W[i], pad=False, device='cpu')
        check(p.shapes == q.shapes and p.qtotal == q.qtotal
              and all(np.array_equal(x, y)
                      for x, y in zip(p.qdatas, q.qdatas)),
              f"W[{i}] structure differs from JAX's")
        w_err = max(w_err, packed_rel_err(p, q))
    envs = [(eng.LPp[0], eng._pack_env(state.LP0, 0, 'L'))] + [
        (eng.RPp[i], eng._pack_env(state.RP[i], (i + 1) % eng.L, 'R'))
        for i in range(eng.L)]
    env_err = 0.
    for p, q in envs:
        check(p.shapes == q.shapes, "environment layout differs")
        scale = max(float(d.abs().max()) for d in q.data)
        env_err = max(env_err, max(float((x.cpu() - y.cpu()).abs().max())
                                   for x, y in zip(p.data, q.data)) / scale)
    log(f"[5] setup vs JAX: gauge k={[int(k) for k in eng.gauge['k']]} "
        f"and o equal, W "
        f"rel_err {w_err:.2e}, LP0/RP max rel_err {env_err:.2e}")
    check(w_err <= 1e-14, "W differs from JAX's")
    check(env_err <= ENV_TOL, "environments differ from JAX's")


def counted_contract():
    """Counts the tensordots run on the card (calls of ``packed_contract``
    with work); returns ``(count, restore)``."""
    orig = pk.packed_contract
    n = [0]

    def counted(*args):
        if args[2].tasks.shape[0] and args[0][0].is_cuda:
            n[0] += 1
        return orig(*args)

    pk.packed_contract = counted
    return n, lambda: setattr(pk, 'packed_contract', orig)


def counting():
    """Count the tensordots run on the card (calls of ``packed_contract``
    with work) and the kernel launches per sweep, for every engine; returns
    ``(per_sweep, restore)``."""
    per_sweep = []
    orig_sweep = DeviceSweepEngine.sweep
    n_calls, restore_contract = counted_contract()

    def counted_sweep(self):
        n0, c0 = gg.LAUNCHES, n_calls[0]
        out = orig_sweep(self)
        per_sweep.append((gg.LAUNCHES - n0, n_calls[0] - c0,
                          torch.cuda.max_memory_allocated()))
        return out

    def restore():
        DeviceSweepEngine.sweep = orig_sweep
        restore_contract()

    DeviceSweepEngine.sweep = counted_sweep
    return per_sweep, restore


def phase_main(eng, ref):
    torch.cuda.reset_peak_memory_stats()
    per_sweep, restore = counting()
    gg.LAUNCHES = 0                    # count the main path's launches only
    try:
        t0 = time.time()
        E, psi = eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        restore()
    launches = gg.LAUNCHES
    st = eng.sweep_stats
    check(psi is eng.psi and E == st['E'][-1],
          "run() did not return (E, the caller's MPS)")
    for i in range(len(st['E'])):
        log(f"[5] sweep {i + 1} ({st['mode'][i]}): {st['time'][i]:.2f} s "
            f"E={st['E'][i]:.12f} max_err={st['max_err'][i]:.3e} "
            f"lanczos_iters={sum(st['lanczos_iters'][i])} "
            f"flops_exec={st['flops_exec'][i]:.4e} "
            f"launches={per_sweep[i][0]} tensordots={per_sweep[i][1]} "
            f"max_memory_allocated={per_sweep[i][2] / 2**30:.3f} GiB")
    log(f"[5] run() wall {wall:.2f} s (sweeps {sum(st['time']):.2f} s, "
        f"then the write-back), kernel launches {launches}")
    check(launches > 0, "the main path never launched the kernel")
    check(all(n == c for n, c, _ in per_sweep),
          "kernel launches per sweep differ from the tensordots run")
    check(np.isfinite(st['E']).all() and np.isfinite(st['max_err']).all(),
          "non-finite sweep energy or truncation error")
    for i, d in enumerate(eng.Sp):
        check(torch.isfinite(d).all(), f"non-finite S on bond {i}")

    n_ref = len(ref['sweep_E'])
    for i in range(n_ref):
        d = np.asarray(st['update_E0'][i]) - ref['update_E0'][i]
        log(f"[5] sweep {i + 1} per-update E0 - JAX: "
            + ' '.join(f'{x:+.2e}' for x in d))
    e0, e0_ref = st['update_E0'][0][0], float(ref['update_E0'][0][0])
    rel0 = abs(e0 - e0_ref) / abs(e0_ref)
    log(f"[5] first update E0 {e0:.12f} vs JAX {e0_ref:.12f}: rel {rel0:.2e}")
    check(rel0 <= 1e-10, "first update disagrees with JAX")
    for i in range(n_ref):
        rel = abs(st['E'][i] - ref['sweep_E'][i]) / abs(ref['sweep_E'][i])
        log(f"[5] sweep {i + 1} E {st['E'][i]:.12f} vs JAX "
            f"{ref['sweep_E'][i]:.12f}: rel {rel:.2e}")
        check(rel <= 1e-6, f"sweep {i + 1} energy disagrees with JAX")
    return launches


def measure(psi, H, ops):
    """What a user measures on a written-back iMPS, with the host seconds
    of each: the TM energy per site, the entanglement entropies, the local
    operators ``ops`` per site (their real parts), the correlation length
    (as ``correlation_length()`` gives it, and with its Arnoldi converged)
    and ``norm_test``."""
    out, sec = {}, {}
    local = [(op, lambda op=op: np.real(psi.expectation_value(op)))
             for op in ops]
    for key, fn in [('tm_E', lambda: float(H.expectation_value(psi))),
                    ('entropy', psi.entanglement_entropy), *local,
                    ('xi', psi.correlation_length),
                    ('xi_converged', lambda: psi.correlation_length(
                        N_min=XI_STEPS, N_max=XI_STEPS)),
                    ('norm_test', lambda: float(np.max(psi.norm_test())))]:
        t = time.time()
        out[key] = fn()
        sec[key] = time.time() - t
    return out, sec


def check_written_back(eng, sites, tag, cell=(('Ntot', CELL_N),
                                               ('Sz', 0.))):
    """The engine wrote its state into the caller's MPS: the caller's Site
    objects and charge frame, re-gauged; logs the write-back's seconds and
    ``norm_test``, measures the state and checks the cell's charges
    (``cell``: the local operators and their totals over the unit cell).
    Returns the measurements."""
    psi, st = eng.psi, eng.write_back_stats
    log(f"[{tag}] write-back: move to the host and gauge inversion "
        f"{st['unpack_s']:.3f} s, canonical_form "
        f"{st.get('canonical_form_s', 0.):.3f} s; norm_test before "
        f"{st['norm_test_before']:.3e}, after {st['norm_test_after']:.3e}")
    check(all(a is b for a, b in zip(psi.sites, sites)),
          "the caller's Site objects were not restored")
    for i, site in enumerate(sites):
        p = psi.get_B(i, None).get_leg('p')
        check(np.array_equal(p.charges, site.leg.charges)
              and p.qconj == site.leg.qconj,
              f"site {i}: the physical leg is not in the caller's frame")
    got, sec = measure(psi, eng.model.H_MPO, [op for op, _ in cell])
    log(f"[{tag}] measurements: TM energy {sec['tm_E']:.3f} s, entropies "
        f"{sec['entropy']:.4f} s, "
        + ', '.join(f'{op} {sec[op]:.4f} s' for op, _ in cell)
        + f", correlation length {sec['xi']:.3f} s (converged "
        f"{sec['xi_converged']:.3f} s), norm_test {sec['norm_test']:.3f} s")
    totals = {op: float(np.sum(got[op])) for op, _ in cell}
    log(f"[{tag}] TM energy per site {got['tm_E']!r}, correlation length "
        f"{got['xi']!r} (converged {got['xi_converged']!r}: rel "
        f"{abs(got['xi'] - got['xi_converged']) / got['xi_converged']:.2e})"
        f", entropies "
        + ' '.join(f'{x:.10f}' for x in got['entropy'])
        + '; cell ' + ', '.join(f'{op} {totals[op]!r}' for op, _ in cell)
        + f", bonds chi {psi.chi}")
    check(got['norm_test'] <= 1e-10 and st['norm_test_after'] <= 1e-10,
          "the written-back state is not canonical")
    check(all(abs(totals[op] - q) <= CELL_TOL for op, q in cell),
          "the cell's total charges moved")
    check(all(np.isfinite(got[k]).all() for k in got),
          "non-finite measurement")
    return got


def phase_write_back(eng, sites, wb):
    """Phase 5's write-back held to the JAX package's of the same run."""
    got = check_written_back(eng, sites, 5)
    psi = eng.psi
    log(f"[5] JAX write-back: norm_test before "
        f"{float(wb['norm_test_before'][0]):.3e}, after "
        f"{float(wb['norm_test_after']):.3e}, canonical_form "
        f"{float(wb['canonical_form_s'][0]):.3f} s (CPU); rescue log: "
        f"{str(wb['cf_log'][0])!r}")
    for i, (e, e_ref) in enumerate(zip(eng.sweep_stats['E'],
                                       wb['sweep_E'])):
        rel = abs(e - e_ref) / abs(e_ref)
        log(f"[5] sweep {i + 1} E {e:.12f} vs JAX's write-back run "
            f"{e_ref:.12f}: rel {rel:.2e}")
        check(rel <= 1e-6, f"sweep {i + 1} energy disagrees with JAX")
    errs = {'S': 0., 'entropy': float(np.abs(got['entropy']
                                              - wb['entropy']).max()),
            'tm_E': abs(got['tm_E'] - float(wb['tm_E']))
            / abs(float(wb['tm_E'])),
            'xi': abs(got['xi'] - float(wb['xi'])) / float(wb['xi'])}
    for i in range(psi.L):
        S = np.sort(np.asarray(psi.get_SL(i)))[::-1]
        ref = wb[f'S.{i}']
        check(len(S) == len(ref), f"bond {i}: {len(S)} Schmidt values, "
              f"JAX {len(ref)}")
        errs['S'] = max(errs['S'], float(np.abs(S - ref).max()))
    log(f"[5] write-back vs JAX: Schmidt values max abs "
        f"{errs['S']:.2e}, TM energy rel {errs['tm_E']:.2e} "
        f"({got['tm_E']!r} vs {float(wb['tm_E'])!r}), entropies max abs "
        f"{errs['entropy']:.2e}, correlation length rel {errs['xi']:.2e} "
        f"({got['xi']!r} vs {float(wb['xi'])!r}), Ntot max abs "
        f"{float(np.abs(got['Ntot'] - wb['Ntot']).max()):.2e}, Sz max abs "
        f"{float(np.abs(got['Sz'] - wb['Sz']).max()):.2e}")
    for k, tol in WB_TOL.items():
        check(errs[k] <= tol, f"write-back {k} differs from JAX's: "
              f"{errs[k]:.2e} > {tol:.0e}")


def phase_ramp():
    """``device_ramp`` from the Neel product state to chi=256."""
    model = FermiHubbardModel(dict(MODEL))
    psi = MPS.from_product_state(model.lat.mps_sites(), NEEL, bc='infinite')
    n_sites = 2 * model.lat.N_sites          # sites added per iDMRG sweep
    sites = list(psi.sites)
    per_sweep, restore = counting()
    write_backs = []
    orig_write_back = DeviceSweepEngine.write_back

    def counted_write_back(self):
        write_backs.append(self)
        return orig_write_back(self)

    DeviceSweepEngine.write_back = counted_write_back
    gg.LAUNCHES = 0                    # count the ramp's launches only
    try:
        t0 = time.time()
        eng = device_ramp(psi, model, dict(RAMP_OPTIONS), device='cuda')
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        restore()
        DeviceSweepEngine.write_back = orig_write_back
    launches = gg.LAUNCHES
    st = eng.sweep_stats
    check(len(per_sweep) == len(st['E']), "sweeps counted twice or missed")
    e_site = {}
    for k, stage in enumerate(eng.stages):
        sw = range(stage['first_sweep'],
                   stage['first_sweep'] + stage['n_sweeps'])
        t = [st['time'][i] for i in sw]
        its = [sum(st['lanczos_iters'][i]) for i in sw]
        lau = [per_sweep[i][0] for i in sw]
        tds = [per_sweep[i][1] for i in sw]
        E = [st['E'][i] for i in sw]
        e_site[stage['chi']] = ((E[-1] - E[-2]) / n_sites if len(E) > 1
                                else float('nan'))
        log(f"[6] stage {k + 1} chi={stage['chi']}: {len(t)} sweeps, "
            f"s/sweep " + ' '.join(f'{x:.2f}' for x in t)
            + f", lanczos_iters {its}, launches {lau} (tensordots {tds}), "
            f"setup {stage['setup_s']:.3f} s"
            + (' (from_engine)' if k else ' (engine from the product state)')
            + f", E " + ' '.join(f'{x:.10f}' for x in E)
            + f", energy per site {e_site[stage['chi']]:.10f}, max_err "
            f"{max(st['max_err'][i] for i in sw):.2e}")
        check(all(n == c for n, c in zip(lau, tds)),
              f"stage {k + 1}: kernel launches differ from the tensordots")
    kept = [int((S > 0).sum()) for S in eng.Sp]
    chis = sorted(e_site)
    e_fin, e_prev = e_site[chis[-1]], e_site[chis[-2]]
    gap = abs(e_fin - e_prev)
    log(f"[6] device_ramp wall {wall:.2f} s, {len(st['E'])} sweeps, kernel "
        f"launches {launches}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; kept Schmidt "
        f"values per bond {kept}")
    log(f"[6] energy per site at chi={chis[-1]}: {e_fin:.10f}, committed "
        f"chi=256 state {E_SITE_REF}: diff {e_fin - E_SITE_REF:+.3e} "
        f"(tolerance {E_SITE_TOL:.1e}); chi={chis[-2]} -> {chis[-1]} gap "
        f"{gap:.3e}")
    check(launches > 0, "the ramp never launched the kernel")
    check(np.isfinite(st['E']).all() and
          all(torch.isfinite(S).all() for S in eng.Sp),
          "non-finite ramp energy or Schmidt values")
    check(min(kept) >= int(0.9 * RAMP_OPTIONS['chi_max']),
          f"a bond kept fewer than 0.9 chi_max Schmidt values: {kept}")
    check(abs(e_fin - E_SITE_REF) <= E_SITE_TOL,
          "ramp energy per site far from the committed state's")
    check(E_SITE_TOL < gap, "the tolerance does not resolve chi=128 -> 256")
    check(len(write_backs) == 1 and write_backs[0] is eng
          and eng.psi is psi, "the ramp did not write back once, at its "
          "last stage, into the caller's MPS")
    got = check_written_back(eng, sites, 6)
    d = got['tm_E'] - e_fin
    log(f"[6] TM energy of the written-back state {got['tm_E']:.10f}, the "
        f"ramp's sweep estimate {e_fin:.10f}: diff {d:+.3e} (tolerance "
        f"{E_SITE_TOL:.1e})")
    check(abs(d) <= E_SITE_TOL,
          "TM energy of the written-back ramp state far from its sweeps'")


def phase_hofstadter(hof):
    """The complex path: ``device_ramp`` of the Hofstadter cylinder to
    chi=128 from the product state at 1/3 filling, its write-back and
    measurements, held to JAX's run of the same protocol; then the
    complex128 kernel on that engine's chi=128 matvec.  Returns the ramp's
    kernel launches and the matvec's kernel numbers."""
    t0 = time.time()
    model = HofstadterFermions(dict(HOF_MODEL))
    psi = MPS.from_product_state(model.lat.mps_sites(), HOF_INIT,
                                 bc='infinite')
    L = model.lat.N_sites
    log(f"[7] HofstadterFermions {HOF_MODEL}: L={L}, H_MPO "
        f"{model.H_MPO.dtype}, MPO bond dims {model.H_MPO.chi}; model and "
        f"state {time.time() - t0:.3f} s")
    check(model.H_MPO.dtype == torch.complex128, "the MPO is not complex")
    sites = list(psi.sites)
    per_sweep, restore = counting()
    gg.LAUNCHES = 0                    # count the complex path's launches
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.time()
        eng = device_ramp(psi, model, dict(HOF_OPTIONS), device='cuda')
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        restore()
    launches = gg.LAUNCHES
    st = eng.sweep_stats
    log(f"[7] charge gauge: unit-cell charge 3 on {L} sites, charge units "
        f"rescaled by k={[int(k) for k in eng.gauge['k']]}; layout "
        f"{eng.bond[0].block_number} sectors, capacity "
        f"{int(eng.bond[0].slices[-1])}; state {eng.Bp[0].dtype}, W "
        f"{eng.Wp[1].dtype}")
    check(list(eng.gauge['k']) == [3] and eng.Bp[0].dtype == torch.complex128,
          "the run did not take the rescaled gauge on complex128 buffers")
    check(len(per_sweep) == len(st['E']), "sweeps counted twice or missed")
    e_site = {}
    for k, stage in enumerate(eng.stages):
        sw = range(stage['first_sweep'],
                   stage['first_sweep'] + stage['n_sweeps'])
        lau = [per_sweep[i][0] for i in sw]
        tds = [per_sweep[i][1] for i in sw]
        E = [st['E'][i] for i in sw]
        e_site[stage['chi']] = (E[-1] - E[-2]) / (2 * L)
        log(f"[7] stage {k + 1} chi={stage['chi']}: s/sweep "
            + ' '.join(f"{st['time'][i]:.2f}" for i in sw)
            + f", lanczos_iters {[sum(st['lanczos_iters'][i]) for i in sw]}"
            f", launches {lau} (tensordots {tds}), setup "
            f"{stage['setup_s']:.3f} s, E "
            + ' '.join(f'{x:.10f}' for x in E)
            + f", energy per site {e_site[stage['chi']]:.10f}, max_err "
            f"{max(st['max_err'][i] for i in sw):.2e}")
        check(all(n == c for n, c in zip(lau, tds)),
              f"stage {k + 1}: kernel launches differ from the tensordots")
    log(f"[7] device_ramp wall {wall:.2f} s ({sum(st['time']):.2f} s of "
        f"sweeps), {len(st['E'])} sweeps, kernel launches {launches}, "
        f"tensordots {sum(c for _, c, _ in per_sweep)}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(launches > 0, "the complex path never launched the kernel")
    check(np.isfinite(st['E']).all() and
          all(torch.isfinite(S).all() for S in eng.Sp),
          "non-finite energy or Schmidt values")

    e0, e0_ref = st['update_E0'][0][0], float(hof['update_E0'][0])
    rel0 = abs(e0 - e0_ref) / abs(e0_ref)
    log(f"[7] first update E0 {e0:.12f} vs JAX {e0_ref:.12f}: rel {rel0:.2e}")
    check(rel0 <= 1e-10, "first update disagrees with JAX")
    ref_E = hof['sweep_E']
    n = min(len(ref_E), len(st['E']))
    d_E = np.abs(np.asarray(st['E'][:n]) - ref_E[:n]) / np.abs(ref_E[:n])
    log(f"[7] sweep energies vs JAX's run (rel; {len(st['E'])} and "
        f"{len(ref_E)} sweeps): " + ' '.join(f'{x:.1e}' for x in d_E))
    e_fin = e_site[HOF_OPTIONS['chi_max']]
    e_ref = float(ref_E[-1] - ref_E[-2]) / (2 * L)
    log(f"[7] energy per site at chi={HOF_OPTIONS['chi_max']}: {e_fin!r}, "
        f"JAX's run {e_ref!r}: diff {e_fin - e_ref:+.3e} (tolerance "
        f"{HOF_E_TOL:.0e}); the TPU's conserve=None run {HOF_E_TPU}: diff "
        f"{e_fin - HOF_E_TPU:+.3e} (not a gate)")
    check(abs(e_fin - e_ref) <= HOF_E_TOL,
          "energy per site differs from JAX's run of the same protocol")

    got = check_written_back(eng, sites, 7, cell=(('N', HOF_CELL_N),))
    psi = eng.psi
    imag = max(float(b.imag.abs().max()) for B in psi._B for b in B._data)
    n_err = abs(float(np.sum(got['N'])) - HOF_CELL_N)
    log(f"[7] written-back state {psi.dtype}, largest imaginary part "
        f"{imag:.3e}; N per cell - 3: {n_err:.1e}; JAX's write-back: TM "
        f"energy {float(hof['tm_E'])!r} (diff "
        f"{got['tm_E'] - float(hof['tm_E']):+.3e}), "
        f"correlation length {float(hof['xi'])!r}, entropies max abs diff "
        f"{float(np.abs(got['entropy'] - hof['entropy']).max()):.2e}, N "
        f"max abs diff {float(np.abs(got['N'] - hof['N']).max()):.2e}; "
        f"TM energy - sweep estimate {got['tm_E'] - e_fin:+.3e}")
    check(psi.dtype == torch.complex128 and imag > 1e-3,
          "the written-back state is not genuinely complex")
    check(eng.write_back_stats['norm_test_after'] <= 1e-12,
          "norm_test after the re-gauge above 1e-12")
    check(n_err <= 1e-12, "N per cell is not 3")
    check(abs(got['tm_E'] - e_fin) <= 1e-4,
          "TM energy of the written-back state far from its sweeps'")
    mv = phase_matvec(eng, 7, HOF_OPTIONS)
    return launches, mv, (psi, model, e_fin)


def sector_fill(eng):
    """The fullest charge sector of a TEBD engine's bonds: ``(kept,
    capacity)`` of the sector with the largest ratio, and whether any
    sector holds as many Schmidt values as its capacity."""
    worst, full = (0, 1), False
    for i, S in enumerate(eng.Sp):
        bond, kept = eng._bond(i), (S > 0).cpu().numpy()
        for s in range(bond.block_number):
            lo, hi = int(bond.slices[s]), int(bond.slices[s + 1])
            n = int(kept[lo:hi].sum())
            full |= n == hi - lo
            if n * worst[1] > worst[0] * (hi - lo):
                worst = (n, hi - lo)
    return worst, full


def check_tebd_state(psi, tag, what):
    """The conserved quantities of a written-back TEBD state: Sz per cell
    at 0 (U(1) charge) and every bond's sum of S^2 at 1 (unitarity);
    returns them."""
    sz = float(np.sum(np.real(psi.expectation_value('Sz'))))
    norms = [float(np.sum(np.asarray(psi.get_SL(i)) ** 2))
             for i in range(psi.L)]
    dn = max(abs(n - 1.) for n in norms)
    log(f"[{tag}] {what}: Sz per cell {sz:+.2e}, max |sum S^2 - 1| "
        f"{dn:.2e}, chi {psi.chi}, norm_test {np.max(psi.norm_test()):.2e}")
    check(abs(sz) <= 1e-10, f"{what}: Sz per cell moved")
    check(dn <= 1e-12, f"{what}: the Schmidt values are not normalized")
    return sz, dn


def phase_tebd_ground_state():
    """The XXZ chain's Delta=1.5 ground state by ``device_ramp`` from the
    Neel state; returns the written-back MPS."""
    model = XXZChain(dict(XXZ_GS))
    psi = MPS.from_product_state(model.lat.mps_sites(), ['up', 'down'],
                                 bc='infinite')
    t0 = time.time()
    eng = device_ramp(psi, model, dict(XXZ_RAMP_OPTIONS), device='cuda')
    torch.cuda.synchronize()
    wall = time.time() - t0
    st = eng.sweep_stats
    e_sweep = (st['E'][-1] - st['E'][-2]) / (2 * model.lat.N_sites)
    e_tm = float(model.H_MPO.expectation_value(psi))
    log(f"[8] XXZ Delta=1.5 ground state: device_ramp {wall:.2f} s, "
        f"{len(st['E'])} sweeps, chi {psi.chi}, energy per site "
        f"{e_sweep:.10f} (sweeps), {e_tm:.10f} (TM), max_err "
        f"{st['max_err'][-1]:.2e}, norm_test "
        f"{eng.write_back_stats['norm_test_after']:.2e}")
    check(np.isfinite(st['E']).all() and abs(e_tm - e_sweep) <= 1e-4,
          "XXZ ground state: energy non-finite or TM far from the sweeps'")
    check(np.max(psi.norm_test()) <= 1e-10, "XXZ ground state not canonical")
    check_tebd_state(psi, 8, 'ground state')
    return psi


def phase_tebd_quench(psi, smi):
    """The quench: staged growth to chi=512 on every bond, then
    ``TEBD_TIMED_STEPS`` timed Trotter steps after a warm-up and one
    profiled step.  Returns the timed engine and the numbers to report."""
    model = XXZChain(dict(XXZ_QUENCH))
    n_td, restore = counted_contract()
    gg.LAUNCHES = 0                    # count the TEBD path's launches only
    torch.cuda.reset_peak_memory_stats()
    t_start, t_ev = time.time(), 0.
    try:
        while min(psi.chi) < TEBD_CHI:
            chi_cur = max(psi.chi)
            chi_s = min(TEBD_CHI, 2 * chi_cur)
            t0 = time.time()
            eng = DeviceTEBDEngine(psi, model, dict(
                TEBD_OPTIONS, chi_max=chi_s,
                cap_factor=TEBD_GROW * chi_s / chi_cur), 'cuda')
            t1 = time.time()
            while True:
                eng.evolve(TEBD_STAGE_STEPS)
                kept = [int((S > 0).sum()) for S in eng.Sp]
                _, full = sector_fill(eng)
                if (min(kept) >= chi_s or full
                        or eng.evolved_time >= TEBD_STAGE_T):
                    break
            t2 = time.time()
            eng.write_back()
            t_ev += eng.evolved_time
            log(f"[8] stage chi={chi_s}: capacity "
                f"{[int(b.slices[-1]) for b in eng.bond]}, engine "
                f"{t1 - t0:.2f} s, {eng.evolved_time / eng.dt:.0f} steps "
                f"{t2 - t1:.2f} s, write-back "
                f"{eng.write_back_stats['unpack_s']:.3f} + "
                f"{eng.write_back_stats.get('canonical_form_s', 0.):.3f} s; "
                f"t={t_ev:.2f}, kept {kept}, sector full {full}, trunc_err "
                f"{eng.trunc_err.eps:.2e}")
            check_tebd_state(psi, 8, f't={t_ev:.2f}')
            check(t_ev <= TEBD_T_MAX, f"chi={TEBD_CHI} not reached by "
                  f"t={TEBD_T_MAX}: chi {psi.chi}")
        grow_s = time.time() - t_start
        t0 = time.time()
        eng = DeviceTEBDEngine(psi, model, dict(
            TEBD_OPTIONS, chi_max=TEBD_CHI, cap_factor=1.2), 'cuda')
        setup_s = time.time() - t0
        eng.evolve(1)                  # warm-up: the split plans
        eng.write_back()
        E0, err0 = float(model.H_MPO.expectation_value(psi)), eng.trunc_err
        times, launches, fills = [], [], []
        for _ in range(TEBD_TIMED_STEPS):
            n0, c0 = gg.LAUNCHES, n_td[0]
            torch.cuda.synchronize()
            t0 = time.time()
            eng.evolve(1)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            launches.append((gg.LAUNCHES - n0, n_td[0] - c0))
            fills.append(sector_fill(eng))
        eng.write_back()
        E1 = float(model.H_MPO.expectation_value(psi))
        err = eng.trunc_err.eps - err0.eps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.time()
            eng.evolve(1)
            torch.cuda.synchronize()
            prof_s = time.time() - t0
    finally:
        restore()
    n_launches = gg.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    eng.write_back()
    med = statistics.median(times)
    log(f"[8] quench to chi={TEBD_CHI}: t={t_ev:.2f} in {grow_s:.1f} s; "
        f"timed engine {setup_s:.2f} s, capacity "
        f"{[int(b.slices[-1]) for b in eng.bond]}")
    log(f"[8] s per Trotter step at chi={TEBD_CHI}: "
        + ' '.join(f'{t:.4f}' for t in times) + f", median {med:.4f} s; "
        f"reference tenpy (one CPU core) {TEBD_REF_S_PER_STEP} s/step: "
        f"{TEBD_REF_S_PER_STEP / med:.2f}x; card {smi}")
    log(f"[8] kernel launches per step {[n for n, _ in launches]} "
        f"(tensordots {[c for _, c in launches]}); fullest sector per step "
        f"{[f'{k}/{c}' for (k, c), _ in fills]}; peak memory "
        f"{peak / 2**30:.3f} GiB; kernel launches on the path {n_launches}")
    check(all(n == c and n > 0 for n, c in launches),
          "kernel launches per step differ from the tensordots run")
    check(not any(full for _, full in fills),
          "a sector sat at its capacity during the timed steps")
    check(min(psi.chi) >= TEBD_CHI, f"chi {psi.chi} below {TEBD_CHI}")
    busy, svd_us, kernel_us, rows = device_time(prof)
    log(f"[8] profiled step {prof_s:.4f} s: device busy {busy / 1e6:.4f} s, "
        f"device share {100 * busy / 1e6 / prof_s:.1f}%; batched SVD "
        f"{svd_us / 1e6:.4f} s ({100 * svd_us / max(busy, 1e-9):.1f}% of the "
        f"device time), the kernel {kernel_us / 1e6:.4f} s")
    for name, us, n in rows[:8]:
        log(f"[8]   {us / 1e6:8.4f} s {n:6d} x  {name[:80]}")
    log(f"[8] Delta=1 energy per site {E0!r} before the timed steps, "
        f"{E1!r} after them: drift {E1 - E0:+.3e}, their truncation error "
        f"{err:.3e}")
    check(abs(E1 - E0) <= err + 1e-6,
          "the energy drifted beyond the truncation error")
    check_tebd_state(psi, 8, 'after the timed steps')
    return eng, n_launches, med


def device_time(prof):
    """Device busy time (us, overlaps merged) of a profile, the time of the
    SVD's and of the packed kernel's launches, and the kernels by time;
    read from the profiler's raw Kineto events, without building its event
    tree (which took a minute for the 400,000 device events of one
    purification step on the card)."""
    dev, cnt, spans = {}, {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            a, b = e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3
            dev[e.name()] = dev.get(e.name(), 0.) + b - a
            cnt[e.name()] = cnt.get(e.name(), 0) + 1
            spans.append((a, b))
    busy, end = 0., None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    svd = sum(t for k, t in dev.items()
              if any(w in k.lower() for w in ('svd', 'jacobi', 'gesvd')))
    kern = sum(t for k, t in dev.items() if 'thin_kernel' in k
               or 'packed_contract_kernel' in k)
    rows = sorted(((k, t, cnt[k]) for k, t in dev.items()),
                  key=lambda r: -r[1])
    return busy, svd, kern, rows


def phase_tebd_jax_case():
    """The committed real-time case of ``tests/test_packed_tebd.py:32``
    (infinite S=1 chain) on the card, held to JAX's engine at the CPU
    tests' tolerances."""
    ref = exchange.load_flat(TEBD_REF)
    opts = json.loads(str(ref['options']))
    params, options = opts['spin1']['real_infinite'], opts['real']
    model = SpinChain(dict(params))
    sub = {k[len('real_infinite.psi0.'):]: v for k, v in ref.items()
           if k.startswith('real_infinite.psi0.')}
    psi = exchange.load_mps(sub, model.lat.mps_sites())
    eng = DeviceTEBDEngine(psi, model, dict(options), 'cuda')
    err = eng.run()
    S_err = max(float(np.abs(np.sort(S[S > 0])[::-1]
                             - ref[f'real_infinite.S.{i}']).max())
                for i, S in enumerate(s.cpu().numpy() for s in eng.Sp))
    sz_err = float(np.abs(np.real(psi.expectation_value('Sz'))
                          - ref['real_infinite.Sz']).max())
    e_err = abs(err.eps - float(ref['real_infinite.trunc_err']))
    log(f"[8] JAX's real-time case (infinite S=1 chain, chi_max=32, 3 "
        f"steps): Schmidt values {S_err:.2e}, Sz {sz_err:.2e}, truncation "
        f"error {err.eps:.3e} vs {float(ref['real_infinite.trunc_err']):.3e}"
        f" ({e_err:.1e}), evolved time {eng.evolved_time}")
    check(eng.evolved_time == float(ref['real_infinite.evolved_time'])
          and max(S_err, sz_err, e_err) <= 1e-10,
          "the card's TEBD differs from JAX's")


def phase_tebd_kernel(eng):
    """One chi=512 complex128 bond update of the timed engine (bond 1,
    read only): its three tensordots, the kernel against its plain version,
    timed beside the plain version, the library and the bound."""
    B0, B1, S0, U = eng.Bp[0], eng.Bp[1], eng.Sp[0], eng.Up[1][1]
    plan = ps.split_plan(eng._theta_struct(B0, B1, U), eng._bond(1),
                         eng.qtotal_site[0])
    _, calls = recorded_calls(lambda: _bond_step(
        B0, B1, S0, U, plan, eng.chi_max, eng.svd_min, eng.backend))
    check(len(calls) == 3 and all(c[3] == torch.complex128 for c in calls),
          "the bond update is not three complex128 tensordots")
    tot = measure_contractions(calls, TEBD_STEPS, 8, 'bond update')
    svd_survey(eng, B0, B1, S0, U, plan)
    return tot


def svd_survey(eng, B0, B1, S0, U, plan):
    """The split's batched SVD of one bond update, as the engine runs it
    (``torch.linalg.svd``, cuSOLVER's default choice) and with each of
    cuSOLVER's algorithms, beside LAPACK on the host: times and the
    singular values' largest difference from LAPACK's (a measurement for
    the decomposition that bounds the step, not used by the engine)."""
    C = pk.tensordot(B0.replace_labels(['p'], ['p0']),
                     B1.replace_labels(['p'], ['p1']), axes=(['vR'], ['vL']))
    C = pk.tensordot(U, C, axes=(['p0*', 'p1*'], ['p0', 'p1']))
    C = C.transpose(['vL', 'p0', 'p1', 'vR'])
    th = ps.scale_bond(C, S0, ps.scale_bond_plan(C, 'vL'))
    tb = plan.tables(th.device)
    flat = torch.cat([d.reshape(-1) for d in th.data]
                     + [th.data[0].new_zeros(1)])
    Ms = [flat[gidx].reshape(g.N, g.R, g.C)
          for g, (gidx, _) in zip(plan.groups, tb['groups'])]
    Ms_h = [M.cpu() for M in Ms]
    S_ref = torch.cat([torch.linalg.svdvals(M).reshape(-1) for M in Ms_h])
    t0 = time.time()
    for M in Ms_h:
        torch.linalg.svd(M, full_matrices=False)
    host_ms = (time.time() - t0) * 1e3
    log(f"[8] split of one chi={eng.chi_max} bond update: {len(Ms)} SVD "
        f"groups (N,R,C) "
        f"{[(g.N, g.R, g.C) for g in plan.groups]}; LAPACK on the host "
        f"{host_ms:.1f} ms")
    for algo in (None, 'gesvd', 'gesvdj'):
        def run():
            return [torch.linalg.svd(M, full_matrices=False, driver=algo)
                    for M in Ms]
        ms = cuda_ms(run, reps=3)
        S = torch.cat([r[1].reshape(-1) for r in run()]).cpu()
        err = float((S - S_ref).abs().max() / S_ref.max())
        log(f"[8]   torch.linalg.svd, cuSOLVER {algo or 'default'}: "
            f"{ms:.1f} ms per update (its events bracket the SVD's host "
            f"syncs), singular values vs LAPACK {err:.1e}")

def e0_xx_finite(L, Jxx):
    """The open XX chain's ground energy at Sz = 0: the sum of the negative
    eigenvalues of the L x L free-fermion hopping matrix (Jxx / 2)."""
    t = np.diag(np.full(L - 1, Jxx / 2.), 1)
    w = np.linalg.eigvalsh(t + t.T)
    return float(np.sum(w[w < 0]))


class HostDMRGProbe:
    """Within ``with``: the host DMRG engine's parts timed per update
    (wall seconds on the host; the device route syncs inside each part),
    its sweeps with their kernel launches, the device updates' Lanczos
    steps, and the packed path's plan builds and cache hits, by wrapping
    the functions the engine calls (restored on exit)."""

    PARTS = ('ED_block', 'host Lanczos', 'pack', 'device Lanczos', 'unpack',
             'split', 'env update')

    def __init__(self, n_td):
        self.n_td = n_td
        self.parts = {k: [] for k in self.PARTS}    # (sweep, seconds)
        self.sweeps = []      # (optimize, seconds, launches, tensordots)
        self.diag_N = []      # (sweep, N of the effective H)
        self.device_N = []    # (sweep, Lanczos steps of a device update)
        self.plans = []       # (sweep, 'packed' | 'transpose', cache hit)
        self.engine = None
        self._patches = []

    def _patch(self, obj, name, make):
        own = name in vars(obj)
        orig = getattr(obj, name)
        setattr(obj, name, make(orig))
        self._patches.append((obj, name, orig, own))

    def _timed(self, key, orig):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            self.parts[key].append((self._sweep(), time.perf_counter() - t0))
            return out
        return run

    def _sweep(self):
        return self.engine.sweeps if self.engine is not None else 0

    def __enter__(self):
        probe = self
        Eng = dmrg.TwoSiteDMRGEngine

        def capture(orig):
            def run(self):
                probe.engine = self
                return orig(self)
            return run

        def sweep(orig):
            def run(self, optimize=True):
                n0, c0, t0 = gg.LAUNCHES, probe.n_td[0], time.perf_counter()
                out = orig(self, optimize)
                probe.sweeps.append((optimize, time.perf_counter() - t0,
                                     gg.LAUNCHES - n0, probe.n_td[0] - c0))
                return out
            return run

        def diag(orig):
            def run(self, theta):
                probe.diag_N.append((self.sweeps, self.eff_H.N))
                return orig(self, theta)
            return run

        def lanczos(orig):
            timed = self._timed('device Lanczos', orig)

            def run(*a, **kw):
                out = timed(*a, **kw)
                probe.device_N.append((probe._sweep(), int(out[2])))
                return out
            return run

        def plan(kind, cache, key_of):
            def make(orig):
                def run(*a):
                    probe.plans.append((probe._sweep(), kind,
                                        key_of(*a) in cache))
                    return orig(*a)
                return run
            return make

        self._patch(Eng, 'run', capture)
        self._patch(Eng, 'sweep', sweep)
        self._patch(Eng, 'diag', diag)
        self._patch(Eng, 'mixed_svd', lambda o: self._timed('split', o))
        self._patch(Eng, 'update_env', lambda o: self._timed('env update',
                                                             o))
        self._patch(dmrg, 'full_diag_effH',
                    lambda o: self._timed('ED_block', o))
        self._patch(LanczosGroundState, 'run',
                    lambda o: self._timed('host Lanczos', o))
        self._patch(pk, 'pack', lambda o: self._timed('pack', o))
        self._patch(dmrg, '_to_host', lambda o: self._timed('unpack', o))
        self._patch(pk, 'unpack', lambda o: self._timed('unpack', o))
        self._patch(mc, 'lanczos_K_2site_packed', lanczos)
        self._patch(pk, '_packed_plan', plan(
            'packed', pk._PACKED_PLAN_CACHE,
            lambda a, b, n: (a.struct_sig(), b.struct_sig(), n)))
        self._patch(pk, '_transpose_plan', plan(
            'transpose', pk._TRANSPOSE_CACHE,
            lambda sig, shapes, qdatas, perm: (sig, perm)))
        return self

    def __exit__(self, *exc):
        for obj, name, orig, own in reversed(self._patches):
            if own:
                setattr(obj, name, orig)
            else:
                delattr(obj, name)
        self._patches = []


def phase_host_dmrg(smi):
    """TeNPy's entry point on the card: ``dmrg.run`` on the open XX chain
    to chi_max=512 with the two-site eigensolves on the packed Lanczos; then
    the centre update card against host, the crossover of the two routes,
    a profiled sweep and the kernel on the centre update's matvec.
    Returns the path's kernel launches and the kernel's measurement."""
    model = XXZChain(dict(XX_MODEL))
    L = XX_MODEL['L']
    psi = MPS.from_product_state(model.lat.mps_sites(),
                                 ['up', 'down'] * (L // 2))
    E_exact = e0_xx_finite(L, XX_MODEL['Jxx'])
    n_td, restore = counted_contract()
    torch.cuda.reset_peak_memory_stats()
    log(f"[9] torch.get_num_threads() = {torch.get_num_threads()}")
    gg.LAUNCHES = 0                    # count the host DMRG's launches only
    try:
        with HostDMRGProbe(n_td) as probe:
            t0 = time.time()
            info = dmrg.run(psi, model, copy.deepcopy(XX_OPTIONS),
                            device='cuda')
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        restore()
    launches, tensordots = gg.LAUNCHES, n_td[0]
    peak = torch.cuda.max_memory_allocated()
    eng = probe.engine
    ss = eng.sweep_stats
    E = info['E']
    rel = abs(E - E_exact) / abs(E_exact)
    opt = [x for x in probe.sweeps if x[0]]
    for k, (_, sec, n, c) in enumerate(opt):
        n_dev = sum(1 for sw, _ in probe.device_N if sw == k)
        steps = sum(m for sw, m in probe.device_N if sw == k)
        plans = {(kind, hit): sum(1 for sw, kd, h in probe.plans
                                  if sw == k and kd == kind and h == hit)
                 for kind in ('packed', 'transpose') for hit in (0, 1)}
        log(f"[9] sweep {k + 1}: {sec:.2f} s, E={ss['E'][k]:.12f}, max_chi "
            f"{ss['max_chi'][k]}, max_trunc_err {ss['max_trunc_err'][k]:.2e}"
            f", {n_dev} device updates ({steps} Lanczos steps), kernel "
            f"launches {n} (tensordots {c}); tensordot plans "
            f"{plans['packed', 0]} built, {plans['packed', 1]} hits; "
            f"transpose plans {plans['transpose', 0]} built, "
            f"{plans['transpose', 1]} hits")
    log(f"[9] dmrg.run wall {wall:.2f} s, {len(opt)} sweeps, E "
        f"{E:.12f}, free fermions {E_exact:.12f}: rel {rel:.2e} (tolerance "
        f"{XX_E_TOL:.0e}); chi {max(psi.chi)}; peak memory "
        f"{peak / 2**30:.3f} GiB; card {smi}")
    last = len(opt) - 1
    for key in HostDMRGProbe.PARTS:
        t_all = [t for _, t in probe.parts[key]]
        t_last = [t for sw, t in probe.parts[key] if sw == last]
        if t_all:
            log(f"[9] {key}: {len(t_all)} calls, {sum(t_all):.2f} s in all; "
                f"last sweep {len(t_last)} calls, "
                f"{1e3 * sum(t_last) / max(len(t_last), 1):.2f} ms per call")
    log("[9] host Lanczos: not on the path (device_K sends every Lanczos "
        "update to the card); timed in the comparison and the crossover")
    n_lanczos = sum(1 for _, N in probe.diag_N if N >= 64)
    steps = sum(m for _, m in probe.device_N)
    log(f"[9] {len(probe.diag_N)} two-site updates, {n_lanczos} of them "
        f"Lanczos updates (N >= 64), {len(probe.device_N)} on the card with "
        f"{steps} Lanczos steps; kernel launches {launches}, tensordots "
        f"{tensordots}, 4 per matvec {4 * steps}")
    check(rel <= XX_E_TOL, "dmrg.run's energy is not the free-fermion one")
    check(len(probe.device_N) == n_lanczos and n_lanczos > 0
          and all(m >= 1 for _, m in probe.device_N),
          "a Lanczos update did not run the packed Lanczos on the card")
    check(all(any(sw == k for sw, _ in probe.device_N)
              for k in range(1, len(opt))),
          "a sweep after the first ran no update on the card")
    check(launches == tensordots == 4 * steps,
          "kernel launches differ from the device route's tensordots")
    norm = float(np.max(psi.norm_test()))
    sz = np.real(np.asarray(psi.expectation_value('Sz')))
    log(f"[9] norm_test {norm:.2e}; total Sz {float(np.sum(sz)):+.2e}, "
        f"max |Sz_i| {float(np.max(np.abs(sz))):.2e}")
    check(norm <= XX_NORM_TOL, "the state is not canonical")
    check(abs(float(np.sum(sz))) <= 1e-10, "total Sz is not 0")
    check(np.isfinite(ss['E']).all(), "non-finite sweep energy")

    # the centre update of the result, card against host, from one guess
    lp = eng.lanczos_params
    saved = {k: lp[k] for k in ('P_tol', 'device_K')}
    eng.i0, eng.move_right = L // 2 - 1, True
    lp['P_tol'], lp['device_K'] = 1e-14, XX_CHECK_K
    theta = eng.prepare_update_local()
    eff = eng.eff_H
    rng = np.random.default_rng(XX_CHECK_SEED)
    noise = npc.Array.from_ndarray(rng.standard_normal(theta.shape),
                                   theta.legs, qtotal=theta.qtotal,
                                   labels=theta.get_leg_labels(),
                                   warn_wrong_sector=False)
    guess = theta + noise * (XX_CHECK_NOISE * npc.norm(theta)
                             / npc.norm(noise))
    t0 = time.time()
    E_dev, th_dev, N_dev, _ = eng._diag_device_lanczos(guess)
    dev_s = time.time() - t0
    t0 = time.time()
    E_host, th_host, N_host = LanczosGroundState(
        eff, guess, {'N_max': XX_CHECK_K, 'P_tol': 1e-14}).run()
    host_s = time.time() - t0
    ov = abs(complex(npc.inner(th_dev.conj(), th_host, axes='range')))
    e_rel = abs(E_dev - E_host) / abs(E_host)
    log(f"[9] centre update (N={eff.N}, guess perturbed by "
        f"{XX_CHECK_NOISE:g}): card {E_dev:.14f} in {N_dev} steps "
        f"({dev_s:.2f} s), host {E_host:.14f} in {N_host} steps "
        f"({host_s:.2f} s): rel {e_rel:.2e}, 1 - |<dev|host>| {1 - ov:.2e}")
    check(e_rel <= XX_CHECK_E_TOL and 1. - ov <= XX_CHECK_OV_TOL,
          "the card's Lanczos disagrees with the host's")

    # the crossover: XX_CROSS_K fixed steps on both routes, by N
    lp['P_tol'], lp['device_K'] = 0., XX_CROSS_K
    log(f"[9] crossover ({XX_CROSS_K} Lanczos steps each; the card's first "
        f"call packs the environments and builds the plans, as every "
        f"update of a sweep does; its second reuses both; the table "
        f"{XX_CROSS_REPEATS} times):")
    worst = {}
    for rep in range(XX_CROSS_REPEATS):
        for b in XX_CROSS_BONDS:
            eng.i0 = L // 2 - 1 if b is None else b
            th = eng.prepare_update_local()
            t0 = time.time()
            LanczosGroundState(eng.eff_H, th, {'N_min': XX_CROSS_K,
                                               'N_max': XX_CROSS_K,
                                               'P_tol': 0.,
                                               'cutoff': 0.}).run()
            h_ms = 1e3 * (time.time() - t0)
            t0 = time.time()
            eng._diag_device_lanczos(th)
            cold_ms = 1e3 * (time.time() - t0)
            t0 = time.time()
            eng._diag_device_lanczos(th)
            warm_ms = 1e3 * (time.time() - t0)
            N = eng.eff_H.N
            worst[N] = max(worst.get(N, 0.), cold_ms / h_ms)
            log(f"[9]   run {rep + 1} bond {eng.i0 + 1}: N={N:8d}: host "
                f"{h_ms:9.2f} ms, card {cold_ms:9.2f} ms (first call), "
                f"{warm_ms:9.2f} ms (second): card/host "
                f"{cold_ms / h_ms:.3f}")
    wins = sorted(N for N, r in worst.items() if r < 1.)
    log(f"[9] crossover: the card's first call wins in every run at N = "
        f"{wins}; worst card/host by N "
        f"{ {N: round(r, 3) for N, r in sorted(worst.items())} }; "
        f"DEVICE_LANCZOS_THRESHOLD = {mc.DEVICE_LANCZOS_THRESHOLD}")
    for k, v in saved.items():
        lp[k] = v

    # one more sweep, profiled: the device's idle share and host syncs
    with HostDMRGProbe([0]) as p2, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        eng.sweep()
        torch.cuda.synchronize()
        prof_s = time.time() - t0
    busy, _, kernel_us, rows = device_time(prof)
    steps = sum(m for _, m in p2.device_N)
    dtoh = sum(n for name, _, n in rows if 'DtoH' in name)
    log(f"[9] profiled sweep {prof_s:.2f} s: device busy {busy / 1e6:.3f} s,"
        f" idle {100 * (1 - busy / 1e6 / prof_s):.1f}%; the kernel "
        f"{kernel_us / 1e6:.3f} s; {dtoh} device-to-host copies for "
        f"{len(p2.device_N)} device updates (one Ritz vector each) and "
        f"{steps} Lanczos steps (one (alpha, beta) read each)")
    for name, us, n in rows[:6]:
        log(f"[9]   {us / 1e6:8.4f} s {n:6d} x  {name[:80]}")

    # the kernel on the centre update's matvec
    LPp, RPp, W0p, W1p = eff._device_packed
    theta_p = pk.pack(guess, multiple=mc.BUCKET_MULTIPLE,
                      pad_labels=('vL', 'vR', 'vL*', 'vR*'),
                      device=eng.device)
    _, calls = recorded_calls(lambda: _matvec_2site_packed(
        LPp, RPp, W0p, W1p, theta_p))
    check(len(calls) == 4, "the centre matvec is not four tensordots")
    tot = measure_contractions(calls, MATVEC_STEPS, 9)
    return launches, tot


class SimulationProbe:
    """Within ``with``: per stage of a ground-state simulation (from its
    ``__enter__`` to its ``__exit__``) the wall seconds of its phases,
    kernel launches, the ``HostDMRGProbe`` records of its updates, sweeps
    and peak device memory, and the engine's end-of-run cleanup (the
    state's ``norm_test`` before it, the ``norm_tol`` that applied and
    whether it canonicalized); the simulations themselves are kept."""

    PHASES = ('init_model', 'init_state', 'init_algorithm', 'run_algorithm',
              'final_measurements', 'save_results')

    def __init__(self, probe):
        self.probe = probe
        self.stages = []
        self._patches = []

    def _marks(self):
        p = self.probe
        return {'t': time.perf_counter(), 'launches': gg.LAUNCHES,
                'diag': len(p.diag_N), 'device': len(p.device_N),
                'plans': len(p.plans), 'sweeps': len(p.sweeps)}

    def __enter__(self):
        from tenpy_tpu_torch.simulations.simulation import GroundStateSearch
        sp = self

        def patch(name, make, cls=GroundStateSearch):
            own = name in vars(cls)
            orig = getattr(cls, name)
            setattr(cls, name, make(orig))
            self._patches.append((cls, name, orig, own))

        def enter(orig):
            def run(sim):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                sp.stages.append({'sim': sim, 'start': sp._marks(),
                                  'phases': {}})
                return orig(sim)
            return run

        def exit_(orig):
            def run(sim, *exc):
                out = orig(sim, *exc)
                torch.cuda.synchronize()
                st = sp.stages[-1]
                st['end'] = sp._marks()
                st['peak'] = torch.cuda.max_memory_allocated()
                return out
            return run

        def timed(name):
            def make(orig):
                def run(sim, *a, **kw):
                    t0 = time.perf_counter()
                    out = orig(sim, *a, **kw)
                    ph = sp.stages[-1]['phases']
                    ph[name] = ph.get(name, 0.) + time.perf_counter() - t0
                    return out
                return run
            return make

        def cleanup(orig):
            def run(eng):
                norm_test = eng.psi.norm_test()
                out = orig(eng)
                norm_tol = eng.options['norm_tol']
                sp.stages[-1]['cleanup'] = {
                    'norm_before': float(np.max(norm_test)),
                    'norm_tol': norm_tol, 'canonicalized':
                        bool(np.linalg.norm(norm_test) > norm_tol)}
                return out
            return run

        patch('__enter__', enter)
        patch('__exit__', exit_)
        for name in self.PHASES:
            patch(name, timed(name))
        patch('post_run_cleanup', cleanup, dmrg.DMRGEngine)
        return self

    def __exit__(self, *exc):
        for cls, name, orig, own in reversed(self._patches):
            if own:
                setattr(cls, name, orig)
            else:
                delattr(cls, name)

    def stage_stats(self, st):
        """The stage's numbers: wall seconds, sweeps, updates (all
        two-site, on the card, at or above the threshold), Lanczos steps
        on the card, launches, plan builds and hits, peak memory."""
        p, a, b = self.probe, st['start'], st['end']
        diag = p.diag_N[a['diag']:b['diag']]
        dev = p.device_N[a['device']:b['device']]
        plans = p.plans[a['plans']:b['plans']]
        sweeps = [x for x in p.sweeps[a['sweeps']:b['sweeps']] if x[0]]
        return {
            'wall': b['t'] - a['t'], 'phases': dict(st['phases']),
            'sweeps': len(sweeps), 'sweep_s': [x[1] for x in sweeps],
            'updates': len(diag), 'device': len(dev),
            'above': sum(1 for _, N in diag
                         if N >= mc.DEVICE_LANCZOS_THRESHOLD),
            'steps': sum(m for _, m in dev),
            'launches': b['launches'] - a['launches'],
            'plans_built': sum(1 for _, _, hit in plans if not hit),
            'plan_hits': sum(1 for _, _, hit in plans if hit),
            'peak': st['peak'], 'energy': st['sim'].results.get('energy'),
        }


def sim_argv(path, overrides):
    argv = [path]
    for o in overrides:
        argv += ['-o', o]
    return argv


def sim_params(params, overrides):
    """``params`` (a copy) with the ``key=value`` overrides applied by the
    command line's own parser."""
    return tenpy_tpu_torch.apply_overrides(copy.deepcopy(params), overrides)


def run_sim_file(has_yaml, path, params, overrides):
    """The command line on ``path`` with ``overrides`` (``console_main``
    in this process), or where PyYAML is absent the same options through
    ``run_simulation`` / ``run_seq_simulations``."""
    from tenpy_tpu_torch.simulations import simulation as sim_mod
    if has_yaml:
        check(tenpy_tpu_torch.console_main(sim_argv(path, overrides)) == 0,
              f"console_main failed on {path}")
        return
    opts = sim_params(params, overrides)
    cls = opts.pop('simulation_class')
    if 'sequential' in opts:
        sim_mod.run_seq_simulations(opts.pop('sequential'),
                                    simulation_class=cls, **opts)
    else:
        sim_mod.run_simulation(simulation_class=cls, **opts)


def log_stage(tag, name, s):
    ph = s['phases']
    alg = ph.get('run_algorithm', 0.)
    rest = s['wall'] - alg
    log(f"[10{tag}] {name}: {s['wall']:.2f} s ({alg:.2f} s run_algorithm, "
        f"{rest:.2f} s besides: " + ', '.join(
            f"{k} {v:.2f}" for k, v in ph.items() if k != 'run_algorithm')
        + f"), {s['sweeps']} sweeps, s/sweep "
        + ' '.join(f"{x:.2f}" for x in s['sweep_s'])
        + f"; {s['device']} of {s['updates']} two-site updates on the card "
        f"({100. * s['device'] / max(s['updates'], 1):.1f}%; "
        f"{s['above']} with N >= {mc.DEVICE_LANCZOS_THRESHOLD}), "
        f"{s['steps']} Lanczos steps, kernel launches {s['launches']} "
        f"(4 x steps {4 * s['steps']}); plans {s['plans_built']} built, "
        f"{s['plan_hits']} hits; peak memory {s['peak'] / 2**30:.3f} GiB; "
        f"E {s['energy']!r}")


def phase_simulation(smi):
    """The simulation layer and the command line on the card: 10a the
    repo's ``minimal_DMRG.yml`` on the CPU and on the card, 10b the
    sequential chi ramp of ``sequential_chi_ramp.yml`` to chi=512 on the
    XX chain at L=64, 10c the output files and the resume; then the kernel
    on the chi=512 centre matvec.  Returns the phase's kernel launches and
    the kernel's measurement."""
    import shutil
    import tempfile
    import warnings
    from tenpy_tpu_torch.algorithms.dmrg import TwoSiteDMRGEngine
    from tenpy_tpu_torch.simulations import simulation as sim_mod
    from tenpy_tpu_torch.tools import io as tio
    try:
        import yaml  # noqa: F401
        has_yaml = True
    except ImportError:
        has_yaml = False
    try:
        import h5py  # noqa: F401
        has_h5py = True
    except ImportError:
        has_h5py = False
    log(f"[10] PyYAML imports: {has_yaml}; h5py imports: {has_h5py}; "
        f"DEVICE_LANCZOS_THRESHOLD = {mc.DEVICE_LANCZOS_THRESHOLD}")
    if not has_yaml:
        log("console_main not driven: no yaml")
    else:
        from tenpy_tpu_torch.tools.params import load_yaml_with_py_eval
        for path, params, over in (
                (SIM_MINIMAL_YML, SIM_MINIMAL_PARAMS, []),
                (SIM_SEQ_YML, SIM_SEQ_PARAMS, SIM_SEQ_OVERRIDES)):
            check(sim_params(load_yaml_with_py_eval(path), over) == params,
                  f"the smoke's copy of {path} differs from the file")
    tmp = tempfile.mkdtemp(prefix='chip_smoke_sim_')
    log_o = f'log_params={SIM_LOG!r}'
    n_td, restore = counted_contract()
    warnings.filterwarnings('ignore', message='unused options')
    try:
        with HostDMRGProbe(n_td) as probe, SimulationProbe(probe) as sp:
            # 10a: the repo's file as users have it, on the CPU, then on
            # the card (the kernel's count starts here)
            over = [log_o, f"output_filename={os.path.join(tmp, 'cpu.pkl')}",
                    'device=cpu']
            run_sim_file(has_yaml, SIM_MINIMAL_YML, SIM_MINIMAL_PARAMS, over)
            gg.LAUNCHES = 0
            over = [log_o, f"output_filename={os.path.join(tmp, 'card.pkl')}"]
            run_sim_file(has_yaml, SIM_MINIMAL_YML, SIM_MINIMAL_PARAMS, over)
            a_cpu, a_card = [sp.stage_stats(st) for st in sp.stages]
            # 10b: the sequential ramp to chi=512
            prefix = os.path.join(tmp, 'results_sequential')
            over = SIM_SEQ_OVERRIDES + [
                log_o, f'output_filename_params.prefix={prefix}']
            run_sim_file(has_yaml, SIM_SEQ_YML, SIM_SEQ_PARAMS, over)
            b_stages = [sp.stage_stats(st) for st in sp.stages[2:]]
            final_stage = sp.stages[-1]
            final = final_stage['sim']
            # 10c: the last stage's file resumed for two more sweeps
            files = [f"{prefix}_chi_{chi:04d}.pkl" for chi in SIM_SEQ_CHIS]
            loaded = [tio.load(fn) for fn in files]
            sweeps = int(loaded[-1]['resume_data']['sweeps'])
            t0 = time.time()
            res = sim_mod.resume_from_checkpoint(
                filename=files[-1], update_sim_params={
                    'algorithm_params.max_sweeps': sweeps + SIM_RESUME_SWEEPS})
            resume_s = time.time() - t0
            c_stage = sp.stage_stats(sp.stages[-1])
            launches, tensordots = gg.LAUNCHES, n_td[0]
    finally:
        restore()
        warnings.filterwarnings('default', message='unused options')

    # 10a
    log_stage('a', 'minimal_DMRG.yml, device=cpu', a_cpu)
    log_stage('a', 'minimal_DMRG.yml, the card', a_card)
    e_rel = abs(a_card['energy'] - a_cpu['energy']) / abs(a_cpu['energy'])
    log(f"[10a] card E {a_card['energy']!r}, CPU E {a_cpu['energy']!r}: rel "
        f"{e_rel:.2e} (tolerance {SIM_CPU_REL:.0e}); wall card "
        f"{a_card['wall']:.2f} s, CPU {a_cpu['wall']:.2f} s")
    check(e_rel <= SIM_CPU_REL, "the card's run differs from the CPU run")
    check(a_cpu['device'] == 0 and a_cpu['launches'] == 0,
          "the CPU run used the card")
    check(a_card['device'] > 0 and a_card['device'] == a_card['above'],
          "the card run's updates from the threshold up did not all go to "
          "the card")
    # 10b
    L = SIM_SEQ_PARAMS['model_params']['L']
    E_exact = e0_xx_finite(L, 1.)
    for chi, s in zip(SIM_SEQ_CHIS, b_stages):
        log_stage('b', f'stage chi={chi}', s)
    for s in [a_card] + b_stages + [c_stage]:
        check(s['launches'] == 4 * s['steps'],
              "kernel launches differ from 4 x the device Lanczos steps")
        check(s['device'] == s['above'] and s['device'] > 0,
              "a stage's updates from the threshold up did not all go to "
              "the card")
    E = b_stages[-1]['energy']
    rel = abs(E - E_exact) / abs(E_exact)
    psi = final.psi
    norm = float(np.max(psi.norm_test()))
    cl = final_stage['cleanup']
    sz = float(np.sum(np.real(np.asarray(psi.expectation_value('Sz')))))
    log(f"[10b] final E {E!r}, free fermions {E_exact!r}: rel {rel:.2e} "
        f"(tolerance {SIM_E_REL:.0e}); norm_test {cl['norm_before']:.2e} "
        f"after the sweeps, {norm:.2e} after the end-of-run cleanup "
        f"(norm_tol {cl['norm_tol']:.0e}, canonicalized: "
        f"{cl['canonicalized']}); total Sz {sz:+.2e}; chi {max(psi.chi)}; "
        f"card {smi}")
    check(rel <= SIM_E_REL, "the sequential run missed the free-fermion "
          "energy")
    check(cl['norm_before'] <= SIM_NORM_TOL and norm <= SIM_NORM_TOL,
          "the final state is not canonical")
    check(abs(sz) <= 1e-10, "total Sz is not 0")
    # 10c
    for chi, data, s in zip(SIM_SEQ_CHIS, loaded, b_stages):
        meas = data['measurements']
        check(isinstance(data['psi'], MPS) and all(
            b.device.type == 'cpu' for B in data['psi']._B
            for b in B._data), "the saved psi is not a host MPS")
        check(all(k in meas for k in ('max_chi', 'entropy', 'energy_MPO'))
              and data['finished_run'] and 'resume_data' in data
              and data['energy'] == s['energy'],
              "a stage's file lacks its results")
        check(meas['max_chi'][-1] == chi, f"stage chi={chi}: max_chi "
              f"{meas['max_chi'][-1]}")
    E_res = res['energy']
    r_rel = abs(E_res - E) / abs(E)
    log(f"[10c] {len(files)} stage files loaded (psi, measurements, "
        f"energy, resume_data); max_chi per stage "
        f"{[d['measurements']['max_chi'][-1] for d in loaded]}; resumed "
        f"from sweep count {sweeps} with max_sweeps {sweeps + 2}: "
        f"{resume_s:.2f} s, E {E_res!r}, rel to the loaded {r_rel:.2e} "
        f"(tolerance {SIM_RESUME_REL:.0e})")
    log_stage('c', 'resume', c_stage)
    check(r_rel <= SIM_RESUME_REL, "the resumed run moved the energy")
    if has_h5py:
        fn = os.path.join(tmp, 'final.h5')
        t0 = time.time()
        tio.save(loaded[-1], fn)
        back = tio.load(fn)
        h5_s = time.time() - t0
        ov = abs(complex(back['psi'].overlap(loaded[-1]['psi'])))
        log(f"[10c] final results as .h5: {os.path.getsize(fn) / 2**20:.1f}"
            f" MiB, save and load {h5_s:.2f} s; |overlap| - 1 {ov - 1:.1e}")
        check(back['energy'] == loaded[-1]['energy'] and abs(ov - 1) < 1e-12,
              "the .h5 results differ")
    log(f"[10] phase launches {launches} (tensordots {tensordots})")
    check(launches == tensordots, "launches differ from the tensordots run")

    # the kernel on the chi=512 centre matvec of the final state
    eng = TwoSiteDMRGEngine(final.psi, final.model,
                            {'trunc_params': {'chi_max': 512},
                             'lanczos_params': {'device_K': 2}},
                            device='cuda')
    eng.i0, eng.move_right = L // 2 - 1, True
    theta = eng.prepare_update_local()
    eng._diag_device_lanczos(theta)
    LPp, RPp, W0p, W1p = eng.eff_H._device_packed
    theta_p = pk.pack(theta, multiple=mc.BUCKET_MULTIPLE,
                      pad_labels=('vL', 'vR', 'vL*', 'vR*'), device='cuda')
    _, calls = recorded_calls(lambda: _matvec_2site_packed(
        LPp, RPp, W0p, W1p, theta_p))
    check(len(calls) == 4, "the centre matvec is not four tensordots")
    tot = measure_contractions(calls, MATVEC_STEPS, 10)
    shutil.rmtree(tmp, ignore_errors=True)
    return launches, tot


# TeNPy's time evolution (phase 11): the open XX chain's ground state by
# minimal_DMRG.yml (L=32) at chi=256, then minimal_SpectralSimulation.yml
# from that file with two-site TDVP at chi=256 and dt=0.05: C(t) of Sz_j
# and Sz at the centre, exact from free fermions
TE_DMRG_OVERRIDES = ['model_params.Jz=0.',
                     'algorithm_params.trunc_params.chi_max=256',
                     'algorithm_params.trunc_params.svd_min=1e-12']
TE_SPEC_YML = os.path.join(ROOT, 'examples', 'yaml',
                           'minimal_SpectralSimulation.yml')
TE_CHI = 256
TE_DT = 0.05
TE_FINAL_TIME = 0.6
# sizes and cuts that tests/rehearse_time_evolution_phase.py changes
TE_EXTRA_OVERRIDES = []
# max |C(t) - C_exact(t)| over sites and measured times: ten times the
# largest deviation of the CPU rehearsal at L=16 with the same dt and chi
# (tests/rehearse_time_evolution_phase.py 16: 9.6e-10; at L=32 1.5e-10)
TE_C_TOL = 1e-8
# |<H>(t_end) - <H>(0)| <= TE_E_ABS + TE_E_FACTOR |E_0| sum(eps)
TE_E_ABS, TE_E_FACTOR = 1e-9, 10.
TE_ROUTE_TOL = 1e-10
# the crossover: both routes run TE_CROSS_K fixed Krylov steps of one
# forward evolution (-0.5j dt) on the two- and one-site effective H of
# these bonds (two-site N = 16, 64, 256, 1024, 4096, 65536, 262144 and the
# centre's), the table TE_CROSS_REPEATS times
TE_CROSS_K = 6
TE_CROSS_BONDS = (0, 1, 2, 3, 4, 6, 8, None)
TE_CROSS_REPEATS = 3
TE_ONE_SITE_STEPS = ['LP.theta over vR/vL', '.W0 over (wR,p0)',
                     '.RP over (wR,vR)']


def xx_szsz_exact(L, c, times, Jxx=1.):
    """``<Sz_j(t) Sz_c(0)>`` in the ground state of the open XX chain (half
    filling) for every site j and time, by Wick's theorem from the
    single-particle correlation matrix ``C_ab = <c_a^dagger c_b>`` and
    ``U(t) = exp(-i h t)``, ``h`` the hopping matrix (``Jxx / 2``)."""
    h = np.diag(np.full(L - 1, Jxx / 2.), 1)
    eps, phi = np.linalg.eigh(h + h.T)
    occ = phi[:, eps < 0]
    C = occ.conj() @ occ.T
    n = np.real(np.diag(C))
    e_c = np.eye(L)[:, c]
    res = []
    for t in times:
        U = phi @ np.diag(np.exp(-1j * eps * t)) @ phi.conj().T
        res.append((U.conj() @ C[:, c]) * (U @ (e_c - C[c, :]))
                   + (n - 0.5) * (n[c] - 0.5))
    return np.array(res)


class TDVPProbe:
    """Within ``with``: the dynamical-correlation simulation (captured at
    its ``init_algorithm``, with ``<H>`` of the state it evolves), the
    seconds and kernel launches of each TDVP step, the kernel launches of
    the card's two- and one-site evolutions (counted around each
    ``_evolve_device``), and the packed path's plan builds and cache hits
    (restored on exit)."""

    def __init__(self):
        self.sim = None
        self.E_start = None
        self.steps = []       # (seconds, launches, local evolutions)
        self.launches = {2: 0, 1: 0}   # by the evolution's length
        self.plans = []       # cache hit of each tensordot plan
        self._patches = []

    def _patch(self, obj, name, make):
        own = name in vars(obj)
        orig = getattr(obj, name)
        setattr(obj, name, make(orig))
        self._patches.append((obj, name, orig, own))

    def __enter__(self):
        from tenpy_tpu_torch.algorithms.tdvp import TDVPEngine, \
            TwoSiteTDVPEngine
        from tenpy_tpu_torch.simulations.time_evolution import \
            TimeDependentCorrelation
        probe = self

        def init_algorithm(orig):
            def run(sim, *a, **kw):
                out = orig(sim, *a, **kw)
                probe.sim = sim
                psi = sim.psi
                probe.E_start = float(np.real(
                    sim.model.H_MPO.expectation_value(psi))) / float(
                        np.real(psi.overlap(psi)))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                return out
            return run

        def evolve_step(orig):
            def run(eng, dt):
                n0, k0, t0 = gg.LAUNCHES, len(eng.evolve_stats), \
                    time.perf_counter()
                out = orig(eng, dt)
                torch.cuda.synchronize()
                probe.steps.append((time.perf_counter() - t0,
                                    gg.LAUNCHES - n0,
                                    eng.evolve_stats[k0:]))
                return out
            return run

        def evolve_device(orig):
            def run(eng, H, theta, delta):
                n0 = gg.LAUNCHES
                out = orig(eng, H, theta, delta)
                probe.launches[H.length] += gg.LAUNCHES - n0
                return out
            return run

        def plan(orig):
            def run(a, b, n):
                probe.plans.append((a.struct_sig(), b.struct_sig(), n)
                                   in pk._PACKED_PLAN_CACHE)
                return orig(a, b, n)
            return run

        self._patch(TimeDependentCorrelation, 'init_algorithm',
                    init_algorithm)
        self._patch(TwoSiteTDVPEngine, 'evolve_step', evolve_step)
        self._patch(TDVPEngine, '_evolve_device', evolve_device)
        self._patch(pk, '_packed_plan', plan)
        return self

    def __exit__(self, *exc):
        for obj, name, orig, own in reversed(self._patches):
            if own:
                setattr(obj, name, orig)
            else:
                delattr(obj, name)


def forget_packed_plans():
    """Drop every cached packed tensordot and transpose plan and block
    structure, so that the next packed call builds them as the first
    update of a new structure does."""
    pk._PACKED_PLAN_CACHE.clear()
    pk._TRANSPOSE_CACHE.clear()
    pk.complete_structure.cache_clear()


def evolve_stats_summary(stats):
    """Per route and length of the local evolutions: count and Krylov
    steps."""
    res = {}
    for length, _, route, steps in stats:
        c = res.setdefault((length, route), [0, 0])
        c[0] += 1
        c[1] += steps
    return res


def phase_time_evolution(smi):
    """TeNPy's time evolution on the card: 11a the XX chain's ground state
    by ``minimal_DMRG.yml`` at chi=256, 11b its dynamical correlation by
    ``minimal_SpectralSimulation.yml`` with two-site TDVP at chi=256, held
    to free fermions, 11c the card's route against the host's on one TDVP
    step and their crossover by N; then the kernel on a chi=256 two-site
    and one-site complex128 matvec.  Returns the launches of the two- and
    one-site matvecs on the path and the kernel's measurements."""
    import shutil
    import tempfile
    import warnings
    from tenpy_tpu_torch.algorithms import tdvp
    from tenpy_tpu_torch.linalg.krylov_based import LanczosEvolution
    from tenpy_tpu_torch.tools import io as tio
    try:
        import yaml  # noqa: F401
    except ImportError:
        raise RuntimeError("phase 11 runs console_main: PyYAML is missing")
    tmp = tempfile.mkdtemp(prefix='chip_smoke_te_', dir=os.path.join(
        ROOT, 'build') if os.path.isdir(os.path.join(ROOT, 'build'))
        else None)
    log_o = f'log_params={SIM_LOG!r}'
    warnings.filterwarnings('ignore', message='unused options')
    try:
        # 11a: the ground state
        gs_fn = os.path.join(tmp, 'gs.pkl')
        t0 = time.time()
        check(tenpy_tpu_torch.console_main(sim_argv(
            SIM_MINIMAL_YML, TE_DMRG_OVERRIDES + TE_EXTRA_OVERRIDES + [
                log_o, f'output_filename={gs_fn}'])) == 0,
            "console_main failed on minimal_DMRG.yml")
        gs_s = time.time() - t0
        gs = tio.load(gs_fn)
        L = gs['psi'].L
        E_gs = float(gs['energy'])
        E_exact = e0_xx_finite(L, 1.)
        gs_rel = abs(E_gs - E_exact) / abs(E_exact)
        log(f"[11a] minimal_DMRG.yml, XX chain L={L}, chi_max={TE_CHI}: "
            f"{gs_s:.2f} s, E {E_gs!r}, free fermions {E_exact!r}: rel "
            f"{gs_rel:.2e} (tolerance {XX_E_TOL:.0e}); chi "
            f"{max(gs['psi'].chi)}")
        check(gs_rel <= XX_E_TOL, "the ground state missed the free-fermion "
              "energy")
        # 11b: the dynamical correlation from that file
        spec_fn = os.path.join(tmp, 'spectral.pkl')
        over = ['algorithm_class=TwoSiteTDVPEngine',
                f'algorithm_params.trunc_params.chi_max={TE_CHI}',
                f'algorithm_params.dt={TE_DT}', f'final_time={TE_FINAL_TIME}',
                f'ground_state_filename={gs_fn}', log_o,
                f'output_filename={spec_fn}']
        gg.LAUNCHES = 0                # count phase 11b's launches only
        with TDVPProbe() as probe:
            t0 = time.time()
            check(tenpy_tpu_torch.console_main(sim_argv(TE_SPEC_YML, over))
                  == 0, "console_main failed on minimal_SpectralSimulation")
            torch.cuda.synchronize()
            run_s = time.time() - t0
        launches = gg.LAUNCHES
        peak = torch.cuda.max_memory_allocated()
    finally:
        warnings.filterwarnings('default', message='unused options')
    sim = probe.sim
    eng = sim.engine
    res = tio.load(spec_fn)
    meas = res['measurements']
    C = np.asarray(meas['correlation_function_t_Sz_Sz'])
    times = np.asarray(meas['evolved_time'], float)
    c = L // 2
    C_ex = xx_szsz_exact(L, c, times)
    c_err = float(np.max(np.abs(C - C_ex)))
    step_s = [s for s, _, _ in probe.steps]
    stats = evolve_stats_summary(eng.evolve_stats)
    n2 = sum(v[0] for (n, _), v in stats.items() if n == 2)
    n1 = sum(v[0] for (n, _), v in stats.items() if n == 1)
    d2, s2 = stats.get((2, 'device'), [0, 0])
    d1, s1 = stats.get((1, 'device'), [0, 0])
    h2, hs2 = stats.get((2, 'host'), [0, 0])
    h1, hs1 = stats.get((1, 'host'), [0, 0])
    n_dev = d2 + d1
    log(f"[11b] minimal_SpectralSimulation.yml with TwoSiteTDVPEngine, "
        f"chi_max={TE_CHI}, dt={TE_DT}, final_time={TE_FINAL_TIME}: "
        f"{run_s:.2f} s in all, {len(step_s)} TDVP steps, s/step "
        + ' '.join(f"{s:.3f}" for s in step_s)
        + f" (median {statistics.median(step_s):.3f}); card {smi}")
    log(f"[11b] local evolutions: two-site {d2} of {n2} on the card "
        f"({100. * d2 / max(n2, 1):.1f}%, {s2} Krylov steps, "
        f"{s2 / max(d2, 1):.2f} per update), {h2} on the host ({hs2} "
        f"steps); one-site {d1} of {n1} on the card "
        f"({100. * d1 / max(n1, 1):.1f}%, {s1} steps, "
        f"{s1 / max(d1, 1):.2f} per update), {h1} on the host ({hs1} "
        f"steps); host syncs per card update "
        f"{(s2 + s1 + n_dev) / max(n_dev, 1):.2f} "
        f"(one (alpha, beta) read per Krylov step and the result's copy)")
    l2, l1 = probe.launches[2], probe.launches[1]
    log(f"[11b] kernel launches {launches}: {l2} in the card's two-site "
        f"evolutions (4 x {s2} Krylov steps = {4 * s2}), {l1} in its "
        f"one-site evolutions (3 x {s1} = {3 * s1}); tensordot plans "
        f"{sum(1 for h in probe.plans if not h)} built, "
        f"{sum(1 for h in probe.plans if h)} hits; peak memory "
        f"{peak / 2**30:.3f} GiB; max chi {max(sim.psi.chi)}")
    log(f"[11b] C(t) = e^(i E0 t) <Sz_j(t) Sz_{c}(0)> at {len(times)} "
        f"measurements (t = {times[0]:.2f} .. {times[-1]:.2f}), {L} sites: "
        f"max |C - free fermions| {c_err:.3e} (tolerance {TE_C_TOL:.1e}); "
        f"C(t_end, c) {complex(C[-1, c]):.6f}, exact "
        f"{complex(C_ex[-1, c]):.6f}")
    psi = sim.psi
    E_end = float(np.real(sim.model.H_MPO.expectation_value(psi))) / \
        float(np.real(psi.overlap(psi)))
    eps = float(eng.trunc_err.eps)
    e_bound = TE_E_ABS + TE_E_FACTOR * abs(E_gs) * eps
    log(f"[11b] <H> of the evolved state: {probe.E_start!r} at t=0, "
        f"{E_end!r} at t={times[-1]:.2f}: |drift| "
        f"{abs(E_end - probe.E_start):.2e}, accumulated truncation error "
        f"{eps:.2e}, bound {e_bound:.2e}")
    S = np.asarray(res['post_processing']['spectral_function_Sz_Sz'][
        'spectral_function'])
    log(f"[11b] S(k, w): shape {S.shape}, finite {bool(np.isfinite(S).all())}"
        f", max |S| {float(np.max(np.abs(S))):.4f}")
    check(c_err <= TE_C_TOL, "C(t) differs from free fermions")
    check(abs(E_end - probe.E_start) <= e_bound, "<H> is not conserved")
    check(np.isfinite(S).all() and S.size > 0, "S(k, w) is not finite")
    check(launches == l2 + l1, "kernel launches outside the card's "
          "two- and one-site evolutions")
    check(l2 == 4 * s2 and l1 == 3 * s1,
          "kernel launches differ from 4 x two-site + 3 x one-site steps")
    check(d2 >= 0.9 * n2, "fewer than 90% of the two-site evolutions ran "
          "on the card")

    # 11c: one TDVP step by the card's route and by the host's, from the
    # same state; then the crossover by N
    a, b = psi.copy(), psi.copy()
    opts = {'dt': TE_DT, 'N_steps': 1,
            'trunc_params': {'chi_max': TE_CHI}}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        card = tdvp.TwoSiteTDVPEngine(a, sim.model, copy.deepcopy(opts),
                                      device='cuda')
        card.run()
        torch.cuda.synchronize()
        card_s = time.time() - t0
    busy, _, kernel_us, rows = device_time(prof)
    dtoh = sum(n for name, _, n in rows if 'DtoH' in name)
    t0 = time.time()
    tdvp.TwoSiteTDVPEngine(b, sim.model, copy.deepcopy(opts),
                           device='cpu').run()
    host_s = time.time() - t0
    ov = abs(complex(a.overlap(b))) / np.sqrt(
        abs(complex(a.overlap(a))) * abs(complex(b.overlap(b))))
    cstats = evolve_stats_summary(card.evolve_stats)
    c_steps = sum(v[1] for (_, r), v in cstats.items() if r == 'device')
    c_dev = sum(v[0] for (_, r), v in cstats.items() if r == 'device')
    log(f"[11c] one TDVP step from the evolved state: card route "
        f"{card_s:.2f} s (profiled; device busy {busy / 1e6:.3f} s, idle "
        f"{100 * (1 - busy / 1e6 / card_s):.1f}%, the kernel "
        f"{kernel_us / 1e6:.3f} s; {dtoh} device-to-host copies for "
        f"{c_dev} card updates with {c_steps} Krylov steps), host route "
        f"{host_s:.2f} s; 1 - |<card|host>| {1 - ov:.2e} (tolerance "
        f"{TE_ROUTE_TOL:.0e})")
    for name, us, n in rows[:5]:
        log(f"[11c]   {us / 1e6:8.4f} s {n:6d} x  {name[:80]}")
    check(1. - ov <= TE_ROUTE_TOL, "the card's TDVP step differs from the "
          "host's")

    fixed = {'N_min': TE_CROSS_K, 'N_max': TE_CROSS_K, 'P_tol': 0.,
             'cutoff': 0.}
    ce = tdvp.TwoSiteTDVPEngine(psi, sim.model, {
        'dt': TE_DT, 'lanczos_options': dict(fixed)}, device='cuda')
    log(f"[11c] crossover ({TE_CROSS_K} Krylov steps each of exp(-0.5j dt "
        f"H) theta; the card's new-structure call packs LP, RP and W and "
        f"builds every tensordot and transpose plan, as the first update "
        f"of a structure does; its first call packs with the plans cached; "
        f"its second reuses both; the table {TE_CROSS_REPEATS} times):")
    worst = {}      # (n, N) -> [new-structure, first call] card/host
    for rep in range(TE_CROSS_REPEATS):
        for b_ in TE_CROSS_BONDS:
            i = c - 1 if b_ is None else b_
            for n, Hcls in ((2, mc.TwoSiteH), (1, mc.OneSiteH)):
                H = Hcls(ce.env, i)
                th = psi.get_theta(i, n)
                t0 = time.time()
                LanczosEvolution(H, th, dict(fixed)).run(-0.5j * TE_DT,
                                                         normalize=True)
                h_ms = 1e3 * (time.time() - t0)
                card_ms = []
                for new_struct in (True, False):
                    ce._packed_env, ce._packed_W = [], {}
                    if new_struct:
                        forget_packed_plans()
                    t0 = time.time()
                    ce._evolve_device(H, th, -0.5j * TE_DT)
                    card_ms.append(1e3 * (time.time() - t0))
                t0 = time.time()
                ce._evolve_device(H, th, -0.5j * TE_DT)
                warm_ms = 1e3 * (time.time() - t0)
                w = worst.setdefault((n, H.N), [0., 0.])
                for k in (0, 1):
                    w[k] = max(w[k], card_ms[k] / h_ms)
                log(f"[11c]   run {rep + 1} {n}-site at site {i}: "
                    f"N={H.N:8d}: host {h_ms:9.2f} ms, card {card_ms[0]:9.2f} "
                    f"ms (new structure), {card_ms[1]:9.2f} ms (first call), "
                    f"{warm_ms:9.2f} ms (second): card/host "
                    f"{card_ms[0] / h_ms:.3f}, {card_ms[1] / h_ms:.3f}")
    for n in (2, 1):
        rows_n = sorted((N, r) for (m, N), r in worst.items() if m == n)
        for k, what in ((0, 'new-structure'), (1, 'first')):
            wins = [N for N, r in rows_n if r[k] < 1.]
            log(f"[11c] crossover {n}-site, the card's {what} call: worst "
                f"card/host by N { {N: round(r[k], 3) for N, r in rows_n} }"
                f"; it wins in every run at N = {wins}")
    log(f"[11c] DEVICE_EVOLUTION_THRESHOLD = "
        f"{mc.DEVICE_EVOLUTION_THRESHOLD}, DEVICE_LANCZOS_THRESHOLD = "
        f"{mc.DEVICE_LANCZOS_THRESHOLD}")

    # the kernel on the centre's two- and one-site matvec (complex128)
    tots = []
    for n, Hcls, steps in ((2, mc.TwoSiteH, MATVEC_STEPS),
                           (1, mc.OneSiteH, TE_ONE_SITE_STEPS)):
        H = Hcls(ce.env, c - 1)
        th = psi.get_theta(c - 1, n).itranspose(H.acts_on)
        dtype = npc.result_type(H.LP.dtype, H.RP.dtype, th.dtype,
                                H.W0.dtype)
        Ws = [H.W0] + ([H.W1] if n == 2 else [])
        LPp, RPp = ce._pack_env(H.LP, dtype), ce._pack_env(H.RP, dtype)
        Wps = [ce._pack_W(c - 1 + k, W, dtype) for k, W in enumerate(Ws)]
        th_p = mc.pack_virtual(th, 'cuda', dtype)
        mv = mc._matvec_2site_packed if n == 2 else mc._matvec_1site_packed
        _, calls = recorded_calls(lambda: mv(LPp, RPp, *Wps, th_p))
        check(len(calls) == len(steps) and calls[0][3] == torch.complex128,
              f"the {n}-site matvec is not {len(steps)} complex128 "
              f"tensordots")
        log(f"[11] {n}-site matvec at the centre (N={H.N}):")
        tots.append(measure_contractions(calls, steps, 11))
    shutil.rmtree(tmp, ignore_errors=True)
    return l2, l1, tots[0], tots[1]


# VUMPS (phase 12): 12a two-site VUMPS on the infinite XX chain (Jz=0: free
# fermions, -1/pi per site), Sz conserved, from the Neel state ramped by
# chi_list to chi=256 with the subspace-expansion mixer; 12b single-site
# VUMPS on phase 7's chi=128 Hofstadter state (complex128, BASELINE config
# #5) at fixed chi; 12c minimal_DMRG.yml as two-site VUMPS (the infinite
# Heisenberg chain, chi 64) through console_main.  No device_K: the
# engines' own DEVICE_LANCZOS_THRESHOLD sends the eigensolves to the card
# host threads of the phase: the environment fixed point (host Arnoldi
# over small charge blocks) runs 2-4x faster on one torch thread than on
# the default (the core count): 4.8 s against 9.7 s (Hofstadter, chi=128)
# and 3.2 s against 12.2 s (XX chain, chi=256) on an 8-core CPU (my CPU
# runs)
VU_HOST_THREADS = 1
VU_XX_MODEL = {'L': 2, 'Jxx': 1., 'Jz': 0., 'hz': 0., 'bc_MPS': 'infinite',
               'conserve': 'Sz'}
VU_XX_INIT = ['up', 'down']
VU_CHI = 256
VU_CHI_LIST = {0: 32, 2: 64, 4: 128, 6: VU_CHI}
# sweeps: two per stage (a cut: the environment fixed point, host
# Arnoldi, costs seconds per update at chi=256; see PERF.md)
VU_SWEEPS = 8
# the two-site engine's split error stays at the truncation's level (its
# AL C and C AR differ by the cut weight): 7.5e-4 and 9.8e-4 in the two
# chi=256 sweeps of the CPU rehearsal; the option is set above that, and
# the run is held to it
VU_SPLIT_TOL = 1e-2
VU_OPTIONS = {'chi_list': VU_CHI_LIST, 'max_sweeps': VU_SWEEPS,
              'min_sweeps': VU_SWEEPS, 'mixer': 'SubspaceExpansion',
              'mixer_params': {'amplitude': 1e-5, 'disable_after': 4},
              'trunc_params': {'chi_max': VU_CHI, 'svd_min': 1e-10},
              'max_E_err': 1e-12, 'max_split_err': VU_SPLIT_TOL,
              'check_overlap': False, 'norm_tol': 1e-10}
# the port's own iDMRG at the same chi_max (dmrg.run; its two-site
# eigensolves on the card by the same threshold), from the same Neel state
VU_DMRG_OPTIONS = {'trunc_params': {'chi_max': VU_CHI, 'svd_min': 1e-10},
                   'chi_list': {0: 32, 4: 64, 8: 128, 12: VU_CHI},
                   'min_sweeps': 20, 'max_sweeps': 30, 'mixer': True,
                   'max_E_err': 1e-12}
VU_E_EXACT = -1. / np.pi
# |E + 1/pi| after VU_SWEEPS: 4.4e-7 in the CPU rehearsal
# (tests/rehearse_vumps_phase.py 256).  The two-site engine's plateau at a
# fixed chi falls as chi^-2.6 (7.1e-6 at chi=32, 1.2e-6 at chi=64, my CPU
# runs), about 3e-8 at chi=256: the two sweeps there, not chi, set the
# deviation.  A factor 2.3 above the rehearsal allows the card's Lanczos
# stopping rule (on the energy, not the residual)
VU_E_TOL = 1e-6
VU_IDMRG_MARGIN = 1e-10
VU_ROUTE_K = 40
VU_ROUTE_E_TOL, VU_ROUTE_OV_TOL = 1e-12, 1e-10
VU_ZERO_SITE_STEPS = ['LP.C over vR/vL', '.RP over (wR,vR)']
# 12b: single-site VUMPS at chi=128 from phase 7's written-back state, two
# sweeps of its 9-site cell (a cut: about 7 s of host Arnoldi per update)
VU_HOF_SWEEPS = 2
VU_HOF_OPTIONS = {'max_sweeps': VU_HOF_SWEEPS, 'min_sweeps': VU_HOF_SWEEPS,
                  'max_E_err': 1e-12, 'max_split_err': 1e-8,
                  'check_overlap': False, 'norm_tol': 1e-10}
# E per site against phase 7's iDMRG energy per site: at most that + 1e-10,
# and within 1e-7 of it (the CPU rehearsal at chi=128: 2.1e-12 below; the
# chi=64 state's 1e-8 below)
VU_HOF_E_TOL = 1e-7
# 12c: minimal_DMRG.yml as two-site VUMPS on the infinite Heisenberg chain
VU_YAML_CHI = 64
VU_YAML_OVERRIDES = ['model_params.L=2', 'model_params.bc_MPS=infinite',
                     'algorithm_class=TwoSiteVUMPSEngine',
                     f'algorithm_params.trunc_params.chi_max={VU_YAML_CHI}',
                     'algorithm_params.trunc_params.svd_min=1.e-10',
                     'algorithm_params.mixer=SubspaceExpansion',
                     'algorithm_params.chi_list={0: 16, 2: 32, 4: 64}',
                     'algorithm_params.max_sweeps=8',
                     'algorithm_params.min_sweeps=8',
                     'algorithm_params.max_split_err=1e-2',
                     'algorithm_params.check_overlap=False']
VU_HEIS_EXACT = 0.25 - np.log(2.)
# the Heisenberg chain at chi=64 after 8 sweeps: 1.6e-6 above the exact
# energy in the CPU rehearsal; a factor 6 for the card's stopping rule
VU_YAML_E_TOL = 1e-5


class VUMPSProbe:
    """Within ``with``: every VUMPS engine's eigensolves, with the kernel
    launches counted around each by its number of sites, the problems of
    the last update (effective H and guess, in order), the last problem
    of each kind, and one sweep profiled on the device (the sweep numbered
    ``profile_sweep``, if given; restored on exit)."""

    def __init__(self, profile_sweep=None):
        self.launches = {0: 0, 1: 0, 2: 0}
        self.engines = []
        self.last = {}
        self.last_update = []
        self._update = None
        self.profile_sweep = profile_sweep
        self.prof = None
        self.prof_s = None
        self._patches = []

    def __enter__(self):
        from tenpy_tpu_torch.algorithms.vumps import VUMPSEngine
        probe = self

        def eigensolve(orig):
            def run(eng, eff, guess):
                if not probe.engines or probe.engines[-1] is not eng:
                    probe.engines.append(eng)
                update = (id(eng), len(eng.update_timing))
                if update != probe._update:
                    probe._update, probe.last_update = update, []
                n0 = gg.LAUNCHES
                out = orig(eng, eff, guess)
                probe.launches[eff.length] += gg.LAUNCHES - n0
                probe.last[eff.length] = (eff, guess)
                probe.last_update.append((eff, guess))
                return out
            return run

        def sweep(orig):
            def run(eng, optimize=True):
                if eng.sweeps != probe.profile_sweep or probe.prof:
                    return orig(eng, optimize)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = orig(eng, optimize)
                    torch.cuda.synchronize()
                    probe.prof_s = time.perf_counter() - t0
                probe.prof = prof
                return out
            return run

        for name, make in (('eigensolve', eigensolve), ('sweep', sweep)):
            orig = getattr(VUMPSEngine, name)
            setattr(VUMPSEngine, name, make(orig))
            self._patches.append((VUMPSEngine, name, orig))
        return self

    def __exit__(self, *exc):
        for obj, name, orig in reversed(self._patches):
            setattr(obj, name, orig)
        return False


def vumps_eig_summary(tag, stats):
    """Log the eigensolves by kind and route; returns ``{(sites, route):
    [count, Lanczos steps]}``."""
    res = {}
    for n, N, route, steps in stats:
        c = res.setdefault((n, route), [0, 0])
        c[0] += 1
        c[1] += steps
    kinds = {0: 'zero-site', 1: 'one-site', 2: 'two-site'}
    for (n, route), (cnt, steps) in sorted(res.items()):
        log(f"[{tag}] {kinds[n]} eigensolves on the {route}: {cnt}, "
            f"{steps} Lanczos steps ({steps / cnt:.2f} per solve)")
    return res


def vumps_timing(tag, ups):
    """Log the time of the updates ``ups`` (entries of a VUMPS engine's
    ``update_timing``) by part: the environment fixed point, each kind of
    eigensolve (pack, Lanczos, unpack), the polar decompositions, the SVD;
    returns the sums."""
    tot = {'env': 0., 'polar': 0., 'svd': 0.}
    eig = {}
    for ut in ups:
        for k in tot:
            tot[k] += ut[k]
        for e in ut['eig']:
            c = eig.setdefault((e['sites'], e['route']), [0, 0., 0., 0.])
            c[0] += 1
            c[1] += e['pack']
            c[2] += e['lanczos']
            c[3] += e['unpack']
    all_eig = sum(c[1] + c[2] + c[3] for c in eig.values())
    total = tot['env'] + tot['polar'] + tot['svd'] + all_eig
    log(f"[{tag}] {len(ups)} updates, {total:.2f} s: environment fixed "
        f"point (host Arnoldi) {tot['env']:.2f} s "
        f"({100 * tot['env'] / max(total, 1e-300):.1f}%, "
        f"{tot['env'] / max(len(ups), 1):.3f} s per update), eigensolves "
        f"{all_eig:.2f} s ({100 * all_eig / max(total, 1e-300):.1f}%), "
        f"polar {tot['polar']:.2f} s, SVD {tot['svd']:.2f} s")
    kinds = {0: 'zero-site', 1: 'one-site', 2: 'two-site'}
    for (n, route), (cnt, pack, lanc, unpack) in sorted(eig.items()):
        log(f"[{tag}]   {kinds[n]} on the {route}: {cnt} solves, pack "
            f"{1e3 * pack / cnt:.2f} ms, Lanczos {1e3 * lanc / cnt:.2f} ms, "
            f"unpack {1e3 * unpack / cnt:.2f} ms per solve")
    tot['eig'] = all_eig
    return tot


def check_vumps_route(tag, stats):
    """Every eigensolve from DEVICE_LANCZOS_THRESHOLD up ran on the card."""
    big = [s for s in stats if s[1] >= mc.DEVICE_LANCZOS_THRESHOLD]
    on_card = sum(1 for s in big if s[2] == 'device')
    log(f"[{tag}] eigensolves with N >= {mc.DEVICE_LANCZOS_THRESHOLD}: "
        f"{on_card} of {len(big)} on the card; below it {len(stats) - len(big)}"
        f" (host)")
    check(big and on_card == len(big),
          "an eigensolve from the threshold up did not run on the card")


def check_vumps_launches(tag, probe, stats, launches, per_step):
    """Launches around the card's eigensolves of each kind equal that
    kind's tensordots per matvec times its Lanczos steps, and add up to
    every launch of the run."""
    steps = {n: sum(s[3] for s in stats if s[0] == n and s[2] == 'device')
             for n in per_step}
    kinds = {0: 'zero-site', 1: 'one-site', 2: 'two-site'}
    log(f"[{tag}] kernel launches {launches}: " + ', '.join(
        f"{probe.launches[n]} in the {kinds[n]} card eigensolves "
        f"({per_step[n]} x {steps[n]} Lanczos steps = "
        f"{per_step[n] * steps[n]})" for n in per_step))
    check(all(probe.launches[n] == per_step[n] * steps[n]
              for n in per_step),
          "kernel launches differ from the eigensolves' Lanczos steps")
    check(launches == sum(probe.launches[n] for n in per_step),
          "kernel launches outside the card's eigensolves")


def vumps_kernel(tag, eff, guess, steps):
    """The kernel against its plain version on one matvec of ``eff`` (its
    packed operands on the card), timed."""
    th_p = mc.pack_virtual(guess.transpose(eff.acts_on), 'cuda')
    ops = eff.pack_operands('cuda')
    _, calls = recorded_calls(lambda: eff.packed_matvec(*ops, th_p))
    check(len(calls) == len(steps), f"the matvec is not {len(steps)} "
          f"tensordots")
    log(f"[{tag}] {len(steps)}-tensordot matvec, N={eff.N}, "
        f"{calls[0][3]}:")
    return measure_contractions(calls, steps, tag)


def vumps_route_check(tag, eff, guess, name):
    """One eigenproblem of the run by the card's packed Lanczos and by the
    host LanczosGroundState, the same VU_ROUTE_K steps from the same
    guess: E (relative) and |overlap|."""
    from tenpy_tpu_torch.linalg.krylov_based import LanczosGroundState
    guess = guess.transpose(eff.acts_on)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    E_c, th, _, _ = mc.lanczos_ground_packed(
        eff.packed_matvec, eff.pack_operands('cuda'),
        mc.pack_virtual(guess, 'cuda'), VU_ROUTE_K, 0.)
    th = pk.unpack(dmrg._to_host(th), orig_legs=[
        guess.get_leg(lbl) for lbl in th.get_leg_labels()])
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    E_h, th_h, N_h = LanczosGroundState(eff, guess, {
        'N_min': VU_ROUTE_K, 'N_max': VU_ROUTE_K, 'P_tol': 0.}).run()
    host_s = time.perf_counter() - t0
    rel = abs(E_c - E_h) / abs(E_h)
    ov = abs(complex(npc.inner(th_h.conj(), th, axes='range')))
    log(f"[{tag}] {name} (N={eff.N}), {VU_ROUTE_K} Lanczos steps each: "
        f"card {1e3 * card_s:.1f} ms, host {1e3 * host_s:.1f} ms ({N_h} "
        f"steps); E {E_c!r} vs {E_h!r}: rel {rel:.2e} (tolerance "
        f"{VU_ROUTE_E_TOL:.0e}); 1 - |overlap| {1 - ov:.2e} (tolerance "
        f"{VU_ROUTE_OV_TOL:.0e})")
    check(rel <= VU_ROUTE_E_TOL, f"{name}: the card's E differs from the "
          f"host's")
    check(1. - ov <= VU_ROUTE_OV_TOL, f"{name}: the card's ground state "
          f"differs from the host's")


def phase_vumps_xx(smi):
    """12a: two-site VUMPS on the infinite XX chain to chi=256 against
    -1/pi and the port's iDMRG at the same chi; the card's eigensolves
    against the host's on the last update; the time split and the idle
    share of the last sweep; the kernel on a zero- and a two-site matvec
    at chi=256.  Returns the launches by kind and the two matvecs'
    measurements."""
    from tenpy_tpu_torch.algorithms.vumps import TwoSiteVUMPSEngine
    model = XXZChain(dict(VU_XX_MODEL))
    psi = MPS.from_product_state(model.lat.mps_sites(), VU_XX_INIT,
                                 bc='infinite')
    gg.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    with VUMPSProbe(profile_sweep=VU_SWEEPS - 1) as probe:
        t0 = time.time()
        eng = TwoSiteVUMPSEngine(psi, model, copy.deepcopy(VU_OPTIONS),
                                 device='cuda')
        E, psi_out = eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    launches = gg.LAUNCHES
    ss = eng.sweep_stats
    log(f"[12a] TwoSiteVUMPSEngine on the XX chain {VU_XX_MODEL}, chi_list "
        f"{VU_CHI_LIST}, {VU_SWEEPS} sweeps: {wall:.2f} s; card {smi}")
    for k in range(len(ss['E'])):
        log(f"[12a]   sweep {ss['sweep'][k]}: chi {ss['max_chi'][k]}, E "
            f"{ss['E'][k]!r} (E + 1/pi {ss['E'][k] - VU_E_EXACT:+.3e}), "
            f"max_split_err {ss['max_split_err'][k]:.3e}, norm_err "
            f"{ss['norm_err'][k]:.2e}, {ss['time'][k]:.2f} s")
    err = E - VU_E_EXACT
    norm_err = float(np.linalg.norm(eng.psi.norm_test()))
    E_mpo = float(model.H_MPO.expectation_value(psi_out))
    E_bond = float(np.mean(psi_out.expectation_value(model.H_bond)))
    log(f"[12a] E {E!r}, exact -1/pi {VU_E_EXACT!r}: {err:+.3e} (tolerance "
        f"{VU_E_TOL:.0e}); norm_test of the uniform MPS {norm_err:.2e} "
        f"(norm_tol {VU_OPTIONS['norm_tol']:.0e}); last max_split_err "
        f"{ss['max_split_err'][-1]:.3e} (option {VU_SPLIT_TOL:.0e}); the "
        f"returned MPS: MPO energy {E_mpo!r} ({E_mpo - E:+.2e}), bond "
        f"energies {E_bond!r} ({E_bond - E:+.2e}), chi {psi_out.chi}, "
        f"norm_test {float(np.max(psi_out.norm_test())):.2e}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(abs(err) <= VU_E_TOL, "12a: E is not -1/pi within its tolerance")
    check(norm_err <= VU_OPTIONS['norm_tol'], "12a: norm_test above norm_tol")
    check(ss['max_split_err'][-1] <= VU_SPLIT_TOL,
          "12a: the last max_split_err is above its option")
    # the returned MPS (AR and the singular values of C, re-gauged) is the
    # uniform state up to its split error: its energy differs from E at
    # second order in it; its MPO and bond energies are one number
    check(abs(E_mpo - E_bond) <= 1e-10, "12a: the MPO and bond energies "
          "of the returned state disagree")
    check(abs(E_mpo - E) <= ss['max_split_err'][-1] ** 2,
          "12a: the returned state's energy is not E within the split "
          "error squared")
    stats = eng.eig_stats
    vumps_eig_summary('12a', stats)
    check_vumps_route('12a', stats)
    check_vumps_launches('12a', probe, stats, launches, {0: 2, 2: 4})
    per_sweep = eng.psi.L
    check(len(eng.update_timing) == VU_SWEEPS * per_sweep,
          "12a: updates timed twice or missed")
    starts = sorted(VU_CHI_LIST) + [VU_SWEEPS]
    for sw0, sw1 in zip(starts, starts[1:]):
        log(f"[12a] time split at chi={VU_CHI_LIST[sw0]} (sweeps "
            f"{sw0}-{sw1 - 1}):")
        vumps_timing('12a', eng.update_timing[sw0 * per_sweep:
                                              sw1 * per_sweep])
    busy, _, kernel_us, rows = device_time(probe.prof)
    log(f"[12a] profiled sweep {VU_SWEEPS - 1} (chi={VU_CHI}): "
        f"{probe.prof_s:.2f} s, device busy {busy / 1e6:.3f} s, idle "
        f"{100 * (1 - busy / 1e6 / probe.prof_s):.1f}%, the kernel "
        f"{kernel_us / 1e6:.3f} s")
    for name, us, n in rows[:4]:
        log(f"[12a]   {us / 1e6:8.4f} s {n:6d} x  {name[:80]}")

    # the port's iDMRG at the same chi_max
    psi_d = MPS.from_product_state(model.lat.mps_sites(), VU_XX_INIT,
                                   bc='infinite')
    t0 = time.time()
    info = dmrg.run(psi_d, model, copy.deepcopy(VU_DMRG_OPTIONS),
                    device='cuda')
    E_d = float(info['E'])
    ds = info['sweep_statistics']
    log(f"[12a] iDMRG sweeps " + ', '.join(
        f"{ds['sweep'][k]}: E + 1/pi {ds['E'][k] - VU_E_EXACT:+.3e} chi "
        f"{ds['max_chi'][k]} norm_err {ds['norm_err'][k]:.1e}"
        for k in range(len(ds['E']))))
    log(f"[12a] iDMRG (dmrg.run {VU_DMRG_OPTIONS}): {time.time() - t0:.2f} s, "
        f"E {E_d!r} (E + 1/pi {E_d - VU_E_EXACT:+.3e}), chi {psi_d.chi}; "
        f"VUMPS - iDMRG {E - E_d:+.3e} (at most {VU_IDMRG_MARGIN:.0e})")
    check(E <= E_d + VU_IDMRG_MARGIN, "12a: VUMPS is above iDMRG at the "
          "same chi_max")

    # the last update's three problems, card against host
    names = ['zero-site C1', 'zero-site C2', 'two-site AC']
    check(len(probe.last_update) == 3, "12a: the last update did not "
          "solve three problems")
    for (eff, guess), name in zip(probe.last_update, names):
        vumps_route_check('12a', eff, guess, name)
    # the kernel on the last update's zero- and two-site matvec
    zmv = vumps_kernel('12a', *probe.last[0], VU_ZERO_SITE_STEPS)
    tmv = vumps_kernel('12a', *probe.last[2], MATVEC_STEPS)
    return probe.launches[0], probe.launches[2], zmv, tmv


def phase_vumps_hofstadter(smi, psi7, model7, e7):
    """12b: single-site VUMPS on phase 7's chi=128 Hofstadter state against
    phase 7's iDMRG energy per site; the kernel on a zero- and a one-site
    complex128 matvec at chi=128.  Returns the launches by kind and the
    two matvecs' measurements."""
    from tenpy_tpu_torch.algorithms.vumps import SingleSiteVUMPSEngine
    gg.LAUNCHES = 0
    with VUMPSProbe() as probe:
        t0 = time.time()
        eng = SingleSiteVUMPSEngine(psi7.copy(), model7,
                                    copy.deepcopy(VU_HOF_OPTIONS),
                                    device='cuda')
        init_s = time.time() - t0
        E, psi_out = eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    launches = gg.LAUNCHES
    ss = eng.sweep_stats
    L = eng.psi.L
    log(f"[12b] SingleSiteVUMPSEngine on phase 7's state (L={L}, chi "
        f"{eng.psi.chi[0]}, {eng.psi.dtype}), {VU_HOF_SWEEPS} sweeps: "
        f"{wall:.2f} s (engine init {init_s:.2f} s); card {smi}")
    for k in range(len(ss['E'])):
        log(f"[12b]   sweep {ss['sweep'][k]}: E {ss['E'][k]!r} (- phase 7 "
            f"{ss['E'][k] - e7:+.3e}), max_split_err "
            f"{ss['max_split_err'][k]:.3e}, {ss['time'][k]:.2f} s")
    norm_err = float(np.linalg.norm(eng.psi.norm_test()))
    splits = ss['max_split_err']
    log(f"[12b] E {E!r}, phase 7's iDMRG energy per site {e7!r}: "
        f"{E - e7:+.3e} (at most {VU_IDMRG_MARGIN:.0e}, within "
        f"{VU_HOF_E_TOL:.0e}); norm_test {norm_err:.2e}; split errors "
        f"{[f'{s:.2e}' for s in splits]}; returned MPS {psi_out.dtype}, chi "
        f"{psi_out.chi[0]}")
    check(E <= e7 + VU_IDMRG_MARGIN, "12b: VUMPS is above phase 7's iDMRG")
    check(abs(E - e7) <= VU_HOF_E_TOL, "12b: VUMPS far from phase 7's iDMRG")
    check(norm_err <= VU_HOF_OPTIONS['norm_tol'], "12b: norm_test above "
          "norm_tol")
    check(all(b <= a for a, b in zip(splits, splits[1:])),
          "12b: the split error grew")
    check(psi_out.dtype == torch.complex128, "12b: the state is not "
          "complex128")
    stats = eng.eig_stats
    vumps_eig_summary('12b', stats)
    check_vumps_route('12b', stats)
    check_vumps_launches('12b', probe, stats, launches, {0: 2, 1: 3})
    vumps_timing('12b', eng.update_timing)
    zmv = vumps_kernel('12b', *probe.last[0], VU_ZERO_SITE_STEPS)
    omv = vumps_kernel('12b', *probe.last[1], TE_ONE_SITE_STEPS)
    return probe.launches[0], probe.launches[1], zmv, omv


def phase_vumps_yaml(smi):
    """12c: minimal_DMRG.yml as two-site VUMPS on the infinite Heisenberg
    chain through console_main: the saved energy against the exact one,
    the measurements of the converged state."""
    import shutil
    import tempfile
    import warnings
    from tenpy_tpu_torch.tools import io as tio
    try:
        import yaml  # noqa: F401
    except ImportError:
        raise RuntimeError("phase 12c runs console_main: PyYAML is missing")
    tmp = tempfile.mkdtemp(prefix='chip_smoke_vumps_', dir=os.path.join(
        ROOT, 'build') if os.path.isdir(os.path.join(ROOT, 'build'))
        else None)
    fn = os.path.join(tmp, 'vumps.pkl')
    warnings.filterwarnings('ignore', message='unused options')
    gg.LAUNCHES = 0
    try:
        with VUMPSProbe() as probe:
            t0 = time.time()
            check(tenpy_tpu_torch.console_main(sim_argv(
                SIM_MINIMAL_YML, VU_YAML_OVERRIDES + [
                    f'log_params={SIM_LOG!r}', f'output_filename={fn}']))
                == 0, "console_main failed on minimal_DMRG.yml as VUMPS")
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        warnings.filterwarnings('default', message='unused options')
    launches = gg.LAUNCHES
    res = tio.load(fn)
    E = float(res['energy'])
    meas = res['measurements']
    E_meas = float(np.real(meas['energy_MPO'][-1]))
    chi = int(meas['max_chi'][-1])
    eng = probe.engines[-1]
    log(f"[12c] minimal_DMRG.yml as {type(eng).__name__} "
        f"({VU_YAML_OVERRIDES}): {wall:.2f} s; saved E {E!r}, exact "
        f"{VU_HEIS_EXACT!r}: {E - VU_HEIS_EXACT:+.3e} (tolerance "
        f"{VU_YAML_E_TOL:.0e}); measured (final) energy_MPO {E_meas!r} "
        f"({E_meas - E:+.2e}), max_chi {chi}; saved psi "
        f"{type(res['psi']).__name__} chi {res['psi'].chi}")
    check(abs(E - VU_HEIS_EXACT) <= VU_YAML_E_TOL,
          "12c: the saved energy is not the Heisenberg chain's")
    check(abs(E_meas - E) <= 1e-10 and chi == VU_YAML_CHI,
          "12c: the measurements are not of the converged state")
    stats = eng.eig_stats
    vumps_eig_summary('12c', stats)
    check_vumps_launches('12c', probe, stats, launches, {0: 2, 2: 4})
    vumps_timing('12c', eng.update_timing)
    shutil.rmtree(tmp, ignore_errors=True)


def phase_vumps_real(smi):
    """Phase 12a and 12c on VU_HOST_THREADS host threads; returns the
    launches and matvec measurements of the two f64 VUMPS kernel
    entries."""
    with host_threads(VU_HOST_THREADS, 12):
        t0 = time.time()
        z_n, t_n, zmv, tmv = phase_vumps_xx(smi)
        t1 = time.time()
        phase_vumps_yaml(smi)
    log(f"[12] phase wall: 12a {t1 - t0:.1f} s, 12c {time.time() - t1:.1f} s")
    return (z_n, zmv), (t_n, tmv)


def phase_vumps_complex(smi, hof_state):
    """Phase 12b on VU_HOST_THREADS host threads, from phase 7's state;
    returns the launches and matvec measurements of the two complex128
    VUMPS kernel entries."""
    with host_threads(VU_HOST_THREADS, '12b'):
        t0 = time.time()
        zc_n, o_n, zcmv, omv = phase_vumps_hofstadter(smi, *hof_state)
    log(f"[12] phase wall: 12b {time.time() - t0:.1f} s")
    return (zc_n, zcmv), (o_n, omv)


# finite-temperature purification (phase 13): PurificationTEBD with
# device='cuda'.  13a: the open XX chain (Jz=0: free fermions, Sz
# conserved) from the infinite-T state, imaginary time in stages of
# PU_STAGES by the engine's own DEVICE_SPLIT_THRESHOLD rule, then the last
# PU_CARD_BETA with every update forced onto the card (device_threshold=0),
# to the beta where the central bonds hold chi=256 (above svd_min); 13b:
# the canonical ensemble at Sz=0 with conserved ancilla charges (the
# doubled U(1)xU(1)), every update on the card, against exact
# diagonalization in the sector; 13c: the time split of one saturated
# update, steps by either route, the crossover by N, the profiled step
PU_MODEL = {'L': 32, 'Jxx': 1., 'Jz': 0., 'hz': 0., 'bc_MPS': 'finite'}
PU_OPTIONS = {'trunc_params': {'chi_max': 256, 'svd_min': 1e-10},
              'dt': 0.05, 'order': 2}
PU_CHI = 256
# the beta increments of 13a's run_imaginary stages by the engine's rule and
# the last one on the card (one step of dt); their sum is the beta at which
# the central bonds of the L=32 chain reach chi=256 in the CPU rehearsal
# (tests/rehearse_purification_phase.py: 240 at beta 9, 256 at 10)
PU_STAGES = (4., 2., 2., 1., 0.9)
PU_CARD_BETA = 0.1
# |E - E_trotter| <= PU_E_ABS + PU_E_FACTOR |E| sqrt(sum eps): the error of
# a state cut to weight eps is sqrt(eps) in its amplitude and in E to first
# order; the factor is ten times the largest ratio of the rehearsals
PU_E_ABS, PU_E_FACTOR = 1e-12, 10.
# PurificationMPS.norm_test measures the isometry error of every site's A
# and B forms, one of them converted by Schmidt values down to svd_min
# (1e-10): roundoff times up to 1 / svd_min (the rehearsal: 1.1e-10)
PU_NORM_TOL = 1e-8
PU_ROUTE_TOL = 1e-12
PU_CANON_MODEL = dict(PU_MODEL, L=12)
PU_CANON_BETA = 2.
# the canonical run against the Trotterized sector ED (truncation only, as
# in 13a) and against the untrotterized one: the Trotter error of dt=0.05,
# which the rehearsal measures, times ten
PU_CANON_TROTTER_TOL = 1e-4
PU_CROSS_BONDS = (1, 2, 3, 4, 5, 6, 8, 16)
PU_CROSS_REPEATS = 2
PU_HOST_THREADS = 1
PU_TIMED_STEPS = 2
PU_GATE_STEPS = ['U.theta over (p0*,p1*)']


def xx_purification_energies(L, beta, dt, Jxx=1.):
    """``(E_trotter, E_exact)`` of the open XX chain's purification at
    inverse temperature ``beta`` (grand canonical): free fermions, each
    bond gate ``exp(-dt/2 H_b)`` is Gaussian with the single-particle
    propagator ``exp(-dt/2 h_b)``; ``update_imag``'s step is the sweep of
    the bonds there and back, so ``rho = Gamma(t t^T)`` with ``t`` the
    product of the propagators and ``<c^dagger c> = G (1 + G)^-1``,
    ``G = t t^T``.  Untrotterized: ``sum_k eps_k / (exp(beta eps_k) + 1)``,
    ``eps_k = Jxx cos(k pi / (L + 1))``."""
    h = np.diag(np.full(L - 1, Jxx / 2.), 1)
    h = h + h.T
    eps = np.linalg.eigvalsh(h)
    E_exact = float(np.sum(eps / (np.exp(beta * eps) + 1.)))
    c, s = np.cosh(0.25 * dt * Jxx), np.sinh(0.25 * dt * Jxx)
    step = np.eye(L)
    for b in list(range(L - 1)) + list(range(L - 2, -1, -1)):
        g = np.eye(L)
        g[b, b] = g[b + 1, b + 1] = c
        g[b, b + 1] = g[b + 1, b] = -s
        step = g @ step
    t = np.linalg.matrix_power(step, int(round(beta / 2. / dt)))
    G = t @ t.T
    return float(np.sum(h * (G @ np.linalg.inv(np.eye(L) + G)))), E_exact


def xx_sector_energies(L, beta, dt, Jxx=1.):
    """``(E_trotter, E_exact)`` of the open XX chain in the Sz=0 sector
    (the canonical ensemble), by exact diagonalization in the sector: the
    bond gates as matrices there, applied in ``update_imag``'s order."""
    import itertools
    import scipy.linalg
    states = [s for s in itertools.product((0, 1), repeat=L)
              if sum(s) == L // 2]
    index = {s: k for k, s in enumerate(states)}
    Hb = []
    for b in range(L - 1):
        m = np.zeros((len(states), len(states)))
        for s, k in index.items():
            if s[b] != s[b + 1]:
                f = list(s)
                f[b], f[b + 1] = f[b + 1], f[b]
                m[index[tuple(f)], k] = Jxx / 2.
        Hb.append(m)
    H = sum(Hb)
    w = np.linalg.eigvalsh(H)
    z = np.exp(-beta * (w - w[0]))
    E_exact = float(np.sum(w * z) / np.sum(z))
    step = np.eye(len(states))
    for b in list(range(L - 1)) + list(range(L - 2, -1, -1)):
        step = scipy.linalg.expm(-0.5 * dt * Hb[b]) @ step
    T = np.linalg.matrix_power(step, int(round(beta / 2. / dt)))
    rho = T @ T.T
    return float(np.trace(rho @ H) / np.trace(rho)), E_exact


class PurificationProbe:
    """Within ``with``: the kernel launches counted around each card update
    of :class:`PurificationTEBD` by its route (restored on exit)."""

    def __init__(self):
        self.launches = {'device': 0, 'device_split': 0}
        self.updates = {'device': 0, 'device_split': 0}
        self._orig = None

    def __enter__(self):
        from tenpy_tpu_torch.algorithms.purification import PurificationTEBD
        self._cls = PurificationTEBD
        self._orig = orig = PurificationTEBD._update_device
        probe = self

        def run(eng, i, U_bond, route):
            n0 = gg.LAUNCHES
            out = orig(eng, i, U_bond, route)
            probe.launches[route] += gg.LAUNCHES - n0
            probe.updates[route] += 1
            return out

        PurificationTEBD._update_device = run
        return self

    def __exit__(self, *exc):
        self._cls._update_device = self._orig


def pu_energy(eng):
    return float(np.sum(eng.bond_energies())) / float(np.real(
        eng.psi.overlap(eng.psi)))


def pu_route_summary(tag, stats):
    """Per route: updates, their N range and seconds."""
    for route in ('device', 'device_split', 'host'):
        sel = [s for s in stats if s[2] == route]
        if sel:
            Ns = [s[1] for s in sel]
            sec = sum(s[3] for s in sel)
            log(f"[{tag}]   {route}: {len(sel)} updates, N {min(Ns)}-"
                f"{max(Ns)}, {sec:.2f} s ({1e3 * sec / len(sel):.2f} ms "
                f"each)")


def check_pu_launches(tag, probe, stats, launches):
    """One launch per 'device' update, none per 'device_split' one, and
    none outside the card's updates."""
    n_dev = sum(1 for s in stats if s[2] == 'device')
    log(f"[{tag}] kernel launches {launches}: {probe.launches['device']} "
        f"around {probe.updates['device']} 'device' updates (stats "
        f"{n_dev}), {probe.launches['device_split']} around "
        f"{probe.updates['device_split']} 'device_split' updates")
    check(probe.launches['device'] == probe.updates['device'] == n_dev,
          f"{tag}: kernel launches differ from the card's updates")
    check(probe.launches['device_split'] == 0,
          f"{tag}: a 'device_split' update launched the kernel")
    check(launches == probe.launches['device'],
          f"{tag}: kernel launches outside the card's updates")


def pu_pair_theta(A, S, B):
    """``A S B`` of an update's split, legs ``vL p0 q0 p1 q1 vR``."""
    A = A.replace_labels(['p', 'q'], ['p0', 'q0'])
    B = B.replace_labels(['p', 'q'], ['p1', 'q1'])
    return npc.tensordot(A.scale_axis(S, 'vR'), B,
                         axes=[['vR'], ['vL']]).itranspose(
        ['vL', 'p0', 'q0', 'p1', 'q1', 'vR'])


def pu_route_check(tag, eng, i):
    """Bond ``i``'s update by the card and by the host on the same theta:
    sorted S and ``A S B`` (relative) to PU_ROUTE_TOL, never A or B entry
    by entry."""
    U = eng._U[0][i]
    eng._update_index = eng._find_update_index(i, U)
    A_d, S_d, B_d, err_d, ren_d = eng._update_device(i, U, 'device')
    A_h, S_h, B_h, err_h, ren_h = eng._update_host(i, U)
    check(len(S_d) == len(S_h), f"{tag}: the card kept {len(S_d)} Schmidt "
          f"values, the host {len(S_h)}")
    dS = float(np.max(np.abs(np.sort(S_d) - np.sort(S_h))))
    th_d, th_h = pu_pair_theta(A_d, S_d, B_d), pu_pair_theta(A_h, S_h, B_h)
    rel = float(np.linalg.norm((th_d.to_numpy() - th_h.to_numpy()).ravel())
                / np.linalg.norm(th_h.to_numpy().ravel()))
    log(f"[{tag}] bond {i} (chi {len(S_h)}, N {eng.theta_size(i)}), card "
        f"against host on the same theta: S {dS:.2e}, A S B {rel:.2e} "
        f"(relative), err {err_d.eps:.3e} / {err_h.eps:.3e}, renorm "
        f"{abs(ren_d / ren_h - 1.):.1e} apart (tolerance {PU_ROUTE_TOL:.0e})")
    check(dS <= PU_ROUTE_TOL and rel <= PU_ROUTE_TOL,
          f"{tag}: the card's update is not the host's")


def phase_purification_xx(smi):
    """13a: the XX chain's purification to the beta of chi=256 on the
    card, held to the Trotterized free-fermion energy; routes, launches,
    the card's update against the host's on a saturated bond, the kernel
    on its gate.  Returns the engine, the launches and the gate's
    measurement."""
    from tenpy_tpu_torch.algorithms.purification import PurificationTEBD
    from tenpy_tpu_torch.networks.purification_mps import PurificationMPS
    model = XXZChain(dict(PU_MODEL))
    L = PU_MODEL['L']
    psi = PurificationMPS.from_infiniteT(model.lat.mps_sites())
    eng = PurificationTEBD(psi, model, copy.deepcopy(PU_OPTIONS),
                           device='cuda')
    dt = PU_OPTIONS['dt']
    gg.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    beta = 0.
    t0 = time.time()
    with PurificationProbe() as probe:
        for k, dbeta in enumerate(PU_STAGES + (PU_CARD_BETA,)):
            if k == len(PU_STAGES):
                n_rule = len(eng.update_stats)
                eng.options['device_threshold'] = 0
            ts = time.time()
            n0 = len(eng.update_stats)
            eng.run_imaginary(dbeta)
            torch.cuda.synchronize()
            beta += dbeta
            st = eng.update_stats[n0:]
            log(f"[13a] beta {beta:.1f}: {time.time() - ts:.2f} s, "
                f"{len(st)} updates ({sum(s[2] == 'device' for s in st)} on "
                f"the card), chi max {max(psi.chi)}, centre "
                f"{psi.chi[L // 2 - 1]}, sum eps {eng.trunc_err.eps:.3e}")
    del eng.options['device_threshold']
    wall = time.time() - t0
    launches = gg.LAUNCHES
    E = pu_energy(eng)
    E_trot, E_exact = xx_purification_energies(L, beta, dt)
    eps = eng.trunc_err.eps
    tol = PU_E_ABS + PU_E_FACTOR * abs(E) * np.sqrt(eps)
    norm_err = float(np.max(psi.norm_test()))
    log(f"[13a] PurificationTEBD on the XX chain {PU_MODEL} from the "
        f"infinite-T state, {PU_OPTIONS}, to beta={beta}: {wall:.2f} s; "
        f"card {smi}")
    log(f"[13a] E(beta) {E!r}, Trotterized free fermions {E_trot!r}: "
        f"{E - E_trot:+.3e} (tolerance {tol:.2e} from sum eps {eps:.3e}); "
        f"untrotterized {E_exact!r}: {E - E_exact:+.3e}; norm_test "
        f"{norm_err:.2e}; chi {psi.chi}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(abs(E - E_trot) <= tol, "13a: E(beta) is not the Trotterized "
          "free-fermion energy within its tolerance")
    check(norm_err <= PU_NORM_TOL, "13a: norm_test above its tolerance")
    check(max(psi.chi) == PU_CHI, f"13a: the central bonds do not hold "
          f"chi={PU_CHI}")
    stats = eng.update_stats
    log(f"[13a] by the engine's rule (beta 0-{sum(PU_STAGES):.1f}):")
    pu_route_summary('13a', stats[:n_rule])
    log(f"[13a] forced onto the card (the last {PU_CARD_BETA}):")
    pu_route_summary('13a', stats[n_rule:])
    thr = mc.DEVICE_SPLIT_THRESHOLD
    wrong = [s for s in stats[:n_rule] if s[2] != (
        'device' if thr is not None and s[1] >= thr else 'host')]
    log(f"[13a] DEVICE_SPLIT_THRESHOLD {thr}: {len(wrong)} updates off "
        f"its route; {len(stats) - n_rule} forced updates")
    check(not wrong, "13a: an update took the wrong route")
    check(stats[n_rule:] and all(s[2] == 'device' for s in stats[n_rule:]),
          "13a: a forced update ran on the host")
    check_pu_launches('13a', probe, stats, launches)
    # a saturated bond: the card's update against the host's
    centre = L // 2
    check(len(psi.get_SL(centre)) == PU_CHI, "13a: the centre bond is not "
          "saturated")
    pu_route_check('13a', eng, centre)
    # the kernel on the centre's gate
    theta = eng.pipe_theta(psi.get_theta(centre - 1, 2))
    theta_p = eng.pack_theta(theta)
    U = eng._U[0][centre]
    eng._update_index = eng._find_update_index(centre, U)
    G = eng.packed_gate(theta.get_leg('p0'), theta.get_leg('p1'), U)
    _, calls = recorded_calls(lambda: eng.apply_gate(G, theta_p))
    check(len(calls) == 1, "13a: the gate is not one tensordot")
    gate = measure_contractions(calls, PU_GATE_STEPS, '13a', what='gate')
    return eng, launches, gate


def phase_purification_canonical(smi):
    """13b: the canonical ensemble at Sz=0 with conserved ancilla charges
    on the card, against exact diagonalization in the sector."""
    from tenpy_tpu_torch.algorithms.purification import PurificationTEBD
    from tenpy_tpu_torch.networks.purification_mps import PurificationMPS, \
        convert_model_purification_canonical_conserve_ancilla_charge as conv
    model = XXZChain(dict(PU_CANON_MODEL))
    L = PU_CANON_MODEL['L']
    psi = PurificationMPS.from_infiniteT_canonical(
        model.lat.mps_sites(), [0], conserve_ancilla_charge=True)
    eng = PurificationTEBD(psi, conv(model), dict(
        copy.deepcopy(PU_OPTIONS), device_threshold=0), device='cuda')
    gg.LAUNCHES = 0
    t0 = time.time()
    with PurificationProbe() as probe:
        eng.run_imaginary(PU_CANON_BETA)
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = gg.LAUNCHES
    E = pu_energy(eng)
    t1 = time.time()
    E_trot, E_exact = xx_sector_energies(L, PU_CANON_BETA, PU_OPTIONS['dt'])
    eps = eng.trunc_err.eps
    tol = PU_E_ABS + PU_E_FACTOR * abs(E) * np.sqrt(eps)
    chinfo = psi.sites[0].leg.chinfo
    log(f"[13b] the canonical ensemble (Sz=0, {chinfo.names}) of the XX "
        f"chain L={L}, every update on the card, to beta={PU_CANON_BETA}: "
        f"{wall:.2f} s; chi {psi.chi}; sector ED ({time.time() - t1:.1f} s)")
    log(f"[13b] E {E!r}, Trotterized sector ED {E_trot!r}: {E - E_trot:+.3e} "
        f"(tolerance {tol:.2e}); untrotterized {E_exact!r}: "
        f"{E - E_exact:+.3e} (Trotter error, at most "
        f"{PU_CANON_TROTTER_TOL:.0e}); Sz "
        f"{float(np.sum(psi.expectation_value('Sz'))):+.1e}")
    check(chinfo.qnumber == 2, "13b: the charges are not doubled")
    check(abs(E - E_trot) <= tol, "13b: E is not the sector ED's")
    check(abs(E - E_exact) <= PU_CANON_TROTTER_TOL,
          "13b: E is not the sector's thermal energy within the Trotter "
          "error")
    stats = eng.update_stats
    pu_route_summary('13b', stats)
    check(all(s[2] == 'device' for s in stats), "13b: an update ran on "
          "the host")
    check_pu_launches('13b', probe, stats, launches)
    return launches


def pu_split_plan(eng, C, multiple):
    """The layout and plan of the card's split of packed ``C``, its
    sectors and groups rounded to ``multiple``."""
    q0 = np.zeros(C.legs[0].chinfo.qnumber, np.int64)
    bond = ps.bond_layout(C.legs, C.qtotal, q0, multiple=multiple,
                          full_rank=True)
    return bond, ps.split_plan(C, bond, q0, group_multiple=multiple)


def pu_time_parts(eng, i):
    """One update of bond ``i`` on the card, part by part (host seconds,
    each part synchronised): host theta, gate build, pack, kernel, layout
    and plan, batched SVD, unpack, host store."""
    from tenpy_tpu_torch.algorithms.purification import PACK_MULTIPLE
    psi = eng.psi
    U = eng._U[0][i]
    parts = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = time.perf_counter() - t
        return out

    theta = timed('host theta', lambda: eng.pipe_theta(
        psi.get_theta(i - 1, 2)))
    eng._update_index = eng._find_update_index(i, U)
    eng._gates = {}
    G = timed('gate build', lambda: eng.packed_gate(
        theta.get_leg('p0'), theta.get_leg('p1'), U))
    theta_p = timed('pack', lambda: eng.pack_theta(theta))
    C = timed('kernel', lambda: eng.apply_gate(G, theta_p))
    chi_max, svd_min, trunc_cut = eng.split_params()
    bond, plan = timed('layout and plan',
                       lambda: pu_split_plan(eng, C, PACK_MULTIPLE))
    out = timed('batched SVD', lambda: ps.split_truncate(
        C, plan, chi_max, svd_min, trunc_cut=trunc_cut))
    A, S, B, err, ren = timed('unpack', lambda: eng.unpack_split(
        out[0], out[1], out[2], out[3], out[4], bond, theta))
    p2 = psi.copy()

    def store():
        p2.norm *= ren
        p2.set_SR(i - 1, S)
        p2.set_B(i - 1, A, form='A')
        p2.set_B(i, B, form='B')

    timed('host store', store)
    return parts


def pu_steps(eng, threshold, n):
    """``n`` update_imag steps with ``device_threshold=threshold``: their
    seconds and updates."""
    eng.options['device_threshold'] = threshold
    steps = []
    for _ in range(n):
        n0 = len(eng.update_stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.update_imag(1)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0, eng.update_stats[n0:]))
    del eng.options['device_threshold']
    return steps


def phase_purification_timing(eng, smi):
    """13c on 13a's saturated state: one update by part, the median of a
    few update_imag steps by either route, one profiled card step (idle
    share), the crossover of the card's and the host's update by N, the
    host SVD against the batched split (unpadded and padded) on the
    saturated bond."""
    from tenpy_tpu_torch.algorithms.purification import PACK_MULTIPLE
    from tenpy_tpu_torch.linalg.truncation import svd_theta
    psi = eng.psi
    L = psi.L
    centre = L // 2
    reps = [pu_time_parts(eng, centre) for _ in range(3)]
    tot = [sum(r.values()) for r in reps]
    log(f"[13c] one card update of the centre bond (N "
        f"{eng.theta_size(centre)}), by part (median of 3, ms): " + ', '.join(
            f"{k} {1e3 * statistics.median(r[k] for r in reps):.2f}"
            for k in reps[0]) + f"; total {1e3 * statistics.median(tot):.2f}")
    torch.cuda.reset_peak_memory_stats()
    for name, thr, n in (('host', None, 1), ('card', 0, PU_TIMED_STEPS)):
        steps = pu_steps(eng, thr, n)
        up = steps[0][1]
        log(f"[13c] update_imag step at chi={max(psi.chi)} on the {name}'s "
            f"route: median {statistics.median(s for s, _ in steps):.3f} s "
            f"of {[round(s, 3) for s, _ in steps]} s ({len(up)} updates, "
            f"{sum(u[2] == 'device' for u in up)} on the card; the updates "
            f"{sum(u[3] for u in up):.3f} s, the rest the final canonical "
            f"form)")
    log(f"[13c] peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB")
    eng.options['device_threshold'] = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        eng.update_imag(1)
        torch.cuda.synchronize()
        prof_s = time.time() - t0
    del eng.options['device_threshold']
    t0 = time.time()
    busy, svd_us, kernel_us, rows = device_time(prof)
    log(f"[13c] profiled card step {prof_s:.2f} s: device busy "
        f"{busy / 1e6:.3f} s, idle {100 * (1 - busy / 1e6 / prof_s):.1f}%; "
        f"SVD {svd_us / 1e6:.3f} s, the kernel {kernel_us / 1e6:.4f} s "
        f"(the trace read in {time.time() - t0:.1f} s)")
    for name, us, n in rows[:5]:
        log(f"[13c]   {us / 1e6:8.4f} s {n:6d} x  {name[:80]}")
    # the crossover: card and host on the same theta by N
    rows = []
    for b in PU_CROSS_BONDS:
        U = eng._U[0][b]
        eng._update_index = eng._find_update_index(b, U)
        N = eng.theta_size(b)
        t = {'host': [], 'cold': [], 'warm': []}
        for _ in range(PU_CROSS_REPEATS):
            forget_packed_plans()
            ps._SPLIT_PLAN_CACHE.clear()
            eng._gates = {}
            for kind in ('cold', 'warm'):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng._update_device(b, U, 'device')
                t[kind].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            eng._update_host(b, U)
            t['host'].append(time.perf_counter() - t0)
        med = {k: statistics.median(v) for k, v in t.items()}
        rows.append((N, med, max(c / h for c, h in zip(t['cold'],
                                                       t['host'])),
                     max(w / h for w, h in zip(t['warm'], t['host']))))
        log(f"[13c] bond {b}: N {N}: host {1e3 * med['host']:.2f} ms, card "
            f"cold {1e3 * med['cold']:.2f} ms, warm {1e3 * med['warm']:.2f} "
            f"ms; card/host worst cold {rows[-1][2]:.2f}, warm "
            f"{rows[-1][3]:.2f}")
    wins = sorted(N for N, _, c, _ in rows if c < 1.)
    log(f"[13c] crossover: the card's update (its plans built anew) wins in "
        f"every run at N = {wins}; with its plans cached at N = "
        f"{sorted(N for N, _, _, w in rows if w < 1.)}; "
        f"DEVICE_SPLIT_THRESHOLD = {mc.DEVICE_SPLIT_THRESHOLD}")
    # the host SVD against the batched split on the saturated bond
    i = centre
    U = eng._U[0][i]
    eng._update_index = eng._find_update_index(i, U)
    th = eng._gate_theta(i, U).combine_legs(
        [['vL', 'p0', 'q0'], ['p1', 'q1', 'vR']], qconj=[+1, -1])
    t_host = []
    for _ in range(3):
        t0 = time.perf_counter()
        svd_theta(th, eng.trunc_params, inner_labels=['vR', 'vL'])
        t_host.append(time.perf_counter() - t0)
    theta = eng.pipe_theta(psi.get_theta(i - 1, 2))
    G = eng.packed_gate(theta.get_leg('p0'), theta.get_leg('p1'), U)
    chi_max, svd_min, trunc_cut = eng.split_params()
    res = []
    for m in (PACK_MULTIPLE, mc.BUCKET_MULTIPLE):
        C = eng.apply_gate(G, pk.pack(theta, multiple=m,
                                      pad_labels=('vL', 'vR'),
                                      device=eng.device))
        _, plan = pu_split_plan(eng, C, m)
        ms = cuda_ms(lambda: ps.split_truncate(
            C, plan, chi_max, svd_min, trunc_cut=trunc_cut), reps=5)
        res.append(f"sectors rounded to {m}: {ms:.2f} ms on "
                   f"{[(g.N, g.R, g.C) for g in plan.groups]}")
    log(f"[13c] the centre bond's split: host svd_theta "
        f"{1e3 * statistics.median(t_host):.2f} ms; the batched split on the "
        f"card, " + '; '.join(res))


def phase_purification(smi):
    """Phase 13: 13a, 13b, 13c on PU_HOST_THREADS host threads (restored
    after); returns 13a's gate launches and the gate's measurement."""
    with host_threads(PU_HOST_THREADS, 13):
        t0 = time.time()
        eng, launches, gate = phase_purification_xx(smi)
        t1 = time.time()
        phase_purification_canonical(smi)
        t2 = time.time()
        phase_purification_timing(eng, smi)
    log(f"[13] phase wall: 13a {t1 - t0:.1f} s, 13b {t2 - t1:.1f} s, 13c "
        f"{time.time() - t2:.1f} s")
    return launches, gate


# TeNPy's plane-wave excitations (phase 14): the S=1 Heisenberg chain (L=2,
# Sz conserved) by the port's VUMPS on the card, two-site stages at chi 32,
# 64 and 128 (svd_min 1e-12, the subspace-expansion mixer), then
# single-site VUMPS sweeps at chi=128; its magnon (qtotal_change=[2],
# Sz=+1) by PlaneWaveExcitationEngine on the card.  The Haldane gap at pi:
# 0.41047925 (DMRG, Nakano and Terai 2009; White and Huse 1993 give
# 0.41050(2))
EX_MODEL = {'S': 1, 'L': 2, 'Jx': 1., 'Jy': 1., 'Jz': 1.,
            'bc_MPS': 'infinite', 'conserve': 'Sz'}
EX_INIT = ['1.0', '-1.0']
EX_CHIS = (32, 64, 128)
EX_CHI = EX_CHIS[-1]
# sweeps per VUMPS stage (cuts from 4 and 6: the gap at chi=128 came out
# 1.9e-9 from the reference after 4 and 6 two-site sweeps per stage and
# after 3, measured on one H100)
EX_TWO_SITE_SWEEPS = 2
EX_SINGLE_SWEEPS = 3
EX_GAP, EX_GAP_TOL = 0.41047925, 1e-4
# 14a's momenta: two, a cut from five (0 to pi): in a two-site cell p + pi
# is the same momentum as p (the phase per cell is exp(2ip)), and -p is
# degenerate with p by reflection, so pi/2..pi holds every distinct energy;
# a card solve at chi=128 took 39-61 s (35-40 Lanczos steps at 0.74-1.43 s
# per matvec, measured on one H100)
EX_MOMENTA = [np.pi / 2, np.pi]
# the TFI dispersion at three momenta, a cut from five: 0..pi/2 holds every
# distinct energy of the two-site cell, as above
EX_TFI_MOMENTA = list(np.linspace(0., np.pi / 2, 3))
EX_CHARGE = [2]
EX_LANCZOS = {'N_max': 60}
# 14a's solves stop once the Ritz pair's squared residual is below 1e-10
# rather than the default 1e-14 (a cut of Krylov depth: the energy error is
# about the squared residual over the sector's gap, far inside the gap's
# 1e-4; the Ritz value and the Rayleigh quotient of its vector stay equal
# at any depth)
EX_MAGNON_LANCZOS = dict(EX_LANCZOS, P_tol=1e-10)
# 14a's explicit sums stop at 1e-11 rather than the default 1e-10: the
# truncated series make the effective H hermitian only to sum_tol, and the
# Ritz value and the Rayleigh quotient of its vector differ by about that
# much (1.6e-10 at 1e-10 on the chi=48 state of the CPU rehearsal, 3.7e-13
# at 1e-12 on JAX's chi=24 state).  The GMRES sums (14b, 14c) are exact to
# their residual and need 4x fewer transfer-matrix applications, but their
# Gram-Schmidt reads a scalar per step: a card matvec took 0.94 s with them
# against 0.74 s with the explicit ones at chi=128 (measured on one H100)
EX_MAGNON_SUMS = {'sum_method': 'explicit', 'sum_tol': 1e-11}
EX_GMRES = {'sum_method': 'GMRES', 'GMRES_params': {'N_max': 30,
                                                   'res': 1e-12}}
# host threads of the phase (restored after): its host work is many small
# block operations, faster on one thread (phases 12 and 13)
EX_HOST_THREADS = 1
# engine.energy(p, X) against the Lanczos energy; the card's matvec against
# the host's on the final X; the TFI dispersion; JAX's gap on the card; the
# GMRES sums against the explicit ones
EX_ENERGY_TOL, EX_MATVEC_TOL, EX_TFI_TOL = 1e-10, 1e-12, 1e-8
EX_JAX_TOL, EX_SUM_TOL = 1e-10, 1e-10
EX_TFI_G = 1.5
EX_TFI_MODEL = {'L': 2, 'J': 1., 'g': EX_TFI_G, 'bc_MPS': 'infinite',
                'conserve': None}
EX_REF = os.path.join(ROOT, 'tests', 'benchmark_data',
                      'excitation_reference.npz')
EX_TRANSFER_STEPS = ['ARc.R over vR*/vL*', 'W.R over (wR,p)',
                     'AL.R over (vR,p)']
EX_HOST_MATVEC_NOTE_S = 30.
# 14c's profiled solve: Lanczos capped at this many steps
EX_PROFILE_STEPS = 2


def ex_vumps_options(chi, single=False):
    if single:
        return {'max_sweeps': EX_SINGLE_SWEEPS, 'min_sweeps': 2,
                'max_E_err': 1e-13, 'max_split_err': 1e-9,
                'check_overlap': False, 'norm_tol': 1e-10}
    return {'trunc_params': {'chi_max': chi, 'svd_min': 1e-12},
            'max_sweeps': EX_TWO_SITE_SWEEPS,
            'min_sweeps': EX_TWO_SITE_SWEEPS, 'mixer': 'SubspaceExpansion',
            'mixer_params': {'amplitude': 1e-5, 'disable_after': 2},
            'max_E_err': 1e-12, 'max_split_err': 1e-2,
            'check_overlap': False, 'norm_tol': 1e-10}


def ex_rel(a, b):
    """``|a - b| / |b|`` of two X lists (host Arrays)."""
    num = sum(float(npc.norm(x - y)) ** 2 for x, y in zip(a, b)) ** .5
    return num / sum(float(npc.norm(y)) ** 2 for y in b) ** .5


def ex_ground_states(smi):
    """14a's ground states: two-site VUMPS stages at EX_CHIS, each from
    the last one's state, then single-site VUMPS at EX_CHI; returns the
    model and the uniform states by chi."""
    from tenpy_tpu_torch.algorithms.vumps import SingleSiteVUMPSEngine, \
        TwoSiteVUMPSEngine
    model = SpinChain(dict(EX_MODEL))
    psi = MPS.from_product_state(model.lat.mps_sites(), EX_INIT,
                                 bc='infinite')
    states = {}
    for chi in EX_CHIS + ('single',):
        t0 = time.time()
        if chi == 'single':
            eng = SingleSiteVUMPSEngine(psi, model,
                                        ex_vumps_options(EX_CHI, True),
                                        device='cuda')
        else:
            eng = TwoSiteVUMPSEngine(psi, model, ex_vumps_options(chi),
                                     device='cuda')
        E, psi = eng.run()
        ss = eng.sweep_stats
        n_card = sum(1 for s in eng.eig_stats if s[2] == 'device')
        log(f"[14a] {type(eng).__name__} (chi_max "
            f"{EX_CHI if chi == 'single' else chi}): {time.time() - t0:.2f}"
            f" s, {len(ss['E'])} sweeps, E {E!r}, chi {eng.psi.chi}, "
            f"max_split_err {ss['max_split_err'][-1]:.2e}, eigensolves on "
            f"the card {n_card} of {len(eng.eig_stats)}")
        states[EX_CHI if chi == 'single' else chi] = eng.psi
    return model, states


def ex_engine(u, model, options=None, device='cuda'):
    opts = {'lanczos_params': dict(EX_LANCZOS)}
    opts.update(options or {})
    from tenpy_tpu_torch.algorithms.plane_wave_excitation import \
        PlaneWaveExcitationEngine
    return PlaneWaveExcitationEngine(u, model, opts, device=device)


def ex_matvecs(eng, p, X):
    """The effective H on ``X`` (host Arrays) by the card's route and the
    host's: ``(card, host, card seconds, host seconds, card's first call
    seconds)``; the card's seconds are those of its second call (its
    plans cached), the first call's builds them."""
    T = eng.tensors('device')
    Hc = eng._effective_H(p, T)
    Xp = T.vector(X)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Hc.matvec(Xp)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = T.to_host(Hc.matvec(T.vector(X)), X)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = eng._effective_H(p, eng.tensors('host')).matvec(X)
    return card, host, card_s, time.perf_counter() - t0, first_s


def phase_excitations_magnon(smi, model, u):
    """14a: the magnon dispersion of the chi=128 state on the card at
    EX_MOMENTA: the gap at pi against the Haldane gap, the
    minimum at pi, every solve on the card, launches equal to the
    tensordots run, ``energy`` against the Lanczos energy, the card's
    matvec against the host's on the final X.  Returns the engine, the
    final X, the launches and the host matvec's seconds."""
    eng = ex_engine(u, model, dict(EX_MAGNON_SUMS,
                                   lanczos_params=dict(EX_MAGNON_LANCZOS)))
    gg.LAUNCHES = 0                    # count the main path's launches only
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    gaps, per_run, X_pi, E_pi = [], [], None, None
    for p in EX_MOMENTA:
        n0 = gg.LAUNCHES
        Es, psis, N = eng.run(p, qtotal_change=EX_CHARGE)
        per_run.append(gg.LAUNCHES - n0)
        gaps.append(float(np.real(Es[0])))
        X_pi, E_pi = psis[0]._X, gaps[-1]
        if p == EX_MOMENTA[0]:
            torch.cuda.synchronize()
            log(f"[14a]   first solve {time.time() - t0:.2f} s (packing "
                f"included)")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = gg.LAUNCHES
    stats = eng.excitation_stats
    matvec_launches = sum(st['tensordots'] for st in stats)
    log(f"[14a] PlaneWaveExcitationEngine on the chi={EX_CHI} state "
        f"(chi {u.chi}), qtotal_change={EX_CHARGE}, {len(EX_MOMENTA)} "
        f"momenta: {wall:.2f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; card {smi}")
    for p, E, st, n in zip(EX_MOMENTA, gaps, stats, per_run):
        its = np.asarray(st['sum_iterations'])
        log(f"[14a]   p={p:.4f}: E {E!r}, N {st['N']}, {st['route']}, "
            f"{st['steps']} Lanczos steps, {st['matvecs']} matvecs, sum "
            f"terms per matvec right {its[:, 0].mean():.1f} left "
            f"{its[:, 1].mean():.1f}, {st['host_reads']} host reads, "
            f"{st['tensordots']} tensordots + {st['guess_tensordots']} in "
            f"the guess, {n} launches, {st['seconds']:.2f} s")
    gap = gaps[-1]
    log(f"[14a] gap at pi {gap!r}: {gap - EX_GAP:+.3e} from {EX_GAP} "
        f"(tolerance {EX_GAP_TOL:.0e}); dispersion "
        f"{[round(g, 6) for g in gaps]}")
    check(abs(gap - EX_GAP) <= EX_GAP_TOL, "14a: the gap at pi is not the "
          "Haldane gap")
    check(gap <= min(gaps) + 1e-12, "14a: the dispersion's minimum is not "
          "at pi")
    check(all(st['route'] == 'device' for st in stats),
          "14a: a solve did not take the card's route")
    check(all(n == st['tensordots'] + st['guess_tensordots']
              for n, st in zip(per_run, stats)) and launches == sum(per_run),
          "14a: kernel launches differ from the tensordots run")
    log(f"[14a] launches {launches}: {matvec_launches} in the solves' "
        f"matvecs (the plane-wave entry's count), "
        f"{launches - matvec_launches} in the guesses' zero-site eigensolves")
    E_x = eng.energy(np.pi, X_pi)
    log(f"[14a] energy(pi, X) {E_x!r} against the Lanczos energy: "
        f"{E_x - E_pi:+.2e} (tolerance {EX_ENERGY_TOL:.0e})")
    check(abs(E_x - E_pi) <= EX_ENERGY_TOL, "14a: energy(p, X) differs "
          "from the Lanczos energy")
    card, host, card_s, host_s, _ = ex_matvecs(eng, np.pi, X_pi)
    rel = ex_rel(card, host)
    log(f"[14a] matvec on the final X at pi, card against host: rel_err "
        f"{rel:.2e} (tolerance {EX_MATVEC_TOL:.0e}); card {1e3 * card_s:.1f}"
        f" ms, host {host_s:.2f} s"
        + (" (past 30 s: timed once)" if host_s > EX_HOST_MATVEC_NOTE_S
           else ""))
    check(rel <= EX_MATVEC_TOL, "14a: the card's matvec differs from the "
          "host's")
    for x in card:
        check(all(bool(torch.isfinite(b).all()) for b in x._data),
              "14a: non-finite matvec output")
    return eng, X_pi, matvec_launches, host_s


def phase_excitations_exact(smi):
    """14b: the TFI dispersion through PlaneWaveExcitations on the card
    against the exact one; JAX's charged-magnon gap on the card from
    JAX's uniform state; the GMRES sums against the explicit ones.
    Returns the TFI state's engine."""
    from tenpy_tpu_torch.algorithms.vumps import SingleSiteVUMPSEngine
    from tenpy_tpu_torch.models.tf_ising import TFIChain
    from tenpy_tpu_torch.simulations.ground_state_search import \
        PlaneWaveExcitations
    m = TFIChain(dict(EX_TFI_MODEL))
    psi = MPS.from_product_state(m.lat.mps_sites(), ['up', 'up'],
                                 bc='infinite')
    dmrg.run(psi, m, {'trunc_params': {'chi_max': 12, 'svd_min': 1e-10},
                      'max_sweeps': 10, 'mixer': True}, device='cuda')
    eng_v = SingleSiteVUMPSEngine(psi, m, {
        'max_sweeps': 30, 'max_E_err': 1e-13, 'max_split_err': 1e-9,
        'check_overlap': False}, device='cuda')
    eng_v.run()
    t0 = time.time()
    sim = PlaneWaveExcitations(
        {'model_class': 'TFIChain', 'model_params': dict(EX_TFI_MODEL),
         'algorithm_params': {'lanczos_params': {'N_max': 40},
                              'device_threshold': 0},
         'momenta': EX_TFI_MOMENTA, 'save_psi': False,
         'output_filename': None,
         'log_params': SIM_LOG}, ground_state_data=eng_v.psi, device='cuda')
    with sim:
        res = sim.run()
    eps = lambda k: 2 * np.sqrt(1 + EX_TFI_G ** 2  # noqa: E731
                                - 2 * EX_TFI_G * np.cos(k))
    errs = [Es[0] - min(eps(p), eps(p + np.pi))
            for p, Es in zip(res['momenta'], res['excitation_energies'])]
    routes = [st['route'] for st in sim.engine.excitation_stats]
    log(f"[14b] TFI (g={EX_TFI_G}, chi {eng_v.psi.chi}) through "
        f"PlaneWaveExcitations on the card: {time.time() - t0:.2f} s, "
        f"routes {routes}, E - exact {[f'{e:+.1e}' for e in errs]} "
        f"(tolerance {EX_TFI_TOL:.0e})")
    check(all(r == 'device' for r in routes), "14b: a TFI solve did not "
          "take the card's route")
    check(max(abs(e) for e in errs) <= EX_TFI_TOL, "14b: the TFI "
          "dispersion is not exact")
    # JAX's chi=24 charged-magnon state and gap
    ref = exchange.load_flat(EX_REF)
    m1 = SpinChain(dict(EX_MODEL))
    sub = {k: v for k, v in ref.items() if k.startswith('haldane.u.')}
    u = exchange.load_uniform(ref, 'haldane.u', m1.lat.mps_sites())
    t0 = time.time()
    eng = ex_engine(u, m1, {'device_threshold': 0})
    Es, _, N = eng.run(np.pi, qtotal_change=EX_CHARGE)
    gap, gap_ref = float(np.real(Es[0])), float(ref['haldane.gap'])
    log(f"[14b] JAX's chi={int(ref['haldane.chi'][0])} state ({len(sub)} "
        f"arrays): gap on the card {gap!r}, JAX's {gap_ref!r}: "
        f"{gap - gap_ref:+.2e} (tolerance {EX_JAX_TOL:.0e}); {N} Lanczos "
        f"steps (JAX {int(ref['haldane.N'])}), {time.time() - t0:.2f} s")
    check(eng.excitation_stats[-1]['route'] == 'device',
          "14b: JAX's case did not take the card's route")
    check(abs(gap - gap_ref) <= EX_JAX_TOL, "14b: the card's gap differs "
          "from JAX's")
    # the GMRES sums against the explicit ones of the simulation's run
    k = 2
    e = ex_engine(eng_v.psi, m, dict(EX_GMRES, device_threshold=0))
    E_g = float(np.real(e.run(EX_TFI_MOMENTA[k])[0][0]))
    E_x = res['excitation_energies'][k][0]
    its = np.asarray(e.excitation_stats[-1]['sum_iterations'])
    its_x = np.asarray(sim.engine.excitation_stats[k]['sum_iterations'])
    log(f"[14b] TFI at p={EX_TFI_MOMENTA[k]:.4f}: GMRES sums ({EX_GMRES}) E "
        f"{E_g!r}, explicit (sum_tol 1e-10) {E_x!r}: {E_g - E_x:+.2e} "
        f"(tolerance {EX_SUM_TOL:.0e}); per matvec {its[:, 0].mean():.1f} "
        f"right and {its[:, 1].mean():.1f} left GMRES matvecs against "
        f"{its_x[:, 0].mean():.1f} and {its_x[:, 1].mean():.1f} explicit "
        f"terms; host reads per solve {e.excitation_stats[-1]['host_reads']} "
        f"against {sim.engine.excitation_stats[k]['host_reads']}")
    check(abs(E_g - E_x) <= EX_SUM_TOL, "14b: the GMRES sums differ from "
          "the explicit ones")
    return eng_v.psi, m


def ex_matvec_parts(eng, T, p, Xp, reps):
    """One card matvec of ``eng`` by part (``time_matvec`` on, which waits
    for the card after each part), the median of ``reps``: seconds,
    launches, tensordots and host reads."""
    from tenpy_tpu_torch.linalg import krylov_based
    Hc = eng._effective_H(p, T)
    parts = []
    eng.time_matvec = True
    try:
        for _ in range(reps):
            eng.matvec_timing.clear()
            n0, r0 = gg.LAUNCHES, krylov_based.PACKED_READS
            c0 = T.ops.n_contract
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Hc.matvec(Xp)
            torch.cuda.synchronize()
            parts.append(dict(eng.matvec_timing,
                              total=time.perf_counter() - t0,
                              launches=gg.LAUNCHES - n0,
                              reads=krylov_based.PACKED_READS - r0,
                              tensordots=T.ops.n_contract - c0))
    finally:
        eng.time_matvec = False
    return {k: statistics.median(p_[k] for p_ in parts) for k in parts[0]}


def phase_excitations_timing(smi, eng, X, model, states, tfi, host_128):
    """14c on 14a's engine at pi: one card matvec by part with the
    explicit and with the GMRES sums, its launches and host reads; one
    profiled solve (idle share); the card's matvec against the host's by
    N, with the engine's default (explicit) sums: the VUMPS stages, 14b's
    TFI state, and 14a's state (its host matvec timed in 14a, at
    sum_tol 1e-11); the kernel on one transfer-matrix step of the right
    sum at chi=128.  Returns the kernel's measurement."""
    from tenpy_tpu_torch.algorithms.plane_wave_excitation import \
        _right_env
    T = eng.tensors('device')
    Xp = T.vector(X)
    st = eng.excitation_stats[-1]
    by_method = {}
    for method, opts, reps in (('explicit', EX_MAGNON_SUMS, 3),
                               ('GMRES', EX_GMRES, 1)):
        eng.options.update(opts)
        med = by_method[method] = ex_matvec_parts(eng, T, np.pi, Xp, reps)
        log(f"[14c] one card matvec at pi with the {method} sums (chi="
            f"{EX_CHI}, N {st['N']}), "
            f"{'median of 3' if reps == 3 else 'once'}: "
            f"{1e3 * med['total']:.1f} "
            f"ms: B build {1e3 * med['B']:.2f}, aligned "
            f"{1e3 * med['aligned']:.2f}, right sum "
            f"{1e3 * med['right_sum']:.1f}, left sum "
            f"{1e3 * med['left_sum']:.1f}, unaligned "
            f"{1e3 * med['unaligned']:.2f} ms; {int(med['launches'])} "
            f"launches ({int(med['tensordots'])} tensordots, "
            f"{1e3 * med['total'] / med['tensordots']:.3f} ms each), "
            f"{int(med['reads'])} host reads")
        check(med['launches'] == med['tensordots'], "14c: launches per "
              "matvec differ from its tensordots")
    eng.options.update(EX_MAGNON_SUMS)
    # one profiled solve, its Lanczos capped
    eng.options['lanczos_params'] = dict(EX_MAGNON_LANCZOS,
                                         N_max=EX_PROFILE_STEPS)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        eng.run(np.pi, qtotal_change=EX_CHARGE)
        torch.cuda.synchronize()
        prof_s = time.time() - t0
    eng.options['lanczos_params'] = dict(EX_MAGNON_LANCZOS)
    t0 = time.time()
    busy, _, kernel_us, rows = device_time(prof)
    log(f"[14c] profiled solve at pi ({EX_PROFILE_STEPS} Lanczos steps, "
        f"explicit sums): {prof_s:.2f} s, device busy {busy / 1e6:.3f} s, "
        f"idle {100 * (1 - busy / 1e6 / prof_s):.1f}%, the kernel "
        f"{kernel_us / 1e6:.3f} s (the trace read in {time.time() - t0:.1f} "
        f"s); peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB")
    for name, us, n in rows[:4]:
        log(f"[14c]   {us / 1e6:8.4f} s {n:6d} x  {name[:80]}")
    # the crossover by N, the engine's default (explicit) sums
    cases = [(f'S=1 chi={chi}', states[chi], model, EX_CHARGE)
             for chi in EX_CHIS[:-1]] + [('TFI chi=%d' % max(tfi[0].chi),
                                          tfi[0], tfi[1], None)]
    rows = []
    for name, u, m, charge in cases:
        e = ex_engine(u, m)
        X0 = e.initial_guess(charge)
        N = sum(int(b.numel()) for x in X0 for b in x._data)
        t0 = time.perf_counter()
        e.tensors('device')
        pack_s = time.perf_counter() - t0
        card, host, card_s, h_s, first_s = ex_matvecs(e, np.pi, X0)
        rows.append((N, card_s, h_s))
        log(f"[14c] {name}: N {N}: card matvec {1e3 * card_s:.1f} ms (its "
            f"packing {1e3 * pack_s:.1f} ms once; its first call, plans "
            f"built, {1e3 * first_s:.1f} ms: card/host "
            f"{first_s / h_s:.3f}), host {1e3 * h_s:.1f} ms: card/host "
            f"{card_s / h_s:.3f}; rel_err {ex_rel(card, host):.1e}")
    card_128 = by_method['explicit']['total']
    rows.append((st['N'], card_128, host_128))
    log(f"[14c] S=1 chi={EX_CHI}: N {st['N']}: card matvec "
        f"{1e3 * card_128:.1f} ms, host {1e3 * host_128:.1f} ms: card/host "
        f"{card_128 / host_128:.3f}"
        + (" (host past 30 s: timed once)"
           if host_128 > EX_HOST_MATVEC_NOTE_S else ""))
    wins = sorted(N for N, c, h in rows if c < h)
    log(f"[14c] crossover: the card's matvec wins at N = {wins} of "
        f"{sorted(r[0] for r in rows)}; DEVICE_EXCITATION_THRESHOLD = "
        f"{mc.DEVICE_EXCITATION_THRESHOLD}")
    # the kernel on one transfer-matrix step of the right sum: site 1 on
    # the term of site 0's B, whose legs sit on the bond right of site 1
    Bs = T.Bs(Xp)
    R = _right_env(T.ops, [Bs[0]], [T.ARc[0]], T.RP[0], [T.W[0]])
    _, calls = recorded_calls(lambda: _right_env(
        T.ops, [T.AL[1]], [T.ARc[1]], R, [T.W[1]]))
    check(len(calls) == 3, "14c: the transfer step is not 3 tensordots")
    log(f"[14c] one transfer-matrix step of the right sum (site 1, "
        f"chi={EX_CHI}), {calls[0][3]}:")
    return measure_contractions(calls, EX_TRANSFER_STEPS, '14c',
                                'transfer step')


def phase_excitations(smi):
    """Phase 14: 14a, 14b, 14c on EX_HOST_THREADS host threads (restored
    after); returns 14a's launches, the transfer step's measurement, the
    model and the chi=128 uniform state."""
    with host_threads(EX_HOST_THREADS, 14):
        t0 = time.time()
        model, states = ex_ground_states(smi)
        t1 = time.time()
        eng, X, launches, host_s = phase_excitations_magnon(
            smi, model, states[EX_CHI])
        t2 = time.time()
        tfi = phase_excitations_exact(smi)
        t3 = time.time()
        tmv = phase_excitations_timing(smi, eng, X, model, states, tfi,
                                       host_s)
    log(f"[14] phase wall: VUMPS {t1 - t0:.1f} s, 14a {t2 - t1:.1f} s, 14b "
        f"{t3 - t2:.1f} s, 14c {time.time() - t3:.1f} s")
    return launches, tmv, model, states[EX_CHI]


# segment boundary conditions (phase 15).  15a: phase 14's chi=128 S=1 state
# (to_MPS) on a segment of SG_ENLARGE unit cells (32 sites), Sp at the
# centre site, two excitations in the Delta Sz = +1 sector (the second from
# the ground state again, so that it is projected against the first);
# 15b: the ferromagnetic TFI chain's kink between its two broken ground
# states.  DMRG: two-site, no mixer, no device_K (the engine's threshold).
# 16 cells; eight sweeps per 15a excitation (alone on the card the first
# one converged in 7, 44-55 s; PERF.md), always eight, so that the second
# excitation's last sweep, the profiled one, is sweep 8
SG_ENLARGE = 16
SG_OP_SITE = SG_ENLARGE          # the centre site of 2 * SG_ENLARGE
SG_DMRG = {'trunc_params': {'chi_max': 128, 'svd_min': 1e-10},
           'max_sweeps': 8, 'min_sweeps': 8, 'mixer': False}
# the box estimate of 15a: the magnon dispersion sqrt(gap^2 + v^2 dk^2)
# near its minimum (phase 14's gap EX_GAP; v = 2.49, White and Huse 1993)
# with hard walls at the segment's ends, dk = pi / (2 SG_ENLARGE + 1)
SG_V = 2.49
SG_E_ORDER_TOL, SG_OVERLAP_TOL = 1e-8, 1e-6
SG_NORM_TOL = 1e-10
# the centre's check: both routes to convergence (P_tol 1e-14, at most
# SG_CHECK_K steps) from one perturbed guess; with 20 fixed steps each, the
# unconverged Ritz values of the two routes parted by 9.2e-9 (relative) on
# the card, as in phase 9 two unconverged Lanczos runs part by roundoff
SG_CHECK_K, SG_CHECK_NOISE, SG_CHECK_SEED = 60, 1e-2, 15
SG_CHECK_E_TOL, SG_CHECK_OV_TOL = 1e-10, 1e-8
SG_CROSS_K = 10
SG_CROSS_N = (256, 1024)
SG_HOST_THREADS = 1
# 15b: J=1, g=0.7; the kink dispersion 2 sqrt(J^2 + g^2 - 2 J g cos k) has
# its minimum 2 (J - g) = 0.6 at k=0 and curvature J g / (J - g); the same
# hard-wall box
SG_TFI = {'L': 2, 'J': 1., 'g': 0.7, 'bc_MPS': 'infinite', 'conserve': None}
SG_TFI_GS = {'trunc_params': {'chi_max': 64, 'svd_min': 1e-10},
             'max_sweeps': 30}
SG_KINK = 2. * (1. - 0.7)


def sg_boxes():
    """The box estimates of 15a (magnon) and 15b (kink) on the segment of
    SG_ENLARGE two-site cells."""
    dk = np.pi / (2 * SG_ENLARGE + 1)
    return (float(np.sqrt(EX_GAP ** 2 + (SG_V * dk) ** 2) - EX_GAP),
            0.7 / 0.3 * dk ** 2)
SG_TOPO_DMRG = {'trunc_params': {'chi_max': 64, 'svd_min': 1e-10},
                'max_sweeps': 8, 'min_sweeps': 4, 'mixer': False}


class SegmentProbe:
    """Within ``with``: every two-site DMRG update's N and route (card or
    host, projected or not) and, around each card Lanczos, its steps,
    launches and whether a vector was projected out."""

    def __init__(self):
        self.updates = []     # (N, on the card)
        self.card = []        # (projected, steps, launches)
        self._orig = None

    def __enter__(self):
        probe = self
        Eng = dmrg.DMRGEngine
        orig_diag, orig_dev = Eng.diag, Eng._diag_device_lanczos

        def diag(self, theta):
            eff, _ = self._base_eff_H()
            probe.updates.append((eff.N, bool(self._use_device_lanczos())))
            return orig_diag(self, theta)

        def dev(self, theta):
            st = self.device_lanczos_stats
            n0, p0 = gg.LAUNCHES, st['projected']
            out = orig_dev(self, theta)
            probe.card.append((st['projected'] > p0, int(out[2]),
                               gg.LAUNCHES - n0))
            return out

        self._orig = (orig_diag, orig_dev)
        Eng.diag, Eng._diag_device_lanczos = diag, dev
        return self

    def __exit__(self, *exc):
        dmrg.DMRGEngine.diag, dmrg.DMRGEngine._diag_device_lanczos = \
            self._orig

    def check(self, tag, projected_expected=True):
        big = [(N, card) for N, card in self.updates
               if N >= mc.DEVICE_LANCZOS_THRESHOLD]
        proj = [c for c in self.card if c[0]]
        plain = [c for c in self.card if not c[0]]
        steps = sum(c[1] for c in self.card)
        launches = sum(c[2] for c in self.card)
        log(f"[{tag}] two-site updates {len(self.updates)}, "
            f"{len(big)} with N >= {mc.DEVICE_LANCZOS_THRESHOLD}, "
            f"{sum(1 for _, c in big if c)} of them on the card: "
            f"{len(proj)} projected ({sum(c[1] for c in proj)} Lanczos "
            f"steps, {sum(c[2] for c in proj)} launches), {len(plain)} "
            f"unprojected ({sum(c[1] for c in plain)} steps, "
            f"{sum(c[2] for c in plain)} launches); N from "
            f"{min(N for N, _ in self.updates)} to "
            f"{max(N for N, _ in self.updates)}")
        check(big and all(card for _, card in big),
              f"{tag}: an update from N={mc.DEVICE_LANCZOS_THRESHOLD} up "
              "did not run on the card")
        check(len(self.card) == len(big), f"{tag}: card solves differ "
              "from the updates sent there")
        check(all(n == 4 * k for _, k, n in self.card)
              and launches == 4 * steps, f"{tag}: launches are not 4 per "
              "card Lanczos step")
        if projected_expected:
            check(len(proj) > 0, f"{tag}: no projected update ran on the "
                  "card")
        return sum(c[2] for c in proj)


class sg_lanczos:
    """Within ``with``: ``eng.lanczos_params`` with ``opts`` set, as they
    were after."""

    def __init__(self, eng, **opts):
        self.lp, self.opts = eng.lanczos_params, opts

    def __enter__(self):
        self.saved = {k: self.lp[k] for k in self.opts if k in self.lp}
        for k, v in self.opts.items():
            self.lp[k] = v
        return self

    def __exit__(self, *exc):
        for k in self.opts:
            if k in self.saved:
                self.lp[k] = self.saved[k]
            else:
                del self.lp[k]


def sg_route_check(tag, eng, i0, noise_seed):
    """The card's and the host's Lanczos on the effective H of ``eng``'s
    update at ``i0`` (projected by its ``orthogonal_to``), each to
    convergence (P_tol 1e-14, at most SG_CHECK_K steps) from one perturbed
    guess; returns the effective H and the guess."""
    eng.i0, eng.move_right = i0, True
    theta = eng.prepare_update_local()
    eff = eng.eff_H
    rng = np.random.default_rng(noise_seed)
    noise = npc.Array.from_ndarray(rng.standard_normal(theta.shape),
                                   theta.legs, qtotal=theta.qtotal,
                                   labels=theta.get_leg_labels(),
                                   warn_wrong_sector=False)
    guess = theta + noise * (SG_CHECK_NOISE * npc.norm(theta)
                             / npc.norm(noise))
    with sg_lanczos(eng, P_tol=1e-14, device_K=SG_CHECK_K):
        t0 = time.time()
        E_dev, th_dev, N_dev, _ = eng._diag_device_lanczos(guess)
        dev_s = time.time() - t0
    t0 = time.time()
    E_host, th_host, N_host = LanczosGroundState(
        eff, guess, {'N_max': SG_CHECK_K, 'P_tol': 1e-14}).run()
    host_s = time.time() - t0
    ov = abs(complex(npc.inner(th_dev.conj(), th_host, axes='range')))
    e_rel = abs(E_dev - E_host) / abs(E_host)
    vecs = getattr(eff, 'ortho_vecs', [])
    ovs = []
    for o in vecs:
        if not np.array_equal(o.qtotal, theta.qtotal):
            continue
        on = o / npc.norm(o)
        ovs.append([abs(complex(npc.inner(on.conj(), th, axes='range')))
                    for th in (th_dev, th_host)] + [float(npc.norm(o))])
    N = eng._base_eff_H()[0].N
    log(f"[{tag}] projected update at bond {i0 + 1} (N={N},"
        f" {len(vecs)} vectors, {len(ovs)} in its sector; guess perturbed "
        f"by {SG_CHECK_NOISE:g}): card {E_dev:.14f} in {N_dev} steps "
        f"({dev_s:.2f} s), host {E_host:.14f} in {N_host} steps "
        f"({host_s:.2f} s): rel {e_rel:.2e}, 1 - |<card|host>| {1 - ov:.2e}; "
        f"|<o/|o||theta>| card, host (|o|): "
        + ', '.join(f"{a:.3e}, {b:.3e} ({n:.4f})" for a, b, n in ovs))
    check(e_rel <= SG_CHECK_E_TOL and 1. - ov <= SG_CHECK_OV_TOL,
          f"{tag}: the card's projected Lanczos disagrees with the host's")
    check(len(ovs) > 0, f"{tag}: no projected vector in the update's sector")
    check(all(abs(a - b) <= SG_CHECK_OV_TOL for a, b, _ in ovs),
          f"{tag}: the routes' Ritz vectors overlap the projected vectors "
          "differently")
    return eff, guess


def sg_cross(tag, eng, i0):
    """Both routes of ``eng``'s (projected) update at ``i0``, SG_CROSS_K
    fixed Lanczos steps each: host, card's first call (packing and plans)
    and second; returns the card/host ratio of the second."""
    eng.i0, eng.move_right = i0, True
    th = eng.prepare_update_local()
    t0 = time.time()
    LanczosGroundState(eng.eff_H, th, {'N_min': SG_CROSS_K,
                                       'N_max': SG_CROSS_K, 'P_tol': 0.,
                                       'cutoff': 0.}).run()
    h_ms = 1e3 * (time.time() - t0)
    with sg_lanczos(eng, P_tol=0., device_K=SG_CROSS_K):
        t0 = time.time()
        eng._diag_device_lanczos(th)
        cold_ms = 1e3 * (time.time() - t0)
        t0 = time.time()
        eng._diag_device_lanczos(th)
        warm_ms = 1e3 * (time.time() - t0)
    log(f"[{tag}] both routes at bond {i0 + 1}, N={eng._base_eff_H()[0].N}"
        f" ({SG_CROSS_K} Lanczos steps): host {h_ms:.2f} ms, card "
        f"{cold_ms:.2f} ms (first call), {warm_ms:.2f} ms (second): "
        f"card/host {warm_ms / h_ms:.3f}")
    return warm_ms / h_ms


def phase_segment_orthogonal(smi, model, u):
    """15a: OrthogonalExcitations of the chi=128 S=1 state on a segment on
    the card; returns the projected eigensolves' launches and the kernel's
    measurement on the centre's matvec."""
    from tenpy_tpu_torch.simulations.ground_state_search import \
        OrthogonalExcitations
    t0 = time.time()
    psi = u.to_MPS()
    norm0 = float(np.max(psi.norm_test()))
    if norm0 > SG_NORM_TOL:
        psi.canonical_form()
    norm1 = float(np.max(psi.norm_test()))
    log(f"[15a] phase 14's chi={EX_CHI} state to_MPS: chi {psi.chi}, "
        f"norm_test {norm0:.2e}" + (f", after canonical_form {norm1:.2e}"
                                    if norm0 > SG_NORM_TOL else "")
        + f" ({time.time() - t0:.2f} s)")
    check(norm1 <= SG_NORM_TOL, "15a: the infinite state is not canonical")
    opts = {'model_class': 'SpinChain', 'model_params': dict(EX_MODEL),
            'segment_enlarge': SG_ENLARGE, 'N_excitations': 2,
            'apply_local_op': {'i': SG_OP_SITE, 'op': 'Sp'},
            'initial_state_params': {'use_highest_excitation': False},
            'algorithm_params': copy.deepcopy(SG_DMRG), 'save_psi': False,
            'output_filename': None, 'log_params': SIM_LOG}
    gg.LAUNCHES = 0                    # count phase 15a's launches only
    torch.cuda.reset_peak_memory_stats()
    sweeps = []
    orig_run = dmrg.DMRGEngine.run

    def run(self):
        t1 = time.time()
        out = orig_run(self)
        sweeps.append((time.time() - t1, self.sweeps,
                       dict(self.device_lanczos_stats)))
        return out

    # the second excitation's last sweep (projected updates) is profiled
    prof_box = {}

    def sweep(self, optimize=True):
        if not (optimize and len(sweeps) == 1 and 'prof' not in prof_box
                and self.sweeps == SG_DMRG['max_sweeps'] - 1):
            return mc.Sweep.sweep(self, optimize)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t1 = time.time()
            out = mc.Sweep.sweep(self, optimize)
            torch.cuda.synchronize()
            prof_box['s'] = time.time() - t1
        prof_box['prof'] = prof
        return out

    dmrg.DMRGEngine.run = run
    dmrg.DMRGEngine.sweep = sweep
    n_td, restore = counted_contract()
    try:
        with SegmentProbe() as probe, HostDMRGProbe(n_td) as parts:
            t0 = time.time()
            sim = OrthogonalExcitations(opts, ground_state_data=psi,
                                        device='cuda')
            with sim:
                res = sim.run()
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        dmrg.DMRGEngine.run = orig_run
        del dmrg.DMRGEngine.sweep
        restore()
    gaps = [float(g) for g in res['excitation_energies']]
    gs = sim.ground_state
    dq = [np.asarray(x.get_total_charge()) - np.asarray(gs.get_total_charge())
          for x in sim.excitations]
    ex1, ex2 = sim.excitations
    ov = abs(complex(ex2.overlap(ex1)))
    norms = [abs(complex(x.overlap(x))) for x in sim.excitations]
    log(f"[15a] OrthogonalExcitations on {gs.L} sites (enlarge "
        f"{SG_ENLARGE}, Sp at site {SG_OP_SITE}, {SG_DMRG}): {wall:.2f} s; "
        f"energy density {res['ground_state_energy_density']!r}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; card "
        f"{smi}")
    for k, (sec, n_sw, st) in enumerate(sweeps):
        log(f"[15a]   excitation {k + 1}: {sec:.2f} s, {n_sw} sweeps "
            f"({sec / max(n_sw, 1):.2f} s each), card solves {st['plain']} "
            f"unprojected ({st['plain_steps']} steps) and {st['projected']} "
            f"projected ({st['projected_steps']} steps)")
    box = sg_boxes()[0]
    hi = EX_GAP + 2 * box
    log(f"[15a] gaps {gaps!r}: the first {gaps[0] - EX_GAP:+.4e} from "
        f"{EX_GAP} (within ({EX_GAP}, {hi:.6f}): the box estimate "
        f"{box:.6f}); E2 - E1 {gaps[1] - gaps[0]:+.3e}; |<psi2|psi1>| "
        f"{ov:.2e}; norms {norms}; charges {[q.tolist() for q in dq]}")
    check(EX_GAP < gaps[0] < hi, "15a: the first gap is outside the "
          "Haldane gap's box")
    check(gaps[1] >= gaps[0] - SG_E_ORDER_TOL, "15a: E2 < E1")
    check(ov < SG_OVERLAP_TOL, "15a: the two excitations are not "
          "orthogonal")
    check(all(int(q[0]) == EX_CHARGE[0] for q in dq), "15a: an excitation "
          "is not in the Delta Sz = +1 sector")
    check(all(np.isfinite(g) for g in gaps), "15a: non-finite gap")
    launches = probe.check('15a')
    n_up = len(probe.updates)
    per = {key: 1e3 * sum(t for _, t in parts.parts[key]) / n_up
           for key in HostDMRGProbe.PARTS if parts.parts[key]}
    log(f"[15a] per update ({n_up} updates, "
        f"{sum(sec for sec, _, _ in sweeps):.2f} s in the two runs): "
        + ', '.join(f"{key} {ms:.2f} ms" for key, ms in per.items()))
    check('prof' in prof_box, "15a: the second excitation's last sweep was "
          "not profiled")
    t0 = time.time()
    busy, _, kernel_us, rows = device_time(prof_box['prof'])
    log(f"[15a] the second excitation's last sweep, profiled: "
        f"{prof_box['s']:.2f} s, device busy {busy / 1e6:.3f} s, idle "
        f"{100 * (1 - busy / 1e6 / prof_box['s']):.1f}%; the kernel "
        f"{kernel_us / 1e6:.3f} s (the trace read in {time.time() - t0:.1f} "
        f"s)")
    for name, us, n in rows[:4]:
        log(f"[15a]   {us / 1e6:8.4f} s {n:6d} x  {name[:80]}")

    # the centre update of the second excitation (projected against the
    # first), card against host, and both routes timed
    eng = sim.engine
    i0 = gs.L // 2 - 1
    eff, guess = sg_route_check('15a', eng, i0, SG_CHECK_SEED)
    sg_cross('15a', eng, i0)
    # the kernel on the centre's matvec
    LPp, RPp, W0p, W1p = eff.orig_operator.pack_operands(eng.device)
    theta_p = mc.pack_virtual(guess, eng.device)
    _, calls = recorded_calls(lambda: _matvec_2site_packed(
        LPp, RPp, W0p, W1p, theta_p))
    check(len(calls) == 4, "15a: the centre matvec is not four tensordots")
    tot = measure_contractions(calls, MATVEC_STEPS, '15a')
    return launches, tot


def phase_segment_topological(smi):
    """15b: the TFI kink between the two broken ground states, glued and
    relaxed on the card; then both routes of a projected update at a bond
    of N in SG_CROSS_N."""
    from tenpy_tpu_torch.models.tf_ising import TFIChain
    from tenpy_tpu_torch.simulations.ground_state_search import \
        TopologicalExcitations
    m = TFIChain(dict(SG_TFI))
    s2 = 1. / np.sqrt(2.)
    gs = []
    t0 = time.time()
    for vec in ([s2, s2], [s2, -s2]):
        psi = MPS.from_product_state(m.lat.mps_sites(), [np.array(vec)] * 2,
                                     bc='infinite')
        # no mixer: it mixes the broken sectors back into a cat state
        info = dmrg.run(psi, m, copy.deepcopy(SG_TFI_GS), device='cuda')
        gs.append(psi)
        log(f"[15b] broken ground state from {vec}: E {info['E']!r}, chi "
            f"{psi.chi}, <Sigmax> "
            f"{float(np.real(psi.expectation_value('Sigmax')[0])):+.6f}")
    mx = [float(np.real(p.expectation_value('Sigmax')[0])) for p in gs]
    check(mx[0] > 0.5 and abs(mx[0] + mx[1]) < 1e-6, "15b: the two ground "
          "states are not the two broken ones")
    gs_s = time.time() - t0
    opts = {'model_class': 'TFIChain', 'model_params': dict(SG_TFI),
            'segment_enlarge': SG_ENLARGE, 'N_excitations': 1,
            'algorithm_params': copy.deepcopy(SG_TOPO_DMRG),
            'save_psi': False, 'output_filename': None,
            'log_params': SIM_LOG}
    with SegmentProbe() as probe:
        t0 = time.time()
        sim = TopologicalExcitations(opts, gs_data_alpha=gs[0],
                                     gs_data_beta=gs[1], device='cuda')
        with sim:
            res = sim.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    E = float(res['excitation_energies'][0])
    glued = sim.ground_state
    box = sg_boxes()[1]
    hi = SG_KINK + 2 * box
    norm = abs(complex(glued.overlap(glued)))
    log(f"[15b] ground states {gs_s:.2f} s; TopologicalExcitations on "
        f"{glued.L} sites: {wall:.2f} s, {sim.engine.sweeps} sweeps; kink "
        f"{E!r}: {E - SG_KINK:+.4e} from 2(J - g) = {SG_KINK} (within "
        f"({SG_KINK - 1e-6}, {hi:.6f}): the box estimate "
        f"{box:.6f}); reference energy "
        f"{res['ground_state_energy']!r}; glued state bc {glued.bc}, chi "
        f"{max(glued.chi)}, <glued|glued> {norm:.12f}")
    check(SG_KINK - 1e-6 < E < hi, "15b: the kink energy is outside its box")
    check(glued.bc == 'segment' and glued.L == 2 * SG_ENLARGE
          and abs(norm - 1.) < 1e-10, "15b: the glued state is not a valid "
          "segment")
    for i in range(glued.L - 1):
        glued.get_B(i).get_leg('vR').test_contractible(
            glued.get_B(i + 1).get_leg('vL'))
    probe.check('15b', projected_expected=False)
    # both routes of a projected update at a bond of small N: the glued
    # state (the ground states' chi on every bond) projected against the
    # relaxed kink (on the relaxed kink itself N is 1,600 at the ends and
    # up to 16,384 inside)
    kink = sim.excitations[0]
    eng = dmrg.TwoSiteDMRGEngine(
        glued.copy(), sim.model, copy.deepcopy(SG_TOPO_DMRG),
        orthogonal_to=[kink],
        resume_data={'init_env_data': dict(sim.init_env_data)},
        device='cuda')
    Ns = []
    for i in range(glued.L - 1):
        eng.i0, eng.move_right = i, True
        eng.make_eff_H()
        Ns.append(eng._base_eff_H()[0].N)
    inside = [i for i, N in enumerate(Ns)
              if SG_CROSS_N[0] <= N <= SG_CROSS_N[1]]
    i_small = inside[len(inside) // 2] if inside else int(np.argmin(
        [N if N >= SG_CROSS_N[0] else np.inf for N in Ns]))
    log(f"[15b] N by bond {Ns}: timed at bond {i_small + 1}"
        + ("" if inside else f" (no bond has N in {SG_CROSS_N})"))
    sg_cross('15b', eng, i_small)


def phase_segment(smi, model, u):
    """Phase 15: 15a and 15b on SG_HOST_THREADS host threads (restored
    after); returns 15a's projected launches and its kernel
    measurement."""
    with host_threads(SG_HOST_THREADS, 15):
        t0 = time.time()
        launches, tot = phase_segment_orthogonal(smi, model, u)
        t1 = time.time()
        phase_segment_topological(smi)
    log(f"[15] phase wall: 15a {t1 - t0:.1f} s, 15b {time.time() - t1:.1f} s")
    return launches, tot


# The phases run in three processes on the one card.  They are host-bound
# (the card idle 96-99% of phases 9-15, PERF.md section 5), so groups that
# share no state run side by side: this process runs 1-9 and 12b (which
# starts from phase 7's state), worker B runs 10, 13, 12a and 12c, worker C
# 11, 14 and 15.  Each process counts its own launches around its own
# paths; kernel timings take turns (timing_lock).  The host's cores are
# shared out among the three as torch threads (a phase that pins its own
# count still does).
def run_worker_b(smi):
    """Phases 10, 13, 12a and 12c; their kernel entries and walls."""
    kernels, walls, t = {}, [], time.time()
    kernels['packed_contract_simulation'] = phase_simulation(smi)
    walls.append(('10', time.time() - t))
    t = time.time()
    kernels['packed_contract_purification_gate'] = phase_purification(smi)
    walls.append(('13', time.time() - t))
    t = time.time()
    (kernels['packed_contract_vumps_zero_site'],
     kernels['packed_contract_vumps_two_site']) = phase_vumps_real(smi)
    walls.append(('12a,12c', time.time() - t))
    return kernels, walls


def run_worker_c(smi):
    """Phases 11, 14 and 15; their kernel entries and walls."""
    kernels, walls, t = {}, [], time.time()
    e2_n, e1_n, e2mv, e1mv = phase_time_evolution(smi)
    kernels['packed_contract_tdvp_two_site'] = e2_n, e2mv
    kernels['packed_contract_tdvp_one_site'] = e1_n, e1mv
    walls.append(('11', time.time() - t))
    t = time.time()
    x_n, xmv, model, u = phase_excitations(smi)
    kernels['packed_contract_plane_wave_transfer'] = x_n, xmv
    walls.append(('14', time.time() - t))
    t = time.time()
    kernels['packed_contract_segment_orthogonal'] = phase_segment(smi, model,
                                                                  u)
    walls.append(('15', time.time() - t))
    return kernels, walls


WORKERS = {'B': run_worker_b, 'C': run_worker_c}
# torch host threads per process, as shares of the host's cores
THREAD_SHARE = {'main': 2, 'B': 4, 'C': 4}
# the workers must have finished this long after the smoke's start
WORKER_DEADLINE_S = 1150.
MEASURED = ('max_abs', 'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')


def share_threads(name):
    return max(1, (os.cpu_count() or 1) // THREAD_SHARE[name])


def worker_main(name, out):
    """Run worker ``name``'s phases and write their kernel entries and
    walls to ``out`` as JSON.  Alone, ``python3 chip_smoke.py --worker C
    out.json`` runs phases 11, 14 and 15 (B: 10, 13, 12a and 12c)."""
    exit_with_parent()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    torch.set_num_threads(share_threads(name))
    smi = os.environ.get('SMOKE_SMI') or phase_device()
    kernels, walls = WORKERS[name](smi)
    with open(out, 'w') as f:
        json.dump({'walls': walls, 'kernels': {
            k: [int(n), {key: m[key] if m[key] is None
                         or isinstance(m[key], str) else float(m[key])
                         for key in MEASURED}]
            for k, (n, m) in kernels.items()}}, f)


def exit_with_parent():
    """End this worker once the process that started it is gone."""
    import threading
    parent = int(os.environ.get('SMOKE_PARENT', os.getppid()))

    def watch():
        while os.getppid() == parent:
            time.sleep(1.)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


@contextlib.contextmanager
def workers(smi, tmp):
    """Start the worker processes; kill any still running on the way out."""
    procs = {}
    try:
        for name in WORKERS:
            n = str(share_threads(name))
            env = dict(os.environ, SMOKE_SMI=smi,
                       SMOKE_PARENT=str(os.getpid()), OMP_NUM_THREADS=n,
                       MKL_NUM_THREADS=n, OPENBLAS_NUM_THREADS=n)
            procs[name] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), '--worker', name,
                 os.path.join(tmp, f'{name}.json')],
                env=env)
        yield procs
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()


def check_workers(procs):
    """Fail as soon as a worker has failed."""
    for name, p in procs.items():
        rc = p.poll()
        check(rc is None or rc == 0, f"worker {name} failed (exit code {rc})")


def join_workers(procs, tmp, t_start):
    """Wait for the workers; their kernel entries and walls."""
    kernels, walls = {}, []
    for name, p in procs.items():
        try:
            rc = p.wait(timeout=max(
                1., WORKER_DEADLINE_S - (time.time() - t_start)))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"worker {name} still running "
                               f"{WORKER_DEADLINE_S:.0f} s after the start")
        check(rc == 0, f"worker {name} failed (exit code {rc})")
        with open(os.path.join(tmp, f'{name}.json')) as f:
            res = json.load(f)
        kernels.update({k: tuple(v) for k, v in res['kernels'].items()})
        walls += [(f'{w} ({name})', t) for w, t in res['walls']]
    return kernels, walls


def main():
    t_start = time.time()
    smi = phase_device()
    phase_build()
    tmp = tempfile.mkdtemp(prefix='chip_smoke_')
    os.environ['SMOKE_LOCK'] = os.path.join(tmp, 'timing.lock')
    try:
        with workers(smi, tmp) as procs:
            torch.set_num_threads(share_threads('main'))
            log(f"[2] workers {', '.join(WORKERS)} started; torch host "
                f"threads per process: " + ', '.join(
                    f"{name} {share_threads(name)}" for name in THREAD_SHARE))
            kernels, max_abs_synth, walls = main_phases(smi, procs, t_start)
            t = time.time()
            worker_kernels, worker_walls = join_workers(procs, tmp, t_start)
            log(f"[16] waited {time.time() - t:.1f} s for the workers")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels.update(worker_kernels)
    log("[16] wall by phase: " + ', '.join(
        f"[{name}] {t:.1f} s" for name, t in walls + worker_walls))
    m = {k: v[1]['max_abs'] for k, v in kernels.items()}
    p = 'packed_contract_'
    log(f"[16] kernel max_abs_err: synthetic f64 "
        f"{max_abs_synth[torch.float64]:.2e}, complex128 "
        f"{max_abs_synth[torch.complex128]:.2e}; main-path shapes f64 "
        f"{m['packed_contract']:.2e}, complex128 {m[p + 'complex128']:.2e}, "
        f"TEBD complex128 {m[p + 'complex128_tebd']:.2e}, host DMRG f64 "
        f"{m[p + 'host_dmrg']:.2e}, simulation f64 {m[p + 'simulation']:.2e}"
        f", TDVP complex128 two-site {m[p + 'tdvp_two_site']:.2e}, one-site "
        f"{m[p + 'tdvp_one_site']:.2e}; VUMPS f64 zero-site "
        f"{m[p + 'vumps_zero_site']:.2e}, two-site "
        f"{m[p + 'vumps_two_site']:.2e}, complex128 zero-site "
        f"{m[p + 'vumps_zero_site_complex128']:.2e}, one-site "
        f"{m[p + 'vumps_one_site_complex128']:.2e}; purification gate f64 "
        f"{m[p + 'purification_gate']:.2e}; plane-wave transfer step "
        f"complex128 {m[p + 'plane_wave_transfer']:.2e}; projected segment "
        f"matvec f64 {m[p + 'segment_orthogonal']:.2e}")

    def entry(name):
        n, m = kernels[name]
        return {'name': name, 'route': 'cuda',
                'source': 'tenpy_tpu_torch/csrc/packed_contract.cu',
                'replaces': 'tenpy_tpu/linalg/pallas_gemm.py:124',
                'launches': n, 'max_abs_err': m['max_abs'], 'ms': m['ms'],
                'plain_ms': m['plain_ms'], 'bound_ms': m['bound_ms'],
                'bound_by': m['bound_by'], 'library_ms': m['library_ms']}

    # times, bound and library time: per matvec (4 tensordots), f64 at
    # chi=256 (Hubbard), complex128 at chi=128 (Hofstadter), f64 at the
    # centre of the chi=512 XX chain (host DMRG); per TEBD bond update (3
    # tensordots), complex128 at chi=512 (XXZ quench); per TDVP matvec at
    # the centre of the chi=256 XX chain, complex128: two-site (4
    # tensordots) and one-site (3); per VUMPS matvec of the last update,
    # f64 on the chi=256 XX chain: zero-site (2 tensordots) and two-site
    # (4), complex128 on the chi=128 Hofstadter cylinder: zero-site and
    # one-site (3); per purification gate (1 tensordot), f64 on the
    # saturated chi=256 bond of the XX chain's purification; per
    # transfer-matrix step of a plane-wave excitation's right sum (3
    # tensordots), complex128 on the chi=128 S=1 chain; per matvec of a
    # projected segment update (4 tensordots), f64 at the centre of the
    # S=1 chain's chi=128 segment
    names = ['packed_contract', 'complex128', 'complex128_tebd', 'host_dmrg',
             'simulation', 'tdvp_two_site', 'tdvp_one_site',
             'vumps_zero_site', 'vumps_two_site',
             'vumps_zero_site_complex128', 'vumps_one_site_complex128',
             'purification_gate', 'plane_wave_transfer', 'segment_orthogonal']
    names = names[:1] + [p + n for n in names[1:]]
    check(sorted(names) == sorted(kernels), "the kernel entries differ from "
          "the phases' measurements")
    print(json.dumps({'kernels': [entry(name) for name in names]}),
          flush=True)
    log(f"[16] chip_smoke wall {time.time() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


def main_phases(smi, procs, t_start):
    """Phases 3-9 and 12b in this process, the workers checked between
    phases; their kernel entries, the synthetic shapes' errors and the
    walls."""
    max_abs_synth = phase_kernel()
    hof = {k[len('chi128.'):]: v
           for k, v in exchange.load_flat(HOF_REF).items()
           if k.startswith('chi128.')}
    if (json.loads(str(hof['options'])) != HOF_OPTIONS
            or json.loads(str(hof['model'])) != HOF_MODEL):
        raise RuntimeError("Hofstadter reference options or model differ")
    flat = exchange.load_flat(STATE)
    state = exchange.ExchangeState(flat)
    ref = state.reference
    if json.loads(str(ref['options'])) != OPTIONS:
        raise RuntimeError("exchange file reference options differ")
    e_site_ref = (ref['sweep_E'][-1] - ref['sweep_E'][-2]) / 16
    check(abs(e_site_ref - E_SITE_REF) < 1e-7,
          f"committed energy per site {e_site_ref} is not {E_SITE_REF}")
    wb = {k[len('chi256.'):]: v
          for k, v in exchange.load_flat(WRITE_BACK_REF).items()
          if k.startswith('chi256.')}
    if json.loads(str(wb['options'])) != OPTIONS:
        raise RuntimeError("write-back reference options differ")
    walls = [('1-3', time.time() - t_start)]

    def lap(name):
        walls.append((name, time.time() - t_start - sum(t for _, t in walls)))
        check_workers(procs)

    k = {}
    eng = phase_setup(flat)
    sites = list(eng.psi.sites)
    check_setup(eng, state)
    mv = phase_matvec(eng)
    k['packed_contract'] = phase_main(eng, ref), mv
    phase_write_back(eng, sites, wb)
    lap('4-5')
    phase_ramp()
    lap('6')
    z_launches, zmv, hof_state = phase_hofstadter(hof)
    k['packed_contract_complex128'] = z_launches, zmv
    lap('7')
    psi_gs = phase_tebd_ground_state()
    tebd_eng, t_launches, _ = phase_tebd_quench(psi_gs, smi)
    phase_tebd_jax_case()
    k['packed_contract_complex128_tebd'] = (t_launches,
                                            phase_tebd_kernel(tebd_eng))
    lap('8')
    k['packed_contract_host_dmrg'] = phase_host_dmrg(smi)
    lap('9')
    (k['packed_contract_vumps_zero_site_complex128'],
     k['packed_contract_vumps_one_site_complex128']) = phase_vumps_complex(
        smi, hof_state)
    lap('12b')
    return k, max_abs_synth, walls


if __name__ == '__main__':
    if sys.argv[1:2] == ['--worker']:
        worker_main(*sys.argv[2:4])
    else:
        main()
