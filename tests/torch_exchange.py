"""Exporter: ``tenpy_tpu`` states and reference values in the exchange format.

:func:`export_flat` runs the host half of ``tenpy_tpu``'s
``DeviceSweepEngine._setup`` (JAX, on the CPU): ``real_if_close``, the
uniform charge gauge (with the charge-unit rescale of the MPO), the
transfer-matrix environment initialisation for infinite bc and
``MPOEnvironment``.  It writes the state (B, S, forms), which the port
loads with :func:`tenpy_tpu_torch.networks.exchange.load_mps`, and beside it
the MPO, environments and gauge that JAX packs, as values to hold the
port's own setup against.  :func:`jax_reference` runs ``tenpy_tpu``'s
engine on the same state and stores its energies (keys ``ref.*``), so that
the port can be held to JAX where JAX does not run; :func:`ramp_reference`
does the same for ``device_ramp``.

The port's CPU tests call these functions in memory.  Writing the committed
chi=256 Hubbard-cylinder file and the ramp references::

    python tests/torch_exchange.py --write \
        tests/benchmark_data/hubbard_cyl_chi256_exchange.npz
    python tests/torch_exchange.py --write-ramps \
        tests/benchmark_data/hubbard_ramp_reference.npz
    python tests/torch_exchange.py --write-small \
        tests/benchmark_data/hubbard_cyl_ly2_chi16_exchange.npz
    python tests/torch_exchange.py --write-hofstadter \
        tests/benchmark_data/hofstadter_reference.npz
    python tests/torch_exchange.py --write-tebd \
        tests/benchmark_data/tebd_reference.npz
    python tests/torch_exchange.py --write-states \
        tests/benchmark_data/written_back_states.npz
    python tests/torch_exchange.py --write-host-dmrg \
        tests/benchmark_data/host_dmrg_reference.npz
    python tests/torch_exchange.py --write-ramp-drift \
        tests/benchmark_data/ramp_drift_reference.npz
    python tests/torch_exchange.py --write-simulation \
        tests/benchmark_data/simulation_reference.npz
    python tests/torch_exchange.py --write-excitations \
        tests/benchmark_data/excitation_reference.npz
    python tests/torch_exchange.py --write-time-evolution \
        tests/benchmark_data/time_evolution_reference.npz
    python tests/torch_exchange.py --write-vumps \
        tests/benchmark_data/vumps_reference.npz
    python tests/torch_exchange.py --write-purification \
        tests/benchmark_data/purification_reference.npz
    python tests/torch_exchange.py --write-segment \
        tests/benchmark_data/segment_reference.npz
    python tests/torch_exchange.py --write-models \
        tests/benchmark_data/models_reference.npz
    python tests/torch_exchange.py --write-xk-models \
        tests/benchmark_data/xk_reference.npz
    python tests/torch_exchange.py --write-jacobi \
        tests/benchmark_data/jacobi_reference.npz
"""

import argparse
import json
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from tenpy_tpu_torch.networks import exchange  # noqa: E402

# options of the chi=256 chip run (chip_smoke.py) and of its JAX reference.
# The iDMRG wrap-seam updates start from a guess in a stale bond basis whose
# signs depend on the SVD implementation; only a converged seam Lanczos
# (tenpy_tpu's default cap of 60 with the 1e-14 early exit, not bench.py's
# 10) makes their energies independent of it.
SMOKE_OPTIONS = {'chi_max': 256, 'svd_min': 1e-10, 'lanczos_K': 10,
                 'lanczos_K_seam': 60, 'n_sweeps': 3, 'cap_factor': 1.3,
                 'backend': 'svd'}
SMOKE_REF_SWEEPS = 2


def to_host(a):
    """A ``tenpy_tpu`` Array as the port's Array (through the format)."""
    from tenpy_tpu_torch.linalg.charges import ChargeInfo
    chinfo = ChargeInfo(a.chinfo.mod, a.chinfo.names)
    return exchange.unflatten_array('a', exchange.flatten_array('a', a),
                                    chinfo)


def to_jax(a):
    """The port's Array as a ``tenpy_tpu`` Array (numpy blocks)."""
    from tenpy_tpu.linalg import np_conserved as jnpc
    from tenpy_tpu.linalg.charges import ChargeInfo, LegCharge
    chinfo = ChargeInfo(a.chinfo.mod, a.chinfo.names)
    legs = [LegCharge(chinfo, l.slices, l.charges, l.qconj) for l in a.legs]
    res = jnpc.Array(legs, str(a.dtype).replace('torch.', ''), a.qtotal,
                     list(a.get_leg_labels()))
    return res._set_blocks(a._qdata, [b.numpy() for b in a._data])


def mps_to_jax(psi, sites):
    """The port's MPS as a ``tenpy_tpu`` MPS on ``sites`` (``tenpy_tpu``
    sites, for example its model's ``lat.mps_sites()``)."""
    from tenpy_tpu.networks.mps import MPS as JMPS
    res = JMPS(sites, [to_jax(B) for B in psi._B],
               [np.array(S) for S in psi._S], bc=psi.bc, form=list(psi.form))
    res.norm = psi.norm
    return res


def assert_packed_close(p, q, rtol=1e-12):
    """Port PackedArray ``p`` equals JAX PackedArray ``q`` bucket by bucket
    (same layout; entries within ``rtol`` of the largest entry of ``q``)."""
    assert p.shapes == q.shapes
    assert p.qtotal == tuple(q.qtotal)
    assert all(np.array_equal(a, b) for a, b in zip(p.qdatas, q.qdatas))
    scale = max([float(np.abs(np.asarray(d)).max()) for d in q.data] + [1.])
    for x, y in zip(p.data, q.data):
        assert np.abs(x.numpy() - np.asarray(y)).max() <= rtol * scale


def export_flat(psi, model, options=None, reference=None, tm_energy=False):
    """Exchange dict of what ``DeviceSweepEngine`` packs for ``psi``.

    ``psi`` is copied first: the charge gauge changes the MPS in place.
    With ``tm_energy`` (infinite bc) the energies of
    ``find_init_LP_RP(calc_E=True)`` go into the references as ``tm_Es``
    and ``tm_E0``."""
    from tenpy_tpu.algorithms.packed_dmrg import (uniformize_charge_gauge,
                                                  scale_mpo_charges)
    from tenpy_tpu.networks.mpo import MPOEnvironment, MPOTransferMatrix
    opts = dict(options or {})
    psi = psi.copy()
    psi.real_if_close()
    if np.iscomplexobj(np.zeros(0, np.dtype(str(psi.dtype)))):
        raise NotImplementedError("complex states are not exported yet")
    finite = psi.bc == 'finite'
    L = psi.L
    H = model.H_MPO
    gauge = None
    if opts.get('uniform_bonds', True) and not finite:
        gauge = uniformize_charge_gauge(psi, rescale=True)
        if gauge is not None and np.any(gauge['k'] != 1):
            H = scale_mpo_charges(model.H_MPO, gauge['k'])
    init_env_data = {}
    if not finite:
        init_env_data = MPOTransferMatrix.find_init_LP_RP(
            H, psi, calc_E=tm_energy)
        if tm_energy:
            init_env_data, Es, E0 = init_env_data
            reference = dict(reference or {}, tm_Es=np.real(Es),
                             tm_E0=np.real(E0))
    env = MPOEnvironment(psi, H, psi, **init_env_data)
    B = [psi.get_B(i, 'B').transpose(['vL', 'p', 'vR']) for i in range(L)]
    W = [H.get_W(i).transpose(['wL', 'wR', 'p', 'p*']) for i in range(L)]
    S = [np.asarray(psi.get_SL(i)) for i in range(L)]
    if finite:
        S.append(np.asarray(psi.get_SR(L - 1)))
    LP0 = env.get_LP(0).transpose(['vR*', 'wR', 'vR'])
    RP = [env.get_RP(i).transpose(['wL', 'vL', 'vL*']) for i in range(L)]
    return exchange.state_to_flat(psi.bc, psi.chi, B, W, S, LP0, RP,
                                  psi.chinfo, gauge=gauge,
                                  reference=reference)


def run_phases(n_sweeps, mixer=True, settle_sweeps=None, polish_sweeps=0):
    """``(matvec_mode_is_reduced, expand)`` per sweep as ``run()`` sets them."""
    settle = (2 if mixer else 0) if settle_sweeps is None else settle_sweeps
    n_p = min(polish_sweeps, n_sweeps)
    n_settle = min(settle, n_sweeps - n_p) if mixer else 0
    b0, b1 = n_sweeps - n_p - n_settle, n_sweeps - n_p
    return [(sw >= b1, mixer and sw < b0) for sw in range(n_sweeps)]


def jax_reference(psi, model, options, n_run):
    """Run ``n_run`` sweeps of ``tenpy_tpu``'s ``DeviceSweepEngine``.

    The sweeps take the phases ``run()`` would give them under ``options``
    (so ``n_run`` may stop short of ``options['n_sweeps']``).  Returns
    ``(reference, engine)``: ``reference`` maps ``update_E0``,
    ``update_err`` (per sweep and update), ``sweep_E``, ``sweep_max_err``,
    ``lanczos_iters``, ``flops_exec`` and ``cpu_seconds`` to arrays."""
    import jax
    from tenpy_tpu.algorithms.packed_dmrg import DeviceSweepEngine
    eng = DeviceSweepEngine(psi.copy(), model, options)
    upd = []
    orig_update = eng._update

    def recording_update(*args, **kw):
        E0, err = orig_update(*args, **kw)
        upd.append((E0, err))
        return E0, err

    eng._update = recording_update
    phases = run_phases(eng.n_sweeps, eng.mixer, eng.settle_sweeps,
                        eng.polish_sweeps)
    ref = {k: [] for k in ('update_E0', 'update_err', 'sweep_E',
                           'sweep_max_err', 'lanczos_iters', 'flops_exec',
                           'cpu_seconds')}
    for sw in range(n_run):
        polish, expand = phases[sw]
        eng._cur_mode = None if polish else eng.matvec_mode
        eng._cur_expand = expand
        upd.clear()
        t0 = time.time()
        E, max_err = eng.sweep()
        ref['cpu_seconds'].append(time.time() - t0)
        host = jax.device_get(upd)
        ref['update_E0'].append([float(e) for e, _ in host])
        ref['update_err'].append([float(x) for _, x in host])
        ref['sweep_E'].append(E)
        ref['sweep_max_err'].append(max_err)
        ref['lanczos_iters'].append(list(eng._sweep_iters))
        ref['flops_exec'].append(eng._sweep_flops_exec)
    return {k: np.asarray(v) for k, v in ref.items()}, eng


# device_ramp cases held to JAX by tests/test_torch_ramp.py: a finite
# Hubbard chain in the exact regime (every stage's chi at least 4**2, the
# full middle bond) and a small infinite cylinder (Ly=2), both from Neel
# product states
RAMP_CASES = {
    'finite': ({'L': 4, 'bc_MPS': 'finite', 't': 1., 'U': 4., 'mu': 0.},
               ['up', 'down'] * 2,
               {'chi_list': [[16, 2], [32, 3]], 'svd_min': 1e-12,
                'lanczos_K': 10, 'multiple': 16, 'backend': 'svd'}),
    'infinite': ({'lattice': 'Square', 'Lx': 2, 'Ly': 2, 'bc_y': 'cylinder',
                  'bc_MPS': 'infinite', 't': 1., 'U': 8., 'mu': 0.},
                 ['up', 'down', 'down', 'up'],
                 {'chi_max': 4, 'svd_min': 1e-10, 'lanczos_K': 10,
                  'lanczos_K_seam': 60, 'sweeps_per_stage': 1,
                  'n_sweeps': 2, 'multiple': 16, 'backend': 'svd'}),
}


def ramp_model(case, package):
    """The model and product state of a ramp case in ``package`` (the
    module prefix ``tenpy_tpu`` or ``tenpy_tpu_torch``)."""
    import importlib
    params, init, _ = RAMP_CASES[case]
    hub = importlib.import_module(package + '.models.hubbard')
    mps = importlib.import_module(package + '.networks.mps')
    cls = hub.FermiHubbardChain if params['bc_MPS'] == 'finite' \
        else hub.FermiHubbardModel
    m = cls(dict(params))
    psi = mps.MPS.from_product_state(m.lat.mps_sites(), init,
                                     bc=params['bc_MPS'])
    return m, psi


def ramp_reference(case):
    """``tenpy_tpu``'s ``device_ramp`` on a ramp case: per sweep the energy,
    the largest truncation error and the Lanczos steps, per stage its chi,
    and the final bonds' Schmidt values (sorted)."""
    from tenpy_tpu.algorithms.packed_dmrg import device_ramp
    m, psi = ramp_model(case, 'tenpy_tpu')
    t0 = time.time()
    eng = device_ramp(psi, m, dict(RAMP_CASES[case][2]))
    st = eng.sweep_stats
    ref = {'sweep_E': np.asarray(st['E']),
           'sweep_max_err': np.asarray(st['max_err']),
           'lanczos_iters': np.asarray([sum(x) for x in st['lanczos_iters']]),
           'cpu_seconds': np.asarray(time.time() - t0)}
    for i, S in enumerate(eng.Sp):
        S = np.asarray(S)
        ref[f'S.{i}'] = np.sort(S[S > 0])[::-1]
    return ref


SMALL_MODEL = {'lattice': 'Square', 'Lx': 2, 'Ly': 2, 'bc_y': 'cylinder',
               'bc_MPS': 'infinite', 't': 1., 'U': 8., 'mu': 0.}


def write_small(path):
    """A chi=16 iMPS of the Ly=2 Hubbard cylinder from ``tenpy_tpu``'s host
    iDMRG (3 sweeps from a Neel state), with its MPO, environments, gauge
    and transfer-matrix energies (tests/test_torch_mpo_env.py)."""
    from tenpy_tpu.algorithms import dmrg
    from tenpy_tpu.models.hubbard import FermiHubbardModel
    from tenpy_tpu.networks.mps import MPS
    m = FermiHubbardModel(dict(SMALL_MODEL))
    psi = MPS.from_product_state(m.lat.mps_sites(),
                                 ['up', 'down', 'down', 'up'], bc='infinite')
    dmrg.TwoSiteDMRGEngine(psi, m, {
        'trunc_params': {'chi_max': 16, 'svd_min': 1e-12}, 'max_sweeps': 3,
        'mixer': True}).run()
    exchange.save_flat(path, export_flat(psi, m, tm_energy=True))


def _hubbard_chi256():
    import gzip
    import pickle
    from tenpy_tpu.models.hubbard import FermiHubbardModel
    m = FermiHubbardModel({'lattice': 'Square', 'Lx': 2, 'Ly': 4,
                           'bc_y': 'cylinder', 'bc_MPS': 'infinite',
                           't': 1., 'U': 8., 'mu': 0.})
    path = os.path.join(_ROOT, 'tests', 'benchmark_data',
                        'hubbard_cyl_chi256.pkl.gz')
    with gzip.open(path, 'rb') as f:
        psi = pickle.load(f)   # the repo's own shipped benchmark state
    psi.real_if_close()
    return m, psi


def write_ramps(path):
    """Write :func:`ramp_reference` of every ramp case into one file."""
    flat = {}
    for case in RAMP_CASES:
        ref = ramp_reference(case)
        print(f"{case} ramp: E={ref['sweep_E']} "
              f"seconds={float(ref['cpu_seconds']):.0f}", flush=True)
        flat.update({f'{case}.{k}': v for k, v in ref.items()})
        flat[f'{case}.options'] = np.array(json.dumps(RAMP_CASES[case][2]))
    exchange.save_flat(path, flat)


def measure_written_back(psi, H):
    """What a user measures on a written-back iMPS: Schmidt values per bond
    (sorted, descending), the TM energy per site, the entanglement entropies,
    ``Ntot`` and ``Sz`` per site, the correlation length and ``norm_test``,
    with the seconds of each.  ``psi`` and ``H`` are of either package."""
    out, sec = {}, {}
    for i in range(psi.L):
        out[f'S.{i}'] = np.sort(np.asarray(psi.get_SL(i)))[::-1]
    t = time.time()
    out['tm_E'] = float(np.real(H.expectation_value(psi)))
    sec['tm_E'] = time.time() - t
    t = time.time()
    out['entropy'] = np.asarray(psi.entanglement_entropy())
    out['Ntot'] = np.real(np.asarray(psi.expectation_value('Ntot')))
    out['Sz'] = np.real(np.asarray(psi.expectation_value('Sz')))
    sec['local'] = time.time() - t
    t = time.time()
    out['xi'] = float(psi.correlation_length())
    sec['xi'] = time.time() - t
    out['norm_test_after'] = float(np.max(psi.norm_test()))
    return out, sec


class CanonicalFormProbe:
    """Wraps ``MPS.canonical_form`` of a module (either package's
    ``networks.mps``) while in use: records ``max(norm_test)`` before each
    call and the call's seconds."""

    def __init__(self, mps_module):
        self.cls = mps_module.MPS
        self.before, self.seconds = [], []

    def __enter__(self):
        self.orig = self.cls.canonical_form
        probe = self

        def wrapped(psi, **kw):
            probe.before.append(float(np.max(psi.norm_test())))
            t = time.time()
            res = probe.orig(psi, **kw)
            probe.seconds.append(time.time() - t)
            return res

        self.cls.canonical_form = wrapped
        return self

    def __exit__(self, *exc):
        self.cls.canonical_form = self.orig


# the write-back case of tests/test_torch_write_back.py, the port of
# tests/test_packed_dmrg.py:267 (a spin-1 chain grown 8 -> 64): a
# single-stage 8x chi growth (1 -> 8) from a product state, on the ionic
# Hubbard chain (staggered potential +-4, U=2).  It is a band insulator,
# so chi=8 truncates little and the seam drift stays below the test's
# 1e-5; the uniform half-filled chain is gapless, and at chi=8 its drift
# would hide a write-back fault.
WRITE_BACK_CASES = {
    'ionic': ({'L': 2, 'bc_MPS': 'infinite', 't': 1., 'U': 2.,
               'mu': np.array([4., -4.])},
              ['full', 'empty'],
              {'chi_max': 8, 'svd_min': 1e-12, 'lanczos_K': 10,
               'lanczos_K_seam': 60, 'n_sweeps': 6, 'multiple': 4,
               'backend': 'svd'}),
}


def charge_frame(psi):
    """The charge frame of an MPS of either package: each tensor's
    ``qtotal`` and the sorted charges (``qflat * qconj``) of its vL leg."""
    out = {'qtotal': np.array([psi.get_B(i, None).qtotal
                               for i in range(psi.L)])}
    for i in range(psi.L):
        leg = psi.get_B(i, None).get_leg('vL')
        q = np.asarray(leg.to_qflat()) * leg.qconj
        out[f'vL_q.{i}'] = q[np.lexsort(q.T[::-1])]
    return out


def write_back_reference(case):
    """``tenpy_tpu``'s ``DeviceSweepEngine.run()`` on a write-back case: the
    energy of every sweep, ``norm_test`` before the re-gauge, and
    :func:`measure_written_back` of the written-back state; returns
    ``(ref, psi)``, ``psi`` the written-back state."""
    import tenpy_tpu.networks.mps as mpsmod
    from tenpy_tpu.algorithms.packed_dmrg import DeviceSweepEngine
    from tenpy_tpu.models.hubbard import FermiHubbardChain
    params, init, options = WRITE_BACK_CASES[case]
    m = FermiHubbardChain(dict(params))
    psi = mpsmod.MPS.from_product_state(m.lat.mps_sites(), init,
                                        bc='infinite')
    eng = DeviceSweepEngine(psi, m, dict(options))
    with CanonicalFormProbe(mpsmod) as probe:
        E, psi = eng.run()
    ref, _ = measure_written_back(psi, m.H_MPO)
    ref.update(charge_frame(psi))
    ref.update(sweep_E=np.asarray(eng.sweep_stats['E']),
               norm_test_before=np.asarray(probe.before),
               options=np.array(json.dumps(options)))
    return ref, psi


def chi256_write_back_reference():
    """``tenpy_tpu``'s ``DeviceSweepEngine.run()`` with ``SMOKE_OPTIONS`` on
    the committed chi=256 state (the run of ``chip_smoke.py`` phase 5): the
    sweep energies, ``norm_test`` before and after the re-gauge, the
    seconds of write-back, re-gauge and measurements, the log lines of
    ``canonical_form_infinite`` and :func:`measure_written_back`.  About 15
    minutes on a CPU."""
    import logging
    import tenpy_tpu.networks.mps as mpsmod
    from tenpy_tpu.algorithms.packed_dmrg import DeviceSweepEngine
    m, psi = _hubbard_chi256()
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logging.getLogger(mpsmod.__name__).addHandler(handler)
    t0 = time.time()
    eng = DeviceSweepEngine(psi, m, dict(SMOKE_OPTIONS))
    orig_wb = eng.write_back
    wb_seconds = []

    def timed_write_back():
        t = time.time()
        orig_wb()
        wb_seconds.append(time.time() - t)

    eng.write_back = timed_write_back
    try:
        with CanonicalFormProbe(mpsmod) as probe:
            E, psi = eng.run()
    finally:
        logging.getLogger(mpsmod.__name__).removeHandler(handler)
    run_s = time.time() - t0
    ref, sec = measure_written_back(psi, m.H_MPO)
    ref.update(sweep_E=np.asarray(eng.sweep_stats['E']),
               norm_test_before=np.asarray(probe.before),
               canonical_form_s=np.asarray(probe.seconds),
               write_back_s=np.asarray(wb_seconds),
               run_s=np.asarray(run_s),
               cf_log=np.array(records if records else ['']),
               options=np.array(json.dumps(SMOKE_OPTIONS)))
    for k, v in sec.items():
        ref[f'{k}_s'] = np.asarray(v)
    return ref


def write_write_back(path, cases):
    """Write the write-back references of ``cases`` (``'chi256'`` and the
    keys of ``WRITE_BACK_CASES``) into ``path``, keeping the other cases an
    existing file holds."""
    flat = exchange.load_flat(path) if os.path.exists(path) else {}
    for case in cases:
        t0 = time.time()
        ref = chi256_write_back_reference() if case == 'chi256' \
            else write_back_reference(case)[0]
        flat = {k: v for k, v in flat.items()
                if not k.startswith(case + '.')}
        flat.update({f'{case}.{k}': np.asarray(v) for k, v in ref.items()})
        print(f"{case}: tm_E={ref['tm_E']!r} norm_test before "
              f"{ref['norm_test_before']} after {ref['norm_test_after']:.2e} "
              f"xi={ref['xi']!r} ({time.time() - t0:.0f} s)", flush=True)
    exchange.save_flat(path, flat)


# the Hofstadter cases (BASELINE config #5: spinless fermions, flux 1/3 in
# the Landau gauge, so the MPO is complex).  'finite' is the port of
# tests/test_packed_dmrg.py:204 (Lx=3, Ly=2, chi=16 >= 2**3: exact),
# 'infinite' a chi=16 iDMRG of the Lx=3, Ly=3 cylinder at 1/3 filling, whose
# unit-cell charge (Q=3 on L=9 sites) takes the charge-unit rescale of the
# uniform gauge (tests/test_torch_hofstadter.py); 'chi128' the chip run of
# chip_smoke.py: device_ramp to chi=128 at full width, then the write-back
HOFSTADTER_MODEL = {'lattice': 'Square', 'Lx': 3, 'Ly': 3, 'bc_y': 'cylinder',
                    'bc_MPS': 'infinite', 'phi': (1, 3), 'conserve': 'N',
                    'mu': 0., 'v': 0.}
HOFSTADTER_INIT = ['full', 'empty', 'empty'] * 3
HOFSTADTER_OPTIONS = {'chi_max': 128, 'svd_min': 1e-10, 'lanczos_K': 10,
                      'lanczos_K_seam': 60, 'sweeps_per_stage': 2,
                      'n_sweeps': 4, 'backend': 'svd'}
HOFSTADTER_CASES = {
    'finite': ({'lattice': 'Square', 'Lx': 3, 'Ly': 2, 'phi': (1, 3),
                'bc_y': 'cylinder', 'bc_MPS': 'finite', 'conserve': 'N',
                'mu': 0.5},
               ['full', 'empty'] * 3,
               {'chi_max': 16, 'svd_min': 1e-12, 'lanczos_K': 10,
                'n_sweeps': 6, 'multiple': 8, 'backend': 'svd'}),
    'infinite': (HOFSTADTER_MODEL, HOFSTADTER_INIT,
                 {'chi_max': 16, 'svd_min': 1e-10, 'lanczos_K': 10,
                  'lanczos_K_seam': 60, 'n_sweeps': 3, 'multiple': 8,
                  'backend': 'svd'}),
    'chi128': (HOFSTADTER_MODEL, HOFSTADTER_INIT, HOFSTADTER_OPTIONS),
}


def hofstadter_model(case, package):
    """The model and product state of a Hofstadter case in ``package``
    (``tenpy_tpu`` or ``tenpy_tpu_torch``)."""
    import importlib
    params, init, _ = HOFSTADTER_CASES[case]
    hof = importlib.import_module(package + '.models.hofstadter')
    mps = importlib.import_module(package + '.networks.mps')
    m = hof.HofstadterFermions(dict(params))
    psi = mps.MPS.from_product_state(m.lat.mps_sites(), init,
                                     bc=params['bc_MPS'])
    return m, psi


def measure_hofstadter(psi, H):
    """What a user measures on a written-back Hofstadter MPS of either
    package: the energy (TM energy per site for infinite bc, the full
    contraction for finite), the entropies, ``N`` per site, the correlation
    length (infinite) and ``norm_test``."""
    from importlib import import_module
    mpo = import_module(type(H).__module__)
    out = {'entropy': np.asarray(psi.entanglement_entropy()),
           'N': np.real(np.asarray(psi.expectation_value('N'))),
           'norm_test': float(np.max(psi.norm_test()))}
    if psi.bc == 'finite':
        out['E'] = float(np.real(mpo.MPOEnvironment(psi, H, psi)
                                 .full_contraction(psi.L // 2)))
    else:
        out['tm_E'] = float(np.real(H.expectation_value(psi)))
        out['xi'] = float(psi.correlation_length())
    return out


def hofstadter_reference(case):
    """``tenpy_tpu``'s run of a Hofstadter case: ``DeviceSweepEngine.run()``
    ('finite', 'infinite') or ``device_ramp`` ('chi128') from the product
    state; the energy of every sweep, every update of the first sweep and
    every stage, the charge-unit rescale, and
    :func:`measure_hofstadter` of the written-back state.  For 'finite'
    also the host DMRG energy of tests/test_packed_dmrg.py:204.  Returns
    ``(ref, psi)``, ``psi`` the written-back state."""
    import jax
    import tenpy_tpu.algorithms.packed_dmrg as jpd
    params, _, options = HOFSTADTER_CASES[case]
    m, psi = hofstadter_model(case, 'tenpy_tpu')
    upd = []
    orig_update = jpd.DeviceSweepEngine._update

    def recording_update(self, *args, **kw):
        E0, err = orig_update(self, *args, **kw)
        upd.append(E0)
        return E0, err

    gauges = []
    orig_setup = jpd.DeviceSweepEngine._setup

    def recording_setup(self):
        orig_setup(self)
        gauges.append(self._gauge_info)

    # the engine runs op by op (jit off), and every stage drops the compiled
    # ops of the ones before: compiled whole, the update programs of a
    # ramp's stages (thousands of XLA CPU kernels each, every kernel mapped
    # into memory on its own) exceed the limit of memory mappings per
    # process before the chi=128 stage
    orig_run = jpd.DeviceSweepEngine.run

    def stage_run(self):
        jax.clear_caches()
        return orig_run(self)

    jpd.DeviceSweepEngine._update = recording_update
    jpd.DeviceSweepEngine._setup = recording_setup
    jpd.DeviceSweepEngine.run = stage_run
    t0 = time.time()
    try:
        with jax.disable_jit():
            if case == 'chi128':
                eng = jpd.device_ramp(psi, m, dict(options))
            else:
                eng = jpd.DeviceSweepEngine(psi, m, dict(options))
                eng.run()
    finally:
        jpd.DeviceSweepEngine._update = orig_update
        jpd.DeviceSweepEngine._setup = orig_setup
        jpd.DeviceSweepEngine.run = orig_run
    seconds = time.time() - t0
    st = eng.sweep_stats
    n_upd = 2 * (psi.L - 1 if psi.bc == 'finite' else psi.L)
    ref = measure_hofstadter(psi, m.H_MPO)
    ref.update(sweep_E=np.asarray(st['E']),
               sweep_max_err=np.asarray(st['max_err']),
               update_E0=np.asarray(jax.device_get(upd[:n_upd]), float),
               lanczos_iters=np.asarray([sum(x)
                                         for x in st['lanczos_iters']]),
               cpu_seconds=np.asarray(seconds),
               options=np.array(json.dumps(options)),
               model=np.array(json.dumps(params)))
    k = gauges[0]['k'] if gauges and gauges[0] is not None else None
    ref['gauge_k'] = np.asarray(k if k is not None else [1])
    for i in range(psi.L):
        ref[f'S.{i}'] = np.sort(np.asarray(psi.get_SL(i)))[::-1]
    if case == 'finite':
        from tenpy_tpu.algorithms import dmrg
        m2, psi2 = hofstadter_model(case, 'tenpy_tpu')
        E_host, _ = dmrg.TwoSiteDMRGEngine(psi2, m2, {
            'trunc_params': {'chi_max': 16, 'svd_min': 1e-12},
            'max_sweeps': 10, 'mixer': True}).run()
        ref['E_host'] = np.asarray(float(np.real(E_host)))
    return ref, psi


def write_hofstadter(path, cases):
    """Write :func:`hofstadter_reference` of ``cases`` into ``path``,
    keeping the other cases an existing file holds."""
    flat = exchange.load_flat(path) if os.path.exists(path) else {}
    for case in cases:
        ref, _ = hofstadter_reference(case)
        flat = {k: v for k, v in flat.items()
                if not k.startswith(case + '.')}
        flat.update({f'{case}.{k}': np.asarray(v) for k, v in ref.items()})
        print(f"{case}: E={ref['sweep_E']} "
              f"{ {k: ref[k] for k in ('E', 'tm_E', 'xi') if k in ref} } "
              f"k={ref['gauge_k']} ({float(ref['cpu_seconds']):.0f} s)",
              flush=True)
    exchange.save_flat(path, flat)

def state_flat(prefix, psi):
    """An MPS of either package in the exchange format, every key under
    ``prefix``: its tensors in their stored forms, no MPO or
    environments."""
    names = {v: k for k, v in type(psi)._valid_forms.items()}
    L = psi.L
    S = [np.asarray(psi.get_SL(i)) for i in range(L)]
    if psi.bc == 'finite':
        S.append(np.asarray(psi.get_SR(L - 1)))
    flat = exchange.state_to_flat(psi.bc, psi.chi, list(psi._B), None, S,
                                  None, None, psi.chinfo,
                                  forms=[names[f] for f in psi.form])
    return {f'{prefix}.{k}': v for k, v in flat.items()}


def load_state(flat, prefix, sites):
    """The state :func:`state_flat` stored under ``prefix`` as the port's
    MPS on ``sites``."""
    sub = {k[len(prefix) + 1:]: v for k, v in flat.items()
           if k.startswith(prefix + '.')}
    return exchange.load_mps(sub, sites)


def sorted_S(psi):
    """The Schmidt values of every bond (``L`` for infinite bc, ``L + 1``
    for finite), each sorted descending, of an MPS of either package."""
    n = psi.L + 1 if psi.bc == 'finite' else psi.L
    return [np.sort(np.asarray(psi._S[i]))[::-1] for i in range(n)]


def bond_energies(psi, model):
    """``<H_bond>`` on every bond of the unit cell (finite: bonds
    ``1..L-1``; infinite: ``H_bond[i]`` on sites ``(i-1, i)`` for
    ``i = 1..L``), for an MPS and model of either package."""
    L = psi.L
    if psi.bc == 'finite':
        return np.real(np.asarray(psi.expectation_value(
            model.H_bond[1:], range(L - 1))))
    ops = [model.H_bond[(i + 1) % L] for i in range(L)]
    return np.real(np.asarray(psi.expectation_value(ops, range(L))))


# the TEBD cases of tests/test_packed_tebd.py: real time (:32) on the S=1
# chain from its host-DMRG state, finite L=8 and infinite L=2; imaginary
# time (:57) on the transverse-field Ising chain with parity, in two dt
# stages.  tests/test_torch_tebd.py runs the port on the same states
def spin1_params(bc, L):
    """The S=1 XXZ chain of tests/test_packed_tebd.py:20."""
    return {'S': 1., 'L': L, 'Jx': 1., 'Jy': 1., 'Jz': 0.7, 'bc_MPS': bc,
            'conserve': 'Sz'}


TEBD_REAL_CASES = {'real_finite': ('finite', 8), 'real_infinite':
                   ('infinite', 2)}
TEBD_REAL_OPTIONS = {'N_steps': 3, 'dt': 0.05, 'order': 2, 'chi_max': 32,
                     'svd_min': 1e-10, 'multiple': 8, 'type_evo': 'real'}
TFI_PARAMS = {'L': 8, 'J': 1., 'g': 1.2, 'bc_MPS': 'finite',
              'conserve': 'parity'}
TEBD_IMAG_DTS = (0.1, 0.01)
TEBD_IMAG_OPTIONS = {'N_steps': 20, 'order': 2, 'type_evo': 'imag',
                     'chi_max': 16, 'svd_min': 1e-12, 'multiple': 8}
# the seed of tests/test_packed_dmrg.py:329 (test_device_ramp_staged):
# _ramped_state(L=8, chi=4, sweeps=2) on the S=1 Heisenberg chain, and the
# host DMRG energy at chi=32 it is held to
RAMP_SPIN_PARAMS = {'S': 1., 'L': 8, 'Jx': 1., 'Jy': 1., 'Jz': 1.,
                    'bc_MPS': 'finite', 'conserve': 'Sz'}
RAMP_SPIN_OPTIONS = {'chi_max': 32, 'svd_min': 1e-12, 'lanczos_K': 10,
                     'sweeps_per_stage': 3, 'n_sweeps': 10, 'multiple': 8}


def _host_dmrg(psi, m, chi, sweeps):
    from tenpy_tpu.algorithms import dmrg
    E, _ = dmrg.TwoSiteDMRGEngine(psi, m, {
        'trunc_params': {'chi_max': chi, 'svd_min': 1e-12},
        'max_sweeps': sweeps, 'mixer': True}).run()
    return float(np.real(E))


def tebd_reference():
    """``tenpy_tpu``'s ``DeviceTEBDEngine`` on the cases of
    tests/test_packed_tebd.py, as a flat dict: the start states (the host
    DMRG states, ``<case>.psi0``), the evolved time, the truncation error,
    the Schmidt values per bond of the written-back state (``S.<bond>``,
    sorted; before any re-gauge, as the engine leaves them), and ``Sz``
    per site and the bond energies of that state after
    ``canonical_form()``; for the finite real-time case also the
    written-back state itself (``<case>.psi``).  Then the imaginary-time
    stages, each followed by ``canonical_form()`` as in the test, and the
    seed state and host energy of test_device_ramp_staged."""
    from tenpy_tpu.algorithms.packed_tebd import DeviceTEBDEngine
    from tenpy_tpu.models.spins import SpinChain
    from tenpy_tpu.models.tf_ising import TFIChain
    from tenpy_tpu.networks.mps import MPS as JMPS
    flat = {}
    for case, (bc, L) in TEBD_REAL_CASES.items():
        t0 = time.time()
        m = SpinChain(spin1_params(bc, L))
        psi = JMPS.from_product_state(m.lat.mps_sites(),
                                      (['1.0', '-1.0'] * L)[:L], bc=bc)
        _host_dmrg(psi, m, 24, 3 if bc == 'finite' else 10)
        flat.update(state_flat(f'{case}.psi0', psi))
        eng = DeviceTEBDEngine(psi, m, dict(TEBD_REAL_OPTIONS))
        err = eng.run()
        ref = {'evolved_time': eng.evolved_time, 'trunc_err': err.eps,
               'norm_test': float(np.max(psi.norm_test()))}
        for i, S in enumerate(sorted_S(psi)):
            ref[f'S.{i}'] = S
        if bc == 'finite':
            flat.update(state_flat(f'{case}.psi', psi))
        psi.canonical_form()
        ref['Sz'] = np.real(np.asarray(psi.expectation_value('Sz')))
        ref['E_bond'] = bond_energies(psi, m)
        flat.update({f'{case}.{k}': np.asarray(v) for k, v in ref.items()})
        print(f"{case}: trunc_err {err.eps:.3e}, norm_test "
              f"{ref['norm_test']:.2e} ({time.time() - t0:.0f} s)",
              flush=True)
    t0 = time.time()
    m = TFIChain(dict(TFI_PARAMS))
    L = TFI_PARAMS['L']
    psi = JMPS.from_product_state(m.lat.mps_sites(), ['up'] * L,
                                  bc='finite')
    for k, dt in enumerate(TEBD_IMAG_DTS):
        eng = DeviceTEBDEngine(psi, m, dict(TEBD_IMAG_OPTIONS, dt=dt))
        err = eng.run()
        psi.canonical_form()
        ref = {'evolved_time': eng.evolved_time, 'trunc_err': err.eps,
               'E_bond': bond_energies(psi, m)}
        for i, S in enumerate(sorted_S(psi)):
            ref[f'S.{i}'] = S
        flat.update({f'imag.{k}.{key}': np.asarray(v)
                     for key, v in ref.items()})
    print(f"imag: E {np.sum(flat['imag.1.E_bond']):.12f} "
          f"({time.time() - t0:.0f} s)", flush=True)
    t0 = time.time()
    m = SpinChain(dict(RAMP_SPIN_PARAMS))
    L = RAMP_SPIN_PARAMS['L']
    psi = JMPS.from_product_state(m.lat.mps_sites(),
                                  (['1.0', '-1.0'] * L)[:L], bc='finite')
    _host_dmrg(psi, m, 4, 2)
    flat.update(state_flat('ramp_spin.psi0', psi))
    flat['ramp_spin.E_host'] = np.asarray(_host_dmrg(psi.copy(), m, 32, 20))
    print(f"ramp_spin: E_host {float(flat['ramp_spin.E_host']):.12f} "
          f"({time.time() - t0:.0f} s)", flush=True)
    flat['options'] = np.array(json.dumps({
        'spin1': {case: spin1_params(bc, L)
                  for case, (bc, L) in TEBD_REAL_CASES.items()},
        'real': TEBD_REAL_OPTIONS, 'imag': TEBD_IMAG_OPTIONS,
        'imag_dts': TEBD_IMAG_DTS, 'tfi': TFI_PARAMS,
        'ramp_spin': [RAMP_SPIN_PARAMS, RAMP_SPIN_OPTIONS]}))
    return flat


def written_back_states():
    """``tenpy_tpu``'s written-back states of two committed cases, for the
    distance to the port's: the ionic chain of ``WRITE_BACK_CASES`` (its
    TM energy beside it, to tie it to
    ``hubbard_write_back_reference.npz``) and the finite Hofstadter case
    of ``HOFSTADTER_CASES`` (its energy, likewise for
    ``hofstadter_reference.npz``)."""
    flat = {}
    t0 = time.time()
    ref, psi = write_back_reference('ionic')
    flat.update(state_flat('ionic.psi', psi))
    flat['ionic.tm_E'] = np.asarray(ref['tm_E'])
    print(f"ionic: tm_E {ref['tm_E']!r} ({time.time() - t0:.0f} s)",
          flush=True)
    t0 = time.time()
    ref, psi = hofstadter_reference('finite')
    flat.update(state_flat('hofstadter_finite.psi', psi))
    flat['hofstadter_finite.E'] = np.asarray(ref['E'])
    print(f"hofstadter finite: E {ref['E']!r} ({time.time() - t0:.0f} s)",
          flush=True)
    return flat


# the cases of tests/test_dmrg.py:76-184 (TeNPy's dmrg.run on the
# transverse-field Ising and Heisenberg chains, built from terms as there);
# tests/test_torch_host_dmrg.py runs the port's dmrg.run on the same models
# and start states and holds it to these values
class FakeModel:
    """The model stub of tests/test_dmrg.py: a lattice stub and H_MPO."""

    def __init__(self, sites, H):
        L = len(sites)

        class _Lat:
            bc_MPS = H.bc if H.bc != 'segment' else 'finite'
            dim = 1
            Ls = [L]
            unit_cell = [sites[0]]

            def mps_sites(self):
                return sites

        self.lat = _Lat()
        self.H_MPO = H


def _host_modules(package):
    if package == 'jax':
        from tenpy_tpu.networks import mpo, mps, site, terms
    else:
        from tenpy_tpu_torch.networks import mpo, mps, site, terms
    return site, terms, mpo, mps


def tfi_model(package, L, J=1., g=1.5, bc='finite'):
    """The transverse-field Ising chain of tests/test_dmrg.py:47 (Z_2
    parity) in ``package`` ('jax' or 'torch'): ``(model, MPS class)``."""
    site, terms, mpo, mps = _host_modules(package)
    sites = [site.SpinHalfSite('parity')] * L
    ot = terms.OnsiteTerms(L)
    ct = terms.CouplingTerms(L)
    for i in range(L):
        ot.add_onsite_term(-g, i, 'Sigmaz')
    for i in range(L - 1 if bc == 'finite' else L):
        ct.add_coupling_term(-J, i, i + 1, 'Sigmax', 'Sigmax')
    H = mpo.MPOGraph.from_terms([ot, ct], sites, bc).build_MPO()
    return FakeModel(sites, H), mps.MPS


def heisenberg_model(package, L, J=1., bc='finite'):
    """The Heisenberg chain of tests/test_dmrg.py:61 (Sz conserved)."""
    site, terms, mpo, mps = _host_modules(package)
    sites = [site.SpinHalfSite('Sz')] * L
    ct = terms.CouplingTerms(L)
    for i in range(L - 1 if bc == 'finite' else L):
        ct.add_coupling_term(J, i, i + 1, 'Sz', 'Sz')
        ct.add_coupling_term(J / 2., i, i + 1, 'Sp', 'Sm')
        ct.add_coupling_term(J / 2., i, i + 1, 'Sm', 'Sp')
    H = mpo.MPOGraph.from_terms([ct], sites, bc).build_MPO()
    return FakeModel(sites, H), mps.MPS


def _trunc(chi, svd_min):
    return {'chi_max': chi, 'svd_min': svd_min}


# case: (model, L, bc, product state, options) of each test of
# tests/test_dmrg.py:76-184; 'excited' adds the first excited state from
# the Neel state shifted by one site, orthogonal to the ground state
HOST_DMRG_CASES = {
    'tfi': ('tfi', 16, 'finite', ['up'] * 16, {
        'trunc_params': _trunc(32, 1e-13), 'max_E_err': 1e-12,
        'max_sweeps': 30, 'combine': False, 'mixer': False}),
    'tfi_combine': ('tfi', 16, 'finite', ['up'] * 16, {
        'trunc_params': _trunc(32, 1e-13), 'max_E_err': 1e-12,
        'max_sweeps': 30, 'combine': True, 'mixer': False}),
    'excited': ('heisenberg', 8, 'finite', ['up', 'down'] * 4, {
        'trunc_params': _trunc(64, 1e-14), 'max_E_err': 1e-12,
        'max_sweeps': 40, 'mixer': False}),
    'mixer': ('heisenberg', 10, 'finite', ['up', 'down'] * 5, {
        'trunc_params': _trunc(64, 1e-14), 'max_E_err': 1e-12,
        'max_sweeps': 40, 'mixer': True,
        'mixer_params': {'amplitude': 1e-6, 'decay': 1.5,
                         'disable_after': 5}}),
    'single_site': ('heisenberg', 10, 'finite', None, {
        'active_sites': 1, 'mixer': False,
        'trunc_params': _trunc(64, 1e-14), 'max_E_err': 1e-12,
        'max_sweeps': 50}),
    'growth': ('heisenberg', 10, 'finite', ['up', 'down'] * 5, {
        'active_sites': 1, 'trunc_params': _trunc(64, 1e-14),
        'max_E_err': 1e-12, 'max_sweeps': 20,
        'mixer_params': {'amplitude': 1e-5, 'decay': 1.2,
                         'disable_after': 10}}),
    'idmrg': ('tfi', 2, 'infinite', ['up', 'up'], {
        'trunc_params': _trunc(32, 1e-14), 'max_E_err': 1e-12,
        'max_sweeps': 60, 'N_sweeps_check': 5, 'mixer': False,
        'update_env': 2}),
}
# test_single_site_dmrg starts from a random state of chi 32 (seed 7), made
# by tenpy_tpu; the port loads it from the reference file
SINGLE_SITE_SEED = {'chi': 32, 'seed': 7}
# tests/test_packed.py:187 (test_diag_device_lanczos_integration): the
# infinite Hubbard chain after tenpy_tpu's 3 sweeps with the device route
# forced (device_K) and the mixer; its state is stored, and the port's test
# compares both packages' device route and the port's host Lanczos on the
# next update's effective H
INTEGRATION_MODEL = {'L': 2, 't': 1., 'U': 4., 'bc_MPS': 'infinite'}
INTEGRATION_OPTIONS = {'trunc_params': {'chi_max': 32, 'svd_min': 1e-10},
                       'max_sweeps': 3, 'mixer': True, 'combine': False,
                       'lanczos_params': {'N_min': 30, 'N_max': 30,
                                          'device_K': 30, 'reortho': True}}


def host_dmrg_case(case, package):
    """``(model, psi, options)`` of a case of :data:`HOST_DMRG_CASES` in
    ``package``; the random start state of 'single_site' only for 'jax'
    (the port loads tenpy_tpu's)."""
    import copy
    name, L, bc, p_state, options = HOST_DMRG_CASES[case]
    make = tfi_model if name == 'tfi' else heisenberg_model
    model, MPS = make(package, L, bc=bc)
    sites = model.lat.mps_sites()
    if p_state is None:
        psi = MPS.from_desired_bond_dimension(
            sites, SINGLE_SITE_SEED['chi'], seed=SINGLE_SITE_SEED['seed'],
            p_state=['up', 'down'] * (L // 2)) if package == 'jax' else None
    else:
        psi = MPS.from_product_state(sites, p_state, bc=bc)
    return model, psi, copy.deepcopy(options)


def host_dmrg_result(prefix, info_E, stats, psi):
    """A run's energy, per-sweep energies and sorted Schmidt values as
    flat keys under ``prefix``."""
    flat = {f'{prefix}.E': np.asarray(float(np.real(info_E))),
            f'{prefix}.sweep_E': np.asarray(stats['E'], float)}
    for i, S in enumerate(sorted_S(psi)):
        flat[f'{prefix}.S.{i}'] = S
    return flat


def host_dmrg_reference():
    """``tenpy_tpu``'s ``dmrg.run`` on every case of
    :data:`HOST_DMRG_CASES`, as a flat dict: energy, per-sweep energies
    and Schmidt values (``<case>.*``), the exact energies the JAX tests
    hold it to (``ExactDiag`` for the Heisenberg chains, free fermions for
    the Ising chains), the start state of 'single_site', and the final
    state of 'excited', whose centre update the device-route test
    takes."""
    from tenpy_tpu.algorithms import dmrg
    from tenpy_tpu.algorithms.exact_diag import ExactDiag
    flat = {}
    for case in HOST_DMRG_CASES:
        t0 = time.time()
        model, psi, options = host_dmrg_case(case, 'jax')
        if case == 'single_site':
            flat.update(state_flat(f'{case}.psi0', psi))
        if case == 'excited':
            eng = dmrg.TwoSiteDMRGEngine(psi, model, options)
            E0, _ = eng.run()
            flat.update(host_dmrg_result('excited.ground', E0,
                                         eng.sweep_stats, psi))
            flat.update(state_flat('excited.ground.psi', psi))
            options1 = host_dmrg_case(case, 'jax')[2]
            psi1 = type(psi).from_product_state(
                model.lat.mps_sites(), ['down', 'up'] * 4)
            eng1 = dmrg.TwoSiteDMRGEngine(psi1, model, options1,
                                          orthogonal_to=[psi])
            E1, _ = eng1.run()
            flat.update(host_dmrg_result('excited.first', E1,
                                         eng1.sweep_stats, psi1))
            flat['excited.overlap'] = np.asarray(abs(psi.overlap(psi1)))
        else:
            info = dmrg.run(psi, model, options)
            flat.update(host_dmrg_result(case, info['E'],
                                         info['sweep_statistics'], psi))
        if HOST_DMRG_CASES[case][0] == 'heisenberg':
            ed = ExactDiag.from_H_mpo(model.H_MPO, charge_sector=[0])
            ed.full_diagonalization()
            flat[f'{case}.E_exact'] = np.asarray(
                float(ed.groundstate()[0]))
            flat[f'{case}.E_levels'] = np.sort(np.asarray(ed.E))[:2]
        E = flat.get(f'{case}.E', flat.get(f'{case}.ground.E'))
        print(f"{case}: E {float(E):.14f} ({time.time() - t0:.1f} s)",
              flush=True)
    t0 = time.time()
    from tenpy_tpu.models.hubbard import FermiHubbardChain
    from tenpy_tpu.networks.mps import MPS as JMPS
    m = FermiHubbardChain(dict(INTEGRATION_MODEL))
    psi = JMPS.from_product_state(m.lat.mps_sites(), ['up', 'down'],
                                  bc='infinite')
    import copy
    E, _ = dmrg.TwoSiteDMRGEngine(psi, m, copy.deepcopy(
        INTEGRATION_OPTIONS)).run()
    flat.update(state_flat('integration.psi', psi))
    flat['integration.E'] = np.asarray(float(E))
    print(f"integration: E {float(E):.14f} ({time.time() - t0:.1f} s)",
          flush=True)
    flat['cases'] = np.array(json.dumps(HOST_DMRG_CASES))
    flat['single_site_seed'] = np.array(json.dumps(SINGLE_SITE_SEED))
    flat['integration'] = np.array(json.dumps([INTEGRATION_MODEL,
                                               INTEGRATION_OPTIONS]))
    return flat


# the ramp's write-back drift: one device_ramp that grows chi 16x within
# the ramp (8 -> 128; 128x from the product state) on the infinite Hubbard
# chain (L=2, half filling), small enough for tenpy_tpu on the CPU.  The
# drift is max(norm_test) of the written-back state before the re-gauge
# (the unit-cell seam), its ratio to the last sweep's largest truncation
# error per update is what the two packages are compared by
DRIFT_CASE = ({'L': 2, 'bc_MPS': 'infinite', 't': 1., 'U': 4., 'mu': 0.},
              ['up', 'down'],
              {'chi_list': [[8, 2], [16, 2], [32, 2], [64, 2], [128, 4]],
               'svd_min': 1e-12, 'lanczos_K': 10, 'lanczos_K_seam': 60,
               'multiple': 16, 'backend': 'svd'})


def ramp_drift(package):
    """``device_ramp`` of :data:`DRIFT_CASE` in ``package`` ('jax' or
    'torch', the port on the CPU): the drift before the re-gauge, the last
    sweep's largest truncation error, their ratio, the sweep energies and
    the written-back state's norm_test, chi and TM energy."""
    import importlib
    prefix = 'tenpy_tpu' if package == 'jax' else 'tenpy_tpu_torch'
    hub = importlib.import_module(prefix + '.models.hubbard')
    mpsmod = importlib.import_module(prefix + '.networks.mps')
    pd = importlib.import_module(prefix + '.algorithms.packed_dmrg')
    params, init, options = DRIFT_CASE
    m = hub.FermiHubbardChain(dict(params))
    psi = mpsmod.MPS.from_product_state(m.lat.mps_sites(), init,
                                        bc='infinite')
    kw = {'device': 'cpu'} if package == 'torch' else {}
    t0 = time.time()
    with CanonicalFormProbe(mpsmod) as probe:
        eng = pd.device_ramp(psi, m, dict(options), **kw)
    seconds = time.time() - t0
    st = eng.sweep_stats
    drift = probe.before[-1] if probe.before else 0.
    last_err = float(st['max_err'][-1])
    return {'drift': drift, 'last_max_err': last_err,
            'ratio': drift / last_err, 'sweep_E': np.asarray(st['E']),
            'sweep_max_err': np.asarray(st['max_err']),
            'norm_test_after': float(np.max(psi.norm_test())),
            'chi': np.asarray(psi.chi),
            'tm_E': float(np.real(m.H_MPO.expectation_value(psi))),
            'seconds': seconds}


def ramp_drift_reference():
    """:func:`ramp_drift` in both packages, under ``jax.*`` and
    ``torch.*``, with the case."""
    flat = {'case': np.array(json.dumps(DRIFT_CASE))}
    for package in ('jax', 'torch'):
        out = ramp_drift(package)
        flat.update({f'{package}.{k}': np.asarray(v) for k, v in out.items()})
        print(f"{package}: drift {out['drift']:.3e}, last max_err "
              f"{out['last_max_err']:.3e}, ratio {out['ratio']:.3f}, chi "
              f"{list(out['chi'])}, TM energy {out['tm_E']!r}, norm_test "
              f"after {out['norm_test_after']:.1e} ({out['seconds']:.0f} s)",
              flush=True)
    return flat


# ------------------------------------------------------------- simulations
# the ground-state configs of tests/test_simulation.py (XXZ L=8), and the
# repo's two DMRG YAML files cut small (L=8; chi 8, and chi 4, 8, 16 in
# the sequential stages); logging goes nowhere (no handler, no .log file)
SIM_GS_PARAMS = {
    'model_class': 'XXZChain',
    'model_params': {'L': 8, 'Jxx': 1., 'Jz': 1., 'bc_MPS': 'finite'},
    'initial_state_params': {'method': 'lat_product_state',
                             'product_state': [['up'], ['down']]},
    'algorithm_class': 'TwoSiteDMRGEngine',
    'algorithm_params': {'trunc_params': {'chi_max': 32, 'svd_min': 1e-12},
                         'max_E_err': 1e-10, 'mixer': False},
}
SIM_LOG = {'to_stdout': None, 'to_file': None}
SIM_YAML = {
    'minimal': ('examples/yaml/minimal_DMRG.yml',
                ['model_params.L=8',
                 'algorithm_params.trunc_params.chi_max=8']),
    'sequential': ('examples/yaml/sequential_chi_ramp.yml',
                   ['model_params.L=8',
                    'algorithm_params.trunc_params.chi_max=[4, 8, 16]']),
}


def _sim_api(package):
    """``(simulation module, console_main, io module, kwargs of the
    simulation functions)`` of ``package``."""
    if package == 'jax':
        import tenpy_tpu
        from tenpy_tpu.simulations import simulation
        from tenpy_tpu.tools import io
        return simulation, tenpy_tpu.console_main, io, {}
    import tenpy_tpu_torch
    from tenpy_tpu_torch.simulations import simulation
    from tenpy_tpu_torch.tools import io
    return simulation, tenpy_tpu_torch.console_main, io, {'device': 'cpu'}


def _sim_result(prefix, res):
    """The energy, final MPO energy and final max_chi of one result."""
    meas = res['measurements']
    return {f'{prefix}.energy': np.asarray(float(np.real(res['energy']))),
            f'{prefix}.energy_MPO': np.asarray(
                float(np.real(meas['energy_MPO'][-1]))),
            f'{prefix}.max_chi': np.asarray(int(meas['max_chi'][-1]))}


def simulation_case(package, case, tmpdir):
    """One simulation case in ``package`` ('jax' or 'torch'), its output
    under ``tmpdir``; a flat dict of the energies and max_chi of every
    stage (``<case>.<stage>.*``)."""
    import copy
    sim, console_main, io, kw = _sim_api(package)
    params = copy.deepcopy(SIM_GS_PARAMS)
    params['log_params'] = dict(SIM_LOG)
    out = {}
    if case == 'gs':
        params['output_filename'] = os.path.join(tmpdir, 'gs.pkl')
        out.update(_sim_result('gs.0', sim.run_simulation(
            simulation_class='GroundStateSearch', **params, **kw)))
    elif case == 'checkpoint':
        fn = os.path.join(tmpdir, 'ckpt.pkl')
        params['output_filename'] = fn
        params['algorithm_params'].update(max_sweeps=2, min_sweeps=2,
                                          max_E_err=1e-16)
        out.update(_sim_result('checkpoint.0', sim.run_simulation(
            simulation_class='GroundStateSearch', **params, **kw)))
        out.update(_sim_result('checkpoint.1', sim.resume_from_checkpoint(
            filename=fn, update_sim_params={
                'algorithm_params.max_sweeps': 20,
                'algorithm_params.max_E_err': 1e-10}, **kw)))
    elif case == 'seq':
        params['algorithm_params']['max_sweeps'] = 10
        for k, res in enumerate(sim.run_seq_simulations(
                {'recursive_keys': ['model_params.Jz'],
                 'value_lists': [[0.5, 1.0]]},
                simulation_class='GroundStateSearch', **params, **kw)):
            out.update(_sim_result(f'seq.{k}', res))
    elif case == 'cli':
        import yaml
        fn_yaml = os.path.join(tmpdir, 'params.yml')
        params['simulation_class'] = 'GroundStateSearch'
        params['output_filename'] = os.path.join(tmpdir, 'cli.pkl')
        params.update(kw)
        with open(fn_yaml, 'w') as f:
            yaml.safe_dump(params, f)
        assert console_main([fn_yaml, '-o',
                             'algorithm_params.trunc_params.chi_max=16']) == 0
        out.update(_sim_result('cli.0', io.load(params['output_filename'])))
    else:
        fn_yaml, overrides = SIM_YAML[case]
        argv = [os.path.join(_ROOT, fn_yaml)]
        for o in overrides + [f'log_params={SIM_LOG!r}']:
            argv += ['-o', o]
        if package == 'torch':
            argv += ['-o', 'device=cpu']
        if case == 'minimal':
            fn = os.path.join(tmpdir, 'minimal.pkl')
            argv += ['-o', f'output_filename={fn}']
            assert console_main(argv) == 0
            out.update(_sim_result('minimal.0', io.load(fn)))
        else:
            prefix = os.path.join(tmpdir, 'results_sequential')
            argv += ['-o', f'output_filename_params.prefix={prefix}']
            assert console_main(argv) == 0
            for k, chi in enumerate([4, 8, 16]):
                out.update(_sim_result(f'sequential.{k}', io.load(
                    f'{prefix}_chi_{chi:04d}.pkl')))
    return out


# the entry points a simulation reaches besides its run: the memory
# estimate (by estimate_simulation_RAM and by console_main --RAM) of the
# XXZ chain's simulation from a state of bond dimension 16; switch_engine
# from the two-site engine (one sweep at chi 8) to the single-site one
# (two sweeps with the subspace-expansion mixer, which grows the bonds to
# 16); and the dense H of an XXZ chain L=6 in a field
ENTRY_CASES = ('ram', 'switch_engine', 'numpy_H')
ENTRY_RAM_STATE = {'method': 'desired_bond_dimension', 'chi': 16,
                   'product_state': [['up'], ['down']]}
ENTRY_SWITCH = ({'trunc_params': {'chi_max': 8, 'svd_min': 1e-12},
                 'max_sweeps': 1, 'min_sweeps': 1, 'mixer': False},
                {'trunc_params': {'chi_max': 16, 'svd_min': 1e-12},
                 'max_sweeps': 2, 'min_sweeps': 2, 'mixer': True})
ENTRY_NUMPY_H = {'L': 6, 'Jxx': 1., 'Jz': 1.3, 'hz': 0.1, 'bc_MPS': 'finite'}


def entry_point_case(package, case, tmpdir):
    """One of :data:`ENTRY_CASES` in ``package`` ('jax' or 'torch'); a
    flat dict of its values (``<case>.*``)."""
    import contextlib
    import copy
    import io as _io
    sim, console_main, _, kw = _sim_api(package)
    if package == 'jax':
        from tenpy_tpu.algorithms import dmrg, exact_diag
        from tenpy_tpu.models.xxz_chain import XXZChain
        from tenpy_tpu.networks.mps import MPS
    else:
        from tenpy_tpu_torch.algorithms import dmrg, exact_diag
        from tenpy_tpu_torch.models.xxz_chain import XXZChain
        from tenpy_tpu_torch.networks.mps import MPS
    if case == 'ram':
        import yaml
        params = copy.deepcopy(SIM_GS_PARAMS)
        params.update(log_params=dict(SIM_LOG),
                      initial_state_params=dict(ENTRY_RAM_STATE))
        ram = sim.estimate_simulation_RAM(
            simulation_class='GroundStateSearch', **params, **kw)
        fn_yaml = os.path.join(tmpdir, 'ram.yml')
        with open(fn_yaml, 'w') as f:
            yaml.safe_dump(dict(params, **kw), f)
        out = _io.StringIO()
        with contextlib.redirect_stdout(out):
            assert console_main([fn_yaml, '--RAM']) == 0
        line = out.getvalue().strip().splitlines()[-1]
        return {'ram.estimate': np.asarray(float(ram)),
                'ram.cli': np.array(line)}
    if case == 'switch_engine':
        model = XXZChain(dict(SIM_GS_PARAMS['model_params']))
        psi = MPS.from_lat_product_state(model.lat, [['up'], ['down']])
        eng = dmrg.TwoSiteDMRGEngine(psi, model,
                                     copy.deepcopy(ENTRY_SWITCH[0]), **kw)
        E0, _ = eng.run()
        eng1 = eng.switch_engine(dmrg.SingleSiteDMRGEngine,
                                 options=copy.deepcopy(ENTRY_SWITCH[1]))
        assert isinstance(eng1, dmrg.SingleSiteDMRGEngine) and \
            eng1.psi is psi
        E1, _ = eng1.run()
        return {'switch_engine.E0': np.asarray(float(np.real(E0))),
                'switch_engine.E1': np.asarray(float(np.real(E1))),
                'switch_engine.chi': np.asarray(max(psi.chi))}
    model = XXZChain(dict(ENTRY_NUMPY_H))
    H = np.asarray(exact_diag.get_numpy_Hamiltonian(model))
    H_sp = exact_diag.get_scipy_sparse_Hamiltonian(model)
    np.testing.assert_array_equal(H_sp.toarray(), H)
    return {'numpy_H.H': H}


def simulation_reference():
    """``tenpy_tpu``'s runs of every simulation case, and its
    ``ExactDiag`` ground energy of the XXZ L=8 chain in sector 0 (the
    ``gs`` case) and spectra of that chain and of the Ising chain L=8
    without charges (``ed.*``)."""
    import tempfile
    import warnings
    from tenpy_tpu.algorithms.exact_diag import ExactDiag
    from tenpy_tpu.models.xxz_chain import XXZChain
    from tenpy_tpu.models.tf_ising import TFIChain
    flat = {'gs_params': np.array(json.dumps(SIM_GS_PARAMS)),
            'yaml': np.array(json.dumps(SIM_YAML))}
    warnings.simplefilter('ignore')
    for case in ('gs', 'checkpoint', 'seq', 'cli', 'minimal', 'sequential'):
        t0 = time.time()
        with tempfile.TemporaryDirectory() as tmpdir:
            res = simulation_case('jax', case, tmpdir)
        flat.update(res)
        print(f"{case}: {time.time() - t0:.1f} s; " + ', '.join(
            f"{k} {float(v)!r}" for k, v in res.items()), flush=True)
    for name, model, sector in ED_CASES:
        ed = ExactDiag(XXZChain(dict(model)) if name == 'xxz'
                       else TFIChain(dict(model)), charge_sector=sector)
        ed.full_diagonalization()
        flat[f'ed.{name}.E'] = np.sort(np.asarray(ed.E))
    with tempfile.TemporaryDirectory() as tmpdir:
        for case in ENTRY_CASES:
            flat.update(entry_point_case('jax', case, tmpdir))
        # a results file as JAX writes it (its default format, pickle), to
        # hold the port's refusal of such pickles to
        simulation_case('jax', 'gs', tmpdir)
        with open(os.path.join(tmpdir, 'gs.pkl'), 'rb') as f:
            flat['jax_results_pkl'] = np.frombuffer(f.read(), np.uint8)
    return flat


# exact diagonalization: (name, model params, charge sector)
ED_CASES = (('xxz', {'L': 8, 'Jxx': 1., 'Jz': 1., 'bc_MPS': 'finite'}, [0]),
            ('tfi', {'L': 8, 'J': 1., 'g': 0.7, 'bc_MPS': 'finite',
                     'conserve': None}, None))


# ============================================================ time evolution
# tests/test_torch_tdvp.py, test_torch_tebd_host.py, test_torch_mpo_evolution
# .py and test_torch_time_evolution.py run the port on these cases and hold
# it to tenpy_tpu's runs of the same cases in
# tests/benchmark_data/time_evolution_reference.npz (--write-time-evolution).
# Each case runs in either package through te_case(package, case, ...);
# states are compared as dense vectors (ExactDiag.mps_to_full: the same
# basis in both packages) or by overlap, never tensor by tensor, except
# where both packages start from the same stored state ('krylov').
TE_DT = 0.05
TE_TRUNC = {'chi_max': 64, 'svd_min': 1e-14}
TE_KRYLOV = {'N_max': 20, 'P_tol': 1e-14}
TE_KRYLOV_DELTAS = (-0.5j * TE_DT, -0.5j)
TE_XXZ = {'L': 6, 'Jxx': 1., 'Jz': 0.8}
TE_TFI = {'L': 8, 'J': 1., 'g': 1.2, 'bc_MPS': 'finite', 'conserve': None}
TE_APPLY_TRUNC = {'chi_max': 12, 'svd_min': 1e-12}
TE_APPLY_METHODS = ('SVD', 'zip_up', 'variational')
TE_SPEC_TFI = {'L': 6, 'J': 1., 'g': 1.2, 'bc_MPS': 'finite',
               'conserve': None}
TE_YAMLS = ('TDVP', 'TEBD', 'ExpMPOEvolution')
TE_CASES = ('tdvp_two', 'tdvp_one', 'krylov', 'tebd_imag', 'tebd_real_1',
            'tebd_real_2', 'tebd_real_4', 'itebd', 'tebd_qr',
            'random_unitary', 'make_U', 'expmpo_I_1', 'expmpo_II_1',
            'expmpo_II_2', 'qr_variational', 'apply', 'yaml_TDVP',
            'yaml_TEBD', 'yaml_ExpMPOEvolution', 'yaml_Spectral', 'tdc',
            'spectral', 'braket')


class _TE:
    """The modules of one package that the time-evolution cases use."""

    def __init__(self, package):
        self.package = package
        if package == 'jax':
            import tenpy_tpu as pkg
            from tenpy_tpu.algorithms import tdvp, tebd, mpo_evolution, \
                mps_common, exact_diag, dmrg
            from tenpy_tpu.linalg import krylov_based
            from tenpy_tpu.models import xxz_chain, tf_ising, spins
            from tenpy_tpu.networks import mpo, mps, site, terms
            from tenpy_tpu.simulations import simulation
            from tenpy_tpu.tools import io, spectral_function_tools
            self.kw = {}
        else:
            import tenpy_tpu_torch as pkg
            from tenpy_tpu_torch.algorithms import tdvp, tebd, \
                mpo_evolution, mps_common, exact_diag, dmrg
            from tenpy_tpu_torch.linalg import krylov_based
            from tenpy_tpu_torch.models import xxz_chain, tf_ising, spins
            from tenpy_tpu_torch.networks import mpo, mps, site, terms
            from tenpy_tpu_torch.simulations import simulation
            from tenpy_tpu_torch.tools import io, spectral_function_tools
            self.kw = {'device': 'cpu'}
        self.pkg, self.tdvp, self.tebd = pkg, tdvp, tebd
        self.mpo_evolution, self.mps_common = mpo_evolution, mps_common
        self.exact_diag, self.dmrg, self.krylov = exact_diag, dmrg, \
            krylov_based
        self.XXZChain, self.TFIChain = xxz_chain.XXZChain, tf_ising.TFIChain
        self.SpinChain = spins.SpinChain
        self.mpo, self.mps, self.site, self.terms = mpo, mps, site, terms
        self.simulation, self.io = simulation, io
        self.sft = spectral_function_tools

    def ed(self, H):
        ed = self.exact_diag.ExactDiag.from_H_mpo(H)
        ed.full_diagonalization()
        return ed

    def vec(self, ed, psi):
        return np.asarray(ed.mps_to_full(psi))


class BondModel:
    """The model stub of tests/test_tebd.py: ``H_bond``, ``H_MPO`` and a
    lattice stub."""

    def __init__(self, sites, H_bond, H_MPO, bc):
        self.H_bond = H_bond
        self.H_MPO = H_MPO
        self.lat = FakeModel(sites, H_MPO).lat
        self.lat.bc_MPS = bc


def bond_model(te, kind, L, bc='finite', g=1.5):
    """tests/test_tebd.py's ``xxz_bond_model`` (Jz=1, Sz) or
    ``tfi_bond_model`` (J=1, field ``g``, parity) in ``te``'s package."""
    site, terms, mpo = te.site, te.terms, te.mpo
    n_b = L - 1 if bc == 'finite' else L
    if kind == 'xxz':
        sites = [site.SpinHalfSite('Sz')] * L
        ct = terms.CouplingTerms(L)
        for i in range(n_b):
            ct.add_coupling_term(0.5, i, i + 1, 'Sp', 'Sm')
            ct.add_coupling_term(0.5, i, i + 1, 'Sm', 'Sp')
            ct.add_coupling_term(1., i, i + 1, 'Sz', 'Sz')
        H_bond = ct.to_nn_bond_Arrays(sites)
        H = mpo.MPOGraph.from_terms([ct], sites, bc).build_MPO()
    else:
        sites = [site.SpinHalfSite('parity')] * L
        ot, ct = terms.OnsiteTerms(L), terms.CouplingTerms(L)
        for i in range(L):
            ot.add_onsite_term(-g, i, 'Sigmaz')
        for i in range(n_b):
            ct.add_coupling_term(-1., i, i + 1, 'Sigmax', 'Sigmax')
        H_bond = ot.add_to_nn_bond_Arrays(ct.to_nn_bond_Arrays(sites), sites,
                                          bc == 'finite')
        H = mpo.MPOGraph.from_terms([ot, ct], sites, bc).build_MPO()
    return BondModel(sites, H_bond, H, bc)


def _neel(te, model):
    L = len(model.lat.mps_sites())
    return te.mps.MPS.from_product_state(model.lat.mps_sites(),
                                         ['up', 'down'] * (L // 2))


def _from_vec(te, model, vec):
    """The MPS of a dense vector (ExactDiag.full_to_mps)."""
    ed = te.exact_diag.ExactDiag(model)
    return ed.full_to_mps(np.asarray(vec))


def _tfi_vec(te, params, out, inputs, key):
    """The DMRG ground state of the Ising chain ``params`` as a dense
    vector: run by tenpy_tpu (stored under ``key``), read by the port."""
    m = te.TFIChain(dict(params))
    if inputs is None:
        L = params['L']
        psi = te.mps.MPS.from_product_state(m.lat.mps_sites(), ['up'] * L)
        info = te.dmrg.run(psi, m, {'trunc_params': {'chi_max': 32,
                                                     'svd_min': 1e-12},
                                    'max_sweeps': 20}, **te.kw)
        ed = te.exact_diag.ExactDiag(m)
        vec = np.asarray(ed.mps_to_full(psi))
        vec = vec / np.linalg.norm(vec)
        out[key] = vec
        out[key + '_E'] = np.asarray(float(np.real(info['E'])))
    else:
        vec = inputs[key]
    return m, vec, float(inputs[key + '_E'] if inputs is not None
                         else out[key + '_E'])


def te_case(package, case, tmpdir, inputs=None):
    """One of :data:`TE_CASES` in ``package`` ('jax' or 'torch'); a flat
    dict of its values under ``<case>.``.  ``inputs``: tenpy_tpu's flat
    reference (for the port: the start states tenpy_tpu made)."""
    import warnings
    warnings.simplefilter('ignore')
    te = _TE(package)
    out = {}
    sub = None if inputs is None else \
        {k[len(case) + 1:]: v for k, v in inputs.items()
         if k.startswith(case + '.')}
    if case in ('tdvp_two', 'tdvp_one', 'krylov'):
        model, _ = heisenberg_model(package, 6)
        ed = te.ed(model.H_MPO)
        psi = _neel(te, model)
        v0 = te.vec(ed, psi)
        opts = {'dt': TE_DT, 'trunc_params': dict(TE_TRUNC)}
        if case == 'tdvp_one':
            te.tdvp.TwoSiteTDVPEngine(psi, model, dict(opts, N_steps=2),
                                      **te.kw).run()
            v0 = te.vec(ed, psi)
            te.tdvp.SingleSiteTDVPEngine(psi, model, {'dt': TE_DT,
                                                      'N_steps': 6},
                                         **te.kw).run()
        elif case == 'tdvp_two' or sub is None:
            te.tdvp.TwoSiteTDVPEngine(psi, model, dict(opts, N_steps=8),
                                      **te.kw).run()
        if case != 'krylov':
            out['v0'], out['v'] = v0, te.vec(ed, psi)
            out['E'] = np.asarray(float(np.real(
                te.mpo.MPOEnvironment(psi, model.H_MPO,
                                      psi).full_contraction(0))))
            return {f'{case}.{k}': v for k, v in out.items()}
        # the two- and one-site effective H of the evolved (complex) state
        if sub is None:
            out.update(state_flat('psi', psi))
        else:
            psi = load_state(sub, 'psi', model.lat.mps_sites())
        env = te.mpo.MPOEnvironment(psi, model.H_MPO, psi)
        for n, Hcls in ((2, te.mps_common.TwoSiteH),
                        (1, te.mps_common.OneSiteH)):
            H = Hcls(env, 2)
            theta = psi.get_theta(2, n)
            out[f'theta{n}'] = np.asarray(theta.to_ndarray())
            for k, delta in enumerate(TE_KRYLOV_DELTAS):
                res, N = te.krylov.LanczosEvolution(
                    H, theta, dict(TE_KRYLOV)).run(delta, normalize=True)
                out[f'evolved{n}.{k}'] = np.asarray(
                    res.copy(deep=False).itranspose(
                        theta.get_leg_labels()).to_ndarray())
                out[f'N{n}.{k}'] = np.asarray(N)
        return {f'{case}.{k}': v for k, v in out.items()}
    if case.startswith('tebd') or case in ('itebd', 'random_unitary'):
        trunc = {'chi_max': 64, 'svd_min': 1e-14}
        if case in ('tebd_imag', 'itebd'):
            bc = 'infinite' if case == 'itebd' else 'finite'
            L = 2 if bc == 'infinite' else 8
            model = bond_model(te, 'tfi', L, bc)
            psi = te.mps.MPS.from_product_state(model.lat.mps_sites(),
                                                ['up'] * L, bc=bc)
            eng = te.tebd.TEBDEngine(psi, model, {
                'trunc_params': {'chi_max': 32 if L == 8 else 24,
                                 'svd_min': 1e-13 if L == 8 else 1e-14},
                'delta_tau_list': [0.1, 0.01, 0.001, 1e-4],
                'N_steps': 20 if L == 8 else 30, 'max_error_E': 1e-10})
            eng.run_GS()
            out['E_bonds'] = np.asarray(eng.bond_energies())
            if bc == 'finite':
                out['E'] = np.asarray(float(np.real(te.mpo.MPOEnvironment(
                    psi, model.H_MPO, psi).full_contraction(0))))
                out['v'] = te.vec(te.ed(model.H_MPO), psi)
            return {f'{case}.{k}': v for k, v in out.items()}
        model = bond_model(te, 'xxz', 6)
        ed = te.ed(model.H_MPO)
        psi = _neel(te, model)
        out['v0'] = te.vec(ed, psi)
        if case == 'random_unitary':
            te.tebd.RandomUnitaryEvolution(psi, {
                'N_steps': 3, 'seed': 5,
                'trunc_params': {'chi_max': 8, 'svd_min': 1e-14}}).run()
            out['chi'] = np.asarray(psi.chi)
        elif case == 'tebd_qr':
            te.tebd.QRBasedTEBDEngine(psi, model, {
                'trunc_params': trunc, 'order': 2, 'dt': TE_DT,
                'N_steps': 4}).run()
        else:
            te.tebd.TEBDEngine(psi, model, {
                'trunc_params': trunc, 'order': int(case[-1]), 'dt': TE_DT,
                'N_steps': 8, 'preserve_norm': True}).run()
        out['v'] = te.vec(ed, psi)
        return {f'{case}.{k}': v for k, v in out.items()}
    if case == 'make_U' or case.startswith('expmpo'):
        m = te.XXZChain({'L': TE_XXZ['L'], 'Jxx': TE_XXZ['Jxx'],
                         'Jz': TE_XXZ['Jz']})
        if case == 'make_U':
            H = m.H_MPO
            for name, U in (('I', H.make_U_I(1j * TE_DT)),
                            ('II', H.make_U_II(1j * TE_DT)),
                            ('II_imag', H.make_U_II(TE_DT))):
                for i in range(H.L):
                    out[f'{name}.{i}'] = np.asarray(
                        U.get_W(i).to_ndarray())
            return {f'{case}.{k}': v for k, v in out.items()}
        ed = te.exact_diag.ExactDiag(m)
        ed.full_diagonalization()
        psi = te.mps.MPS.from_product_state(m.lat.mps_sites(),
                                            ['up', 'down'] * 3)
        out['v0'] = te.vec(ed, psi)
        approx, order = case.split('_')[1], int(case.split('_')[2])
        te.mpo_evolution.ExpMPOEvolution(psi, m, {
            'dt': TE_DT, 'N_steps': 6, 'approximation': approx,
            'order': order, 'compression_method': 'zip_up',
            'trunc_params': {'chi_max': 64, 'svd_min': 1e-13}}).run()
        out['v'] = te.vec(ed, psi)
        return {f'{case}.{k}': v for k, v in out.items()}
    if case in ('qr_variational', 'apply'):
        m, vec, _ = _tfi_vec(te, TE_TFI, out, sub, 'psi_vec')
        ed = te.exact_diag.ExactDiag(m)
        psi = _from_vec(te, m, vec)
        if case == 'qr_variational':
            U = m.H_MPO.make_U_II(-0.05)
            a, b = psi.copy(), psi.copy()
            opts = {'trunc_params': {'chi_max': 24, 'svd_min': 1e-12},
                    'N_sweeps': 2}
            te.mps_common.VariationalApplyMPO(a, U, dict(opts)).run()
            te.mps_common.QRBasedVariationalApplyMPO(b, U, dict(opts)).run()
            out['a'], out['b'] = te.vec(ed, a), te.vec(ed, b)
            out['Ea'] = np.asarray(float(np.real(
                m.H_MPO.expectation_value(a))))
            out['Eb'] = np.asarray(float(np.real(
                m.H_MPO.expectation_value(b))))
        else:
            U = m.H_MPO.make_U_II(1j * 0.1)
            for meth in TE_APPLY_METHODS:
                p = psi.copy()
                err = U.apply(p, {'compression_method': meth,
                                  'trunc_params': dict(TE_APPLY_TRUNC)})
                out[f'{meth}.v'] = te.vec(ed, p)
                out[f'{meth}.eps'] = np.asarray(float(err.eps))
            out['variance'] = np.asarray(float(m.H_MPO.variance(psi)))
        return {f'{case}.{k}': v for k, v in out.items()}
    if case.startswith('yaml_'):
        return _te_yaml(te, case, tmpdir, sub)
    return _te_correlation(te, case, sub)


def _te_yaml(te, case, tmpdir, sub):
    """A time-evolution YAML file at L=8 through the command line."""
    out = {}
    name = case[len('yaml_'):]
    argv_extra = ['-o', f'log_params={SIM_LOG!r}']
    if te.package == 'torch':
        argv_extra += ['-o', 'device=cpu']
    fn = os.path.join(tmpdir, f'{name}.pkl')
    if name == 'TEBD' and te.package == 'jax':
        # tenpy_tpu's psi_method does not read TeNPy's 'wrap' form of the
        # file's correlation measurement: let it fail there and go on
        argv_extra += ['-o', 'max_errors_before_abort=None']
    if name != 'Spectral':
        argv = [os.path.join(_ROOT, 'examples', 'yaml', f'minimal_{name}.yml'),
                '-o', 'model_params.L=8', '-o', f'output_filename={fn}']
        assert te.pkg.console_main(argv + argv_extra) == 0
        res = te.io.load(fn)
        meas = res['measurements']
        psi = res['psi']
        m = te.SpinChain({'L': 8, 'bc_MPS': 'finite', 'Jz': 1.})
        ed = te.exact_diag.ExactDiag(m)
        out['v'] = np.asarray(ed.mps_to_full(psi))
        out['Sz'] = np.asarray(meas['<Sz>'])
        out['time'] = np.asarray(meas['evolved_time'])
        out['max_chi'] = np.asarray(meas['max_chi'])
        if name == 'TEBD':
            # tenpy_tpu's value: the correlation of its final state
            out['SpSm'] = np.asarray(meas['<Sp_i Sm_j>'][-1]) \
                if te.package == 'torch' else \
                np.asarray(psi.correlation_function('Sp', 'Sm'))
        return {f'{case}.{k}': v for k, v in out.items()}
    m = te.SpinChain({'L': 8, 'bc_MPS': 'finite'})
    gs = os.path.join(tmpdir, 'gs.pkl')
    if sub is None:
        argv = [os.path.join(_ROOT, 'examples', 'yaml', 'minimal_DMRG.yml'),
                '-o', 'model_params.L=8', '-o', f'output_filename={gs}']
        assert te.pkg.console_main(argv + argv_extra) == 0
        data = te.io.load(gs)
        out.update(state_flat('gs', data['psi']))
        out['gs_E'] = np.asarray(float(np.real(data['energy'])))
        argv_extra += ['-o', 'model_class=SpinChain', '-o',
                       'model_params.L=8', '-o', 'model_params.bc_MPS=finite']
    else:
        psi = load_state(sub, 'gs', m.lat.mps_sites())
        te.io.save({'psi': psi, 'energy': float(sub['gs_E']),
                    'simulation_parameters': {
                        'model_class': 'SpinChain',
                        'model_params': {'L': 8, 'bc_MPS': 'finite'}}}, gs)
    argv = [os.path.join(_ROOT, 'examples', 'yaml',
                         'minimal_SpectralSimulation.yml'),
            '-o', f'ground_state_filename={gs}', '-o',
            f'output_filename={fn}']
    assert te.pkg.console_main(argv + argv_extra) == 0
    res = te.io.load(fn)
    C = np.asarray(res['measurements']['correlation_function_t_Sz_Sz'])
    out['C'] = C
    out['time'] = np.asarray(res['measurements']['evolved_time'])
    alg = te.io.load(fn)['simulation_parameters']['algorithm_params']
    if te.package == 'torch':
        S = res['post_processing']['spectral_function_Sz_Sz']
    else:
        # tenpy_tpu's spectral_function calls the option linear_prediction
        # (the file's linear_predict fails its post-processing)

        class _Lat1D:
            dim = 1
            Ls = (C.shape[1],)
        S = te.sft.spectral_function(C, _Lat1D(), alg['dt'] * alg['N_steps'],
                                     linear_prediction=True,
                                     gaussian_window=True)
    for k in ('spectral_function', 'k', 'w'):
        out[f'S.{k}'] = np.asarray(S[k])
    return {f'{case}.{k}': v for k, v in out.items()}


def _te_correlation(te, case, sub):
    """The three cases of tests/test_spectral_simulation.py on the Ising
    chain L=6 from its DMRG ground state."""
    out = {}
    m, vec, E0 = _tfi_vec(te, TE_SPEC_TFI, out, sub, 'gs_vec')
    psi = _from_vec(te, m, vec)
    common = dict(model_class='TFIChain', model_params=dict(TE_SPEC_TFI),
                  algorithm_class='TEBDEngine',
                  algorithm_params={'dt': 0.05, 'N_steps': 2,
                                    'order': 2 if case == 'spectral' else 4,
                                    'trunc_params': {'chi_max': 64,
                                                     'svd_min': 1e-12}},
                  final_time={'tdc': 0.5, 'spectral': 0.4,
                              'braket': 0.3}[case],
                  ground_state_data={'psi': psi, 'energy': E0},
                  save_psi=False, output_filename=None,
                  log_params=dict(SIM_LOG), **te.kw)
    if case == 'spectral':
        res = te.simulation.run_simulation(
            simulation_class='SpectralSimulation', operator_t='Sigmax',
            operator_t0={'opname': 'Sigmax', 'mps_idx': 3}, **common)
        S = res['post_processing']['spectral_function_Sigmax_Sigmax']
        for k in ('spectral_function', 'k', 'w'):
            out[f'S.{k}'] = np.asarray(S[k])
        out['C'] = np.asarray(res['measurements'][
            'correlation_function_t_Sigmax_Sigmax'])
    else:
        cls = 'TimeDependentCorrelation' if case == 'tdc' else \
            'TimeDependentCorrelationEvolveBraKet'
        res = te.simulation.run_simulation(
            simulation_class=cls, operator_t='Sigmaz',
            operator_t0={'opname': 'Sigmaz', 'mps_idx': 3}, **common)
        out['C'] = np.asarray(res['measurements'][
            'correlation_function_t_Sigmaz_Sigmaz'])
    out['time'] = np.asarray(res['measurements']['evolved_time'])
    return {f'{case}.{k}': v for k, v in out.items()}


def time_evolution_reference():
    """tenpy_tpu's runs of every case of :data:`TE_CASES`."""
    import tempfile
    flat = {}
    for case in TE_CASES:
        t0 = time.time()
        with tempfile.TemporaryDirectory() as tmpdir:
            res = te_case('jax', case, tmpdir)
        flat.update(res)
        print(f"{case}: {time.time() - t0:.1f} s, {len(res)} values",
              flush=True)
    return flat



# ------------------------------------------------------------------ VUMPS
# the cases of tests/test_vumps.py, an Sz-conserving XX chain, a complex
# Hofstadter cylinder, npc.polar and the environments of a bond matrix C
VUMPS_REF = os.path.join(_ROOT, 'tests', 'benchmark_data',
                         'vumps_reference.npz')
VUMPS_CASES = ('polar', 'roundtrip', 'single', 'two', 'single_L1',
               'mixer_L2_SE', 'mixer_L3_SE', 'mixer_L3_DMM', 'xx_sz',
               'hofstadter', 'envs', 'yaml')
# minimal_DMRG.yml as a VUMPS run: the infinite Heisenberg chain (L=2)
VUMPS_YAML = ['model_params.L=2', 'model_params.bc_MPS=infinite',
              'algorithm_class=TwoSiteVUMPSEngine',
              'algorithm_params.trunc_params.chi_max=16',
              'algorithm_params.trunc_params.svd_min=1.e-10',
              'algorithm_params.mixer=SubspaceExpansion',
              'algorithm_params.max_sweeps=12',
              'algorithm_params.check_overlap=False']
VUMPS_XX = {'L': 2, 'Jxx': 1., 'Jz': 0., 'hz': 0., 'bc_MPS': 'infinite',
            'conserve': 'Sz'}
VUMPS_HOF = {'lattice': 'Square', 'Lx': 1, 'Ly': 3, 'bc_y': 'cylinder',
             'bc_MPS': 'infinite', 'phi': (1, 3), 'gauge': 'landau_y',
             'conserve': 'N', 'mu': 0., 'v': 0.}


class _VU:
    """The modules of one package that the VUMPS cases use."""

    def __init__(self, package):
        if package == 'jax':
            from tenpy_tpu.algorithms import dmrg, vumps
            from tenpy_tpu.linalg import charges, np_conserved as npc
            from tenpy_tpu.models import tf_ising, xxz_chain, hofstadter
            from tenpy_tpu.networks import mpo, mps, uniform_mps, \
                mpo_env_builder
            self.kw = {}
        else:
            from tenpy_tpu_torch.algorithms import dmrg, vumps
            from tenpy_tpu_torch.linalg import charges, np_conserved as npc
            from tenpy_tpu_torch.models import tf_ising, xxz_chain, \
                hofstadter
            from tenpy_tpu_torch.networks import mpo, mps, uniform_mps, \
                mpo_env_builder
            self.kw = {'device': 'cpu'}
        self.dmrg, self.vumps, self.charges, self.npc = dmrg, vumps, \
            charges, npc
        self.tf_ising, self.xxz_chain, self.hofstadter = tf_ising, \
            xxz_chain, hofstadter
        self.mpo, self.mps, self.uniform_mps = mpo, mps, uniform_mps
        self.builder = mpo_env_builder.MPOEnvironmentBuilder


def vumps_polar_input(package):
    """A seeded charge-conserving 2-leg Array (U(1), real and complex
    blocks of 2x3, 3x3 and 3x2, all of full rank) in ``package``."""
    vu = _VU(package)
    chinfo = vu.charges.ChargeInfo([1], ['N'])
    q0 = np.array([[0], [0], [1], [1], [1], [2], [2], [2]])
    q1 = np.array([[0], [0], [0], [1], [1], [1], [2], [2]])
    leg0 = vu.charges.LegCharge.from_qflat(chinfo, q0, +1)
    leg1 = vu.charges.LegCharge.from_qflat(chinfo, q1, -1)
    rng = np.random.default_rng(7)
    mask = q0[:, 0][:, None] == q1[:, 0][None, :]
    re = rng.standard_normal(mask.shape) * mask
    cx = re + 1j * rng.standard_normal(mask.shape) * mask
    return [vu.npc.Array.from_ndarray(a, [leg0, leg1], labels=['a', 'b'])
            for a in (re, cx)]


def _vumps_run(vu, eng_cls, psi, m, opts):
    eng = getattr(vu.vumps, eng_cls)(psi, m, opts, **vu.kw)
    E, psi_out = eng.run()
    return eng, float(np.real(E)), psi_out


def vumps_case(package, case, inputs=None):
    """One of :data:`VUMPS_CASES` in ``package`` ('jax' or 'torch'); a
    flat dict of its values under ``<case>.``.  ``inputs``: tenpy_tpu's
    flat reference, whose start states the port reads (tenpy_tpu makes
    them)."""
    import warnings
    warnings.simplefilter('ignore')
    vu = _VU(package)
    out = {}

    def start(key, sites, make):
        """tenpy_tpu's start state ``key``: made here, or read."""
        if inputs is None:
            psi = make()
            out.update(state_flat(f'{case}.{key}', psi))
            return psi
        return load_state(inputs, f'{case}.{key}', sites)

    def result(eng, E, psi, m, op):
        out[f'{case}.E'] = np.asarray(E)
        out[f'{case}.S'] = np.asarray(psi.entanglement_entropy())
        out[f'{case}.op'] = np.asarray(psi.expectation_value(op))
        out[f'{case}.norm_err'] = np.asarray(np.max(psi.norm_test()))
        out[f'{case}.chi'] = np.asarray(psi.chi)
        out[f'{case}.sweeps'] = np.asarray(eng.sweeps)
        out.update(state_flat(f'{case}.psi', psi))

    def tfi(L, g):
        return vu.tf_ising.TFIChain({'L': L, 'J': 1., 'g': g,
                                     'bc_MPS': 'infinite', 'conserve': None})

    def dmrg_state(m, init, chi, sweeps):
        def make():
            psi = vu.mps.MPS.from_product_state(m.lat.mps_sites(), init,
                                                bc='infinite')
            vu.dmrg.run(psi, m, {'trunc_params': {'chi_max': chi,
                                                  'svd_min': 1e-10},
                                 'max_sweeps': sweeps, 'mixer': True},
                        **vu.kw)
            return psi
        return start('psi0', m.lat.mps_sites(), make)

    if case == 'polar':
        for name, a in zip(('real', 'complex'), vumps_polar_input(package)):
            for left in (False, True):
                W, P = vu.npc.polar(a, left=left)
                tag = f'{case}.{name}.{"left" if left else "right"}'
                out[tag + '.W'] = np.asarray(W.to_ndarray())
                out[tag + '.P'] = np.asarray(P.to_ndarray())
    elif case == 'roundtrip':
        m = tfi(2, 1.5)
        psi = dmrg_state(m, ['up', 'up'], 12, 10)
        u = vu.uniform_mps.UniformMPS.from_MPS(psi)
        out[f'{case}.validity'] = np.asarray(np.max(u.test_validity()))
        out[f'{case}.norm_err'] = np.asarray(np.linalg.norm(u.norm_test()))
        out[f'{case}.sz_mps'] = np.asarray(psi.expectation_value('Sigmaz'))
        out[f'{case}.sz_u'] = np.asarray(u.expectation_value('Sigmaz'))
        out[f'{case}.S_u'] = np.asarray(u.entanglement_entropy())
        psi2 = u.to_MPS(check_overlap=False)
        out[f'{case}.sz_back'] = np.asarray(psi2.expectation_value('Sigmaz'))
        out[f'{case}.S_back'] = np.asarray(psi2.entanglement_entropy())
    elif case == 'single':
        m = tfi(2, 1.5)
        psi = dmrg_state(m, ['up', 'up'], 12, 8)
        eng, E, psi = _vumps_run(vu, 'SingleSiteVUMPSEngine', psi, m, {
            'max_sweeps': 30, 'max_E_err': 1e-12, 'max_split_err': 1e-9,
            'check_overlap': False})
        result(eng, E, psi, m, 'Sigmaz')
    elif case == 'two':
        m = tfi(2, 1.2)
        psi = vu.mps.MPS.from_product_state(m.lat.mps_sites(), ['up', 'up'],
                                            bc='infinite')
        eng, E, psi = _vumps_run(vu, 'TwoSiteVUMPSEngine', psi, m, {
            'max_sweeps': 40, 'max_E_err': 1e-12, 'max_split_err': 1e-8,
            'check_overlap': False,
            'trunc_params': {'chi_max': 24, 'svd_min': 1e-10}})
        result(eng, E, psi, m, 'Sigmaz')
    elif case == 'single_L1':
        m = tfi(1, 1.5)
        psi = start('psi0', m.lat.mps_sites(),
                    lambda: vu.mps.MPS.from_desired_bond_dimension(
                        m.lat.mps_sites(), 16, bc='infinite', seed=5))
        eng, E, psi = _vumps_run(vu, 'SingleSiteVUMPSEngine', psi, m, {
            'max_sweeps': 60, 'max_E_err': 1e-12, 'max_split_err': 1e-8,
            'check_overlap': False})
        result(eng, E, psi, m, 'Sigmaz')
        out[f'{case}.E_bond'] = np.asarray(np.mean(
            psi.expectation_value(m.H_bond)))
        out[f'{case}.E_mpo'] = np.asarray(float(np.real(
            m.H_MPO.expectation_value(psi))))
    elif case.startswith('mixer_'):
        L = int(case[len('mixer_L')])
        mixer = 'SubspaceExpansion' if case.endswith('SE') \
            else 'DensityMatrixMixer'
        m = tfi(L, 1.2)
        psi = vu.mps.MPS.from_product_state(m.lat.mps_sites(), ['up'] * L,
                                            bc='infinite')
        eng, E, psi = _vumps_run(vu, 'TwoSiteVUMPSEngine', psi, m, {
            'max_sweeps': 50, 'min_sweeps': 10, 'max_E_err': 1e-12,
            'max_split_err': 1e-8, 'check_overlap': False, 'mixer': mixer,
            'mixer_params': {'amplitude': 1e-5, 'disable_after': 5},
            'chi_list': {0: 10, 5: 24}, 'trunc_params': {'svd_min': 1e-10}})
        result(eng, E, psi, m, 'Sigmaz')
        out[f'{case}.E_bond'] = np.asarray(np.mean(
            psi.expectation_value(m.H_bond)))
    elif case == 'xx_sz':
        m = vu.xxz_chain.XXZChain(dict(VUMPS_XX))
        psi = vu.mps.MPS.from_product_state(m.lat.mps_sites(),
                                            ['up', 'down'], bc='infinite')
        eng, E, psi = _vumps_run(vu, 'TwoSiteVUMPSEngine', psi, m, {
            'max_sweeps': 10, 'min_sweeps': 8, 'max_E_err': 1e-12,
            'max_split_err': 1e-8, 'check_overlap': False,
            'mixer': 'SubspaceExpansion',
            'mixer_params': {'amplitude': 1e-5, 'disable_after': 6},
            'chi_list': {0: 8, 3: 16, 6: 24},
            'trunc_params': {'svd_min': 1e-10}})
        result(eng, E, psi, m, 'Sz')
    elif case == 'hofstadter':
        m = vu.hofstadter.HofstadterFermions(dict(VUMPS_HOF))
        psi = vu.mps.MPS.from_product_state(m.lat.mps_sites(),
                                            ['full', 'empty', 'empty'],
                                            bc='infinite')
        eng, E, psi = _vumps_run(vu, 'TwoSiteVUMPSEngine', psi, m, {
            'max_sweeps': 6, 'min_sweeps': 6, 'max_E_err': 1e-12,
            'max_split_err': 1e-8, 'check_overlap': False,
            'mixer': 'SubspaceExpansion',
            'mixer_params': {'amplitude': 1e-5, 'disable_after': 4},
            'chi_list': {0: 8, 2: 16}, 'trunc_params': {'svd_min': 1e-10}})
        result(eng, E, psi, m, 'N')
        out[f'{case}.complex'] = np.asarray(psi.dtype.is_complex
                                            if package == 'torch' else
                                            np.iscomplexobj(np.zeros(
                                                (), psi.dtype)))
    elif case == 'envs':
        m = vu.xxz_chain.XXZChain(dict(VUMPS_XX))
        psi = dmrg_state(m, ['up', 'down'], 16, 10)
        u = vu.uniform_mps.UniformMPS.from_MPS(psi)
        for i in range(u.L):
            u.set_C(i, u.get_C(i))      # get_SL now returns the matrix C
        data, Es, E0 = vu.mpo.MPOTransferMatrix.find_init_LP_RP(
            m.H_MPO, u, calc_E=True, method='arnoldi')
        out[f'{case}.tm.LP'] = np.asarray(
            data['init_LP'].transpose(['vR*', 'wR', 'vR']).to_ndarray())
        out[f'{case}.tm.RP'] = np.asarray(
            data['init_RP'].transpose(['vL', 'wL', 'vL*']).to_ndarray())
        out[f'{case}.tm.Es'] = np.real(np.asarray(Es, complex))
        out[f'{case}.tm.E0'] = np.asarray(complex(E0))
        # the builder needs its forms stored: AL for LP, AR for RP
        for name, form, get in (('LP', 'A', u.get_AL), ('RP', 'B', u.get_AR)):
            Bs = [get(i, copy=True) for i in range(u.L)]
            SVs = [np.ones(B.get_leg('vL').ind_len) for B in Bs] + \
                [np.ones(Bs[0].get_leg('vL').ind_len)]
            psi_f = vu.mps.MPS(u.sites, Bs, SVs, bc='infinite', form=form)
            psi_f._S = [u.get_C(i) for i in range(u.L)] + [u.get_C(0)]
            env_data, Es_b, _ = vu.builder(m.H_MPO, psi_f) \
                .init_LP_RP_iterative(which=name, calc_E=True)
            labels = ['vR*', 'wR', 'vR'] if name == 'LP' else \
                ['vL', 'wL', 'vL*']
            out[f'{case}.builder.{name}'] = np.asarray(
                env_data['init_' + name].transpose(labels).to_ndarray())
            out[f'{case}.builder.E_{name}'] = np.asarray(float(np.real(
                Es_b[1 if name == 'LP' else 0])))
    elif case == 'yaml':
        import tempfile
        _, console_main, io, kw = _sim_api(package)
        argv = [os.path.join(_ROOT, 'examples', 'yaml', 'minimal_DMRG.yml')]
        with tempfile.TemporaryDirectory() as tmpdir:
            fn = os.path.join(tmpdir, 'vumps.pkl')
            for o in VUMPS_YAML + [f'log_params={SIM_LOG!r}',
                                   f'output_filename={fn}'] + \
                    [f'{k}={v}' for k, v in kw.items()]:
                argv += ['-o', o]
            assert console_main(argv) == 0
            res = io.load(fn)
        out.update(_sim_result(case, res))
        out[f'{case}.chi'] = np.asarray(res['psi'].chi)
    else:
        raise ValueError(case)
    return out


def vumps_reference():
    """tenpy_tpu's runs of every case of :data:`VUMPS_CASES`."""
    flat = {}
    for case in VUMPS_CASES:
        t0 = time.time()
        res = vumps_case('jax', case)
        flat.update(res)
        print(f"{case}: {time.time() - t0:.1f} s, {len(res)} values",
              flush=True)
    return flat


# ============================================================ purification
# tests/test_torch_purification.py runs the port on the cases of
# tests/test_purification.py (and PurificationApplyMPO and
# from_density_matrix, which it does not test) and holds it to tenpy_tpu's
# runs in tests/benchmark_data/purification_reference.npz
# (--write-purification): energies, expectation values, entropies, mutual
# information and overlaps, never tensors.
PU_REF = os.path.join(_ROOT, 'tests', 'benchmark_data',
                      'purification_reference.npz')
PU_TRUNC = {'chi_max': 64, 'svd_min': 1e-13}
PU_XXZ13 = {'L': 4, 'Jxx': 1., 'Jz': 1.3, 'hz': 0., 'bc_MPS': 'finite'}
PU_TFI = {'L': 4, 'J': 1., 'g': 1.2, 'bc_MPS': 'finite', 'conserve': None}
PU_CASES = ('infiniteT', 'thermal_0.5', 'thermal_2.0', 'tebd2', 'renyi',
            'graddesc', 'canonical', 'canonical_ancilla',
            'tebd_canonical_ancilla', 'segment', 'second_order', 'apply_mpo',
            'density_matrix')


class _PU(_TE):
    """The modules of one package that the purification cases use."""

    def __init__(self, package):
        super().__init__(package)
        if package == 'jax':
            from tenpy_tpu.algorithms import purification
            from tenpy_tpu.linalg import np_conserved as npc
            from tenpy_tpu.networks import purification_mps
            from tenpy_tpu.models.model import NearestNeighborModel
            self.nn = NearestNeighborModel.from_MPOModel
        else:
            from tenpy_tpu_torch.algorithms import purification
            from tenpy_tpu_torch.linalg import np_conserved as npc
            from tenpy_tpu_torch.networks import purification_mps
            self.nn = lambda m: m     # the port's chains have H_bond
        self.purification, self.pmps, self.npc = purification, \
            purification_mps, npc
        self.PMPS = purification_mps.PurificationMPS


def _pu_energy(eng, psi):
    return np.asarray(np.sum(eng.bond_energies())
                      / float(np.real(psi.overlap(psi))))


def _pu_run(pu, cls, psi, model, beta, **opts):
    eng = getattr(pu.purification, cls)(psi, model, dict(
        {'trunc_params': dict(PU_TRUNC), 'dt': 0.025, 'order': 2}, **opts),
        **pu.kw)
    eng.run_imaginary(beta)
    return eng


def _pu_corr(psi, i, j):
    return np.asarray(complex(psi.correlation_function(
        'Sz', 'Sz', sites1=[i], sites2=[j]).ravel()[0]))


def purification_case(package, case):
    """One of :data:`PU_CASES` in ``package`` ('jax' or 'torch'); a flat
    dict of its values under ``<case>.``."""
    import warnings
    warnings.simplefilter('ignore')
    pu = _PU(package)
    out = {}
    spin = pu.site.SpinHalfSite('Sz')
    if case == 'infiniteT':
        psi = pu.PMPS.from_infiniteT([spin] * 4)
        out['Sz'] = np.asarray(psi.expectation_value('Sz'))
        out['overlap'] = np.asarray(complex(psi.overlap(psi)))
        out['norm_test'] = np.asarray(psi.norm_test())
    elif case.startswith('thermal') or case == 'tebd2':
        beta = float(case.split('_')[1]) if '_' in case else 1.
        model = bond_model(pu, 'xxz', 4)
        psi = pu.PMPS.from_infiniteT(model.lat.mps_sites())
        eng = _pu_run(pu, 'PurificationTEBD2' if case == 'tebd2'
                      else 'PurificationTEBD', psi, model, beta, dt=0.025)
        out['E'] = _pu_energy(eng, psi)
        out['E_bonds'] = np.asarray(eng.bond_energies())
        out['S'] = np.asarray(psi.entanglement_entropy())
    elif case == 'renyi':
        model = bond_model(pu, 'tfi', 4, g=1.2)
        for tag, extra in (('plain', {}), ('dis', {'disentangle': 'renyi'})):
            psi = pu.PMPS.from_infiniteT(model.lat.mps_sites())
            eng = _pu_run(pu, 'PurificationTEBD', psi, model, 1.,
                          dt=0.05, **extra)
            out[f'E_{tag}'] = _pu_energy(eng, psi)
            out[f'S_{tag}'] = np.asarray(psi.entanglement_entropy())
    elif case == 'graddesc':
        m = pu.nn(pu.TFIChain(dict(PU_TFI)))
        for tag, extra in (('dis', {'disentangle': 'graddesc'}),
                           ('plain', {})):
            psi = pu.PMPS.from_infiniteT(m.lat.mps_sites())
            eng = _pu_run(pu, 'PurificationTEBD', psi, m, 0.5, dt=0.05,
                          **extra)
            out[f'E_{tag}'] = _pu_energy(eng, psi)
            out[f'S_{tag}'] = np.asarray(psi.entanglement_entropy())
    elif case == 'canonical':
        psi = pu.PMPS.from_infiniteT_canonical([spin] * 4, [0])
        out['Sz'] = np.asarray(psi.expectation_value('Sz'))
        for i, j in ((0, 1), (0, 3), (1, 2)):
            out[f'corr{i}{j}'] = _pu_corr(psi, i, j)
        psi2 = pu.PMPS.from_infiniteT_canonical([spin] * 4, [2])
        out['Sz2'] = np.asarray(psi2.expectation_value('Sz'))
    elif case == 'canonical_ancilla':
        psi1 = pu.PMPS.from_infiniteT_canonical([spin] * 4, [0])
        psi2 = pu.PMPS.from_infiniteT_canonical(
            [spin] * 4, [0], conserve_ancilla_charge=True)
        out['qnumber'] = np.asarray(psi2.sites[0].leg.chinfo.qnumber)
        out['names'] = np.asarray(list(psi2.sites[0].leg.chinfo.names))
        for tag, psi in (('1', psi1), ('2', psi2)):
            out['Sz' + tag] = np.asarray(psi.expectation_value('Sz'))
            out['S' + tag] = np.asarray(psi.entanglement_entropy())
            for i, j in ((0, 1), (0, 3)):
                out[f'corr{i}{j}_{tag}'] = _pu_corr(psi, i, j)
    elif case == 'tebd_canonical_ancilla':
        m = pu.nn(pu.XXZChain(dict(PU_XXZ13)))
        conv = pu.pmps.\
            convert_model_purification_canonical_conserve_ancilla_charge
        psi = pu.PMPS.from_infiniteT_canonical(
            m.lat.mps_sites(), [0], conserve_ancilla_charge=True)
        eng = _pu_run(pu, 'PurificationTEBD', psi, conv(m), 1.)
        out['E'] = _pu_energy(eng, psi)
        out['S'] = np.asarray(psi.entanglement_entropy())
        out['qnumber'] = np.asarray(psi.sites[0].leg.chinfo.qnumber)
    elif case == 'segment':
        psi = pu.PMPS.from_infiniteT([spin] * 4)
        for legs in ('p', 'q', 'pq'):
            out['S_' + legs] = np.asarray(psi.entanglement_entropy_segment(
                [0, 1], n=1, legs=legs))
        out['S_nc'] = np.asarray(psi.entanglement_entropy_segment(
            [0, 2], n=1, legs='p'))
        # a thermal state, where none of them is trivial
        model = bond_model(pu, 'xxz', 4)
        psi = pu.PMPS.from_infiniteT(model.lat.mps_sites())
        _pu_run(pu, 'PurificationTEBD', psi, model, 1.)
        for legs in ('p', 'q', 'pq'):
            out['Sb_' + legs] = np.asarray(psi.entanglement_entropy_segment(
                [0, 2], n=2 if legs == 'q' else 1, legs=legs))
            coords, mutinf = psi.mutinf_two_site(legs=legs)
            out['mutinf_' + legs] = np.asarray(mutinf)
            out['coords_' + legs] = np.asarray(coords)
    elif case == 'second_order':
        m = pu.nn(pu.XXZChain(dict(PU_XXZ13)))
        for k, dt in enumerate((0.05, 0.025)):
            psi = pu.PMPS.from_infiniteT_canonical(m.lat.mps_sites(), [0])
            eng = _pu_run(pu, 'PurificationTEBD', psi, m, 1., dt=dt)
            out[f'E{k}'] = _pu_energy(eng, psi)
    elif case == 'apply_mpo':
        # exp(-beta H / 2) as 10 applications of the MPO exp(-0.05 H)
        m = pu.XXZChain(dict(PU_XXZ13))
        psi = pu.PMPS.from_infiniteT(m.lat.mps_sites())
        U = m.H_MPO.make_U_II(0.05)
        for _ in range(10):
            pu.purification.PurificationApplyMPO(psi, U, {
                'trunc_params': dict(PU_TRUNC), 'N_sweeps': 2}).run()
        out['E'] = np.asarray(float(np.real(
            m.H_MPO.expectation_value(psi)))
            / float(np.real(psi.overlap(psi))))
        out['S'] = np.asarray(psi.entanglement_entropy())
    elif case == 'density_matrix':
        # exp(-H) / Z of the XXZ chain (L=3) in the product basis
        m = pu.XXZChain(dict(PU_XXZ13, L=3))
        sites = m.lat.mps_sites()
        sp, sm, sz = (np.asarray(sites[0].get_op(o).to_ndarray())
                      for o in ('Sp', 'Sm', 'Sz'))
        one = np.eye(2)
        H = np.zeros((8, 8))
        for a, b, c in ((sp, sm, 0.5), (sm, sp, 0.5), (sz, sz, 1.3)):
            H += c * (np.kron(np.kron(a, b), one) + np.kron(one,
                                                            np.kron(a, b)))
        w, v = np.linalg.eigh(H)
        rho = (v * np.exp(-w)) @ v.T.conj()
        rho /= np.trace(rho)
        out['E_exact'] = np.asarray(float(np.trace(rho @ H)))
        leg = sites[0].leg
        rho_npc = pu.npc.Array.from_ndarray(
            rho.reshape([2] * 6), [leg] * 3 + [leg.conj()] * 3,
            labels=['p0', 'p1', 'p2', 'p0*', 'p1*', 'p2*'])
        psi = pu.PMPS.from_density_matrix(sites, rho_npc)
        out['E'] = np.asarray(float(np.real(
            m.H_MPO.expectation_value(psi)))
            / float(np.real(psi.overlap(psi))))
        out['S'] = np.asarray(psi.entanglement_entropy())
    else:
        raise ValueError(case)
    return {f'{case}.{k}': v for k, v in out.items()}


def purification_reference():
    """tenpy_tpu's runs of every case of :data:`PU_CASES`."""
    flat = {}
    for case in PU_CASES:
        t0 = time.time()
        res = purification_case('jax', case)
        flat.update(res)
        print(f"{case}: {time.time() - t0:.1f} s, {len(res)} values",
              flush=True)
    return flat

# ============================================================ excitations
# tests/test_torch_excitations.py runs the port on the cases of
# tests/test_plane_wave_excitation.py and tests/test_excitation_simulations.py
# (and the sparse wrappers and direct-sum Krylov vectors on small operators)
# from the states tenpy_tpu made, and holds it to tenpy_tpu's runs in
# tests/benchmark_data/excitation_reference.npz (--write-excitations):
# energies, gaps and gauge-invariant checks, never tensors.  chip_smoke.py
# phase 14b holds the card to the charged-magnon case (the chi=24 uniform
# state of the S=1 chain).
EX_REF = os.path.join(_ROOT, 'tests', 'benchmark_data',
                      'excitation_reference.npz')
EX_CASES = ('construct_orthogonal', 'tfi', 'multi', 'haldane',
            'sim_orthogonal', 'sim_builder', 'sim_plane_wave', 'operators')
EX_G = 1.5
EX_MOMENTA = (0., np.pi / 2)
EX_TFI_INF = {'L': 2, 'J': 1., 'g': EX_G, 'bc_MPS': 'infinite',
              'conserve': None}
EX_SPIN1 = {'S': 1, 'L': 2, 'Jx': 1., 'Jy': 1., 'Jz': 1.,
            'bc_MPS': 'infinite', 'conserve': 'Sz'}
EX_VUMPS_TFI = {'max_sweeps': 30, 'max_E_err': 1e-13, 'max_split_err': 1e-9,
                'check_overlap': False}
EX_VUMPS_SPIN1 = {'max_sweeps': 40, 'max_E_err': 1e-12,
                  'max_split_err': 1e-7, 'check_overlap': False}
# the direct-sum Krylov runs: 8 steps in a space of 10 dimensions
EX_KRYLOV = {'N_max': 8, 'N_min': 8, 'P_tol': 0.}
EX_GMRES = {'N_max': 8, 'res': 1e-13}


class _EX(_VU):
    """The modules of one package that the excitation cases use."""

    def __init__(self, package):
        super().__init__(package)
        if package == 'jax':
            from tenpy_tpu.algorithms import plane_wave_excitation, exact_diag
            from tenpy_tpu.linalg import krylov_based, sparse
            from tenpy_tpu.models import spins
            from tenpy_tpu.simulations import ground_state_search
        else:
            from tenpy_tpu_torch.algorithms import plane_wave_excitation, \
                exact_diag
            from tenpy_tpu_torch.linalg import krylov_based, sparse
            from tenpy_tpu_torch.models import spins
            from tenpy_tpu_torch.simulations import ground_state_search
        self.pwe, self.exact_diag = plane_wave_excitation, exact_diag
        self.krylov, self.sparse = krylov_based, sparse
        self.SpinChain = spins.SpinChain
        self.spins = spins
        self.gss = ground_state_search

    def ed_spectrum(self, H):
        ed = self.exact_diag.ExactDiag.from_H_mpo(H)
        ed.build_full_H_from_mpo()
        return np.linalg.eigvalsh(np.asarray(ed.full_H.to_ndarray()))


def uniform_flat(prefix, u):
    """A UniformMPS of either package under ``prefix``
    (:func:`tenpy_tpu_torch.networks.exchange.uniform_to_flat`)."""
    return exchange.uniform_to_flat(prefix, u)


def load_uniform(flat, prefix, sites):
    """The state :func:`uniform_flat` stored under ``prefix`` as the
    port's UniformMPS on ``sites``."""
    return exchange.load_uniform(flat, prefix, sites)


def ex_operator_input(package):
    """Seeded small operators and vectors in ``package``: a U(1) leg of
    sectors 2, 5, 2; hermitian ``H1``, ``H2`` and a coupling ``C``
    (complex, charge-conserving), vectors ``v``, ``w``, ``o`` in the
    middle sector (``o`` normalized)."""
    ex = _EX(package)
    chinfo = ex.charges.ChargeInfo([1], ['N'])
    q = np.array([0, 0, 1, 1, 1, 1, 1, 2, 2])
    leg = ex.charges.LegCharge.from_qflat(chinfo, q.reshape(-1, 1), +1)
    mask = q[:, None] == q[None, :]
    rng = np.random.default_rng(11)
    n = len(q)

    def cplx(shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    def herm():
        a = cplx((n, n)) * mask
        return a + a.conj().T

    mats = {'H1': herm(), 'H2': herm(), 'C': cplx((n, n)) * mask}
    vecs = {k: cplx(n) * (q == 1) for k in ('v', 'w', 'o')}
    vecs['o'] = vecs['o'] / np.linalg.norm(vecs['o'])
    res = {k: ex.npc.Array.from_ndarray(a, [leg, leg.conj()],
                                        labels=['p', 'p*'])
           for k, a in mats.items()}
    res.update({k: ex.npc.Array.from_ndarray(a, [leg], qtotal=[1],
                                             labels=['p'])
                for k, a in vecs.items()})
    return res


def ex_operators(package, arrays):
    """``NpcLinearOperator`` s of ``package`` on the arrays of
    :func:`ex_operator_input`: ``op(M)`` applies a matrix, ``block`` the
    hermitian direct-sum operator ``[[H1, C], [C^dagger, H2]]`` on
    two-vector lists."""
    ex = _EX(package)
    npc = ex.npc

    class Mat(ex.sparse.NpcLinearOperator):
        def __init__(self, M):
            self.M = M

        def matvec(self, v):
            return npc.tensordot(self.M, v, axes=[['p*'], ['p']])

        def adjoint(self):
            return Mat(self.M.conj().itranspose(['p', 'p*']))

    Ch = arrays['C'].conj().itranspose(['p', 'p*'])

    class Block(ex.sparse.NpcLinearOperator):
        def matvec(self, v):
            a, b = v
            return [Mat(arrays['H1']).matvec(a) + Mat(arrays['C']).matvec(b),
                    Mat(Ch).matvec(a) + Mat(arrays['H2']).matvec(b)]

    return Mat, Block()


def _dense(v):
    if isinstance(v, list):
        return np.concatenate([_dense(x) for x in v])
    return np.asarray(v.to_ndarray())


def excitation_case(package, case, inputs=None):
    """One of :data:`EX_CASES` in ``package`` ('jax' or 'torch'); a flat
    dict of its values under ``<case>.``.  ``inputs``: tenpy_tpu's flat
    reference, whose start states the port reads (tenpy_tpu makes
    them)."""
    import warnings
    warnings.simplefilter('ignore')
    ex = _EX(package)
    out = {}
    kw = ex.kw

    def tfi(L=2, bc='infinite'):
        return ex.tf_ising.TFIChain({'L': L, 'J': 1., 'g': EX_G,
                                     'bc_MPS': bc, 'conserve': None})

    def dmrg_state(key, m, init, bc, opts):
        """tenpy_tpu's ground state ``key`` by dmrg.run: made here, or
        read; returns ``(psi, E)``."""
        if inputs is not None:
            return (load_state(inputs, f'{case}.{key}', m.lat.mps_sites()),
                    float(inputs[f'{case}.{key}_E']))
        psi = ex.mps.MPS.from_product_state(m.lat.mps_sites(), init, bc=bc)
        info = ex.dmrg.run(psi, m, opts, **kw)
        out.update(state_flat(f'{case}.{key}', psi))
        out[f'{case}.{key}_E'] = np.asarray(float(info['E']))
        return psi, float(info['E'])

    def uniform(key, m, make):
        """tenpy_tpu's uniform state ``key``: made here, or read."""
        if inputs is not None:
            return load_uniform(inputs, f'{case}.{key}', m.lat.mps_sites())
        u = make()
        out.update(uniform_flat(f'{case}.{key}', u))
        return u

    def vumps_state(m, init, chi, sweeps, vumps_opts):
        def make():
            psi = ex.mps.MPS.from_product_state(m.lat.mps_sites(), init,
                                                bc='infinite')
            ex.dmrg.run(psi, m, {'trunc_params': {'chi_max': chi,
                                                  'svd_min': 1e-10},
                                 'max_sweeps': sweeps, 'mixer': True}, **kw)
            eng = ex.vumps.SingleSiteVUMPSEngine(psi, m, dict(vumps_opts),
                                                 **kw)
            eng.run()
            return eng.psi
        return make

    if case == 'construct_orthogonal':
        m = tfi()
        psi, _ = dmrg_state('psi0', m, ['up', 'up'], 'infinite', {
            'trunc_params': {'chi_max': 8, 'svd_min': 1e-10},
            'max_sweeps': 8, 'mixer': True})
        AL = psi.get_B(0, 'A')
        VL = ex.pwe.construct_orthogonal(AL)
        ov = ex.npc.tensordot(VL.conj(), AL, axes=[['vL*', 'p*'],
                                                   ['vL', 'p']])
        idty = ex.npc.tensordot(VL.conj(), VL, axes=[['vL*', 'p*'],
                                                     ['vL', 'p']])
        out[f'{case}.ov'] = np.asarray(float(ex.npc.norm(ov)))
        out[f'{case}.idty'] = np.asarray(float(ex.npc.norm(
            idty - ex.npc.eye_like(idty, 0))))
        out[f'{case}.n_complement'] = np.asarray(VL.get_leg('vR').ind_len)
    elif case == 'tfi':
        m = tfi()
        u = uniform('u', m, vumps_state(m, ['up', 'up'], 12, 10,
                                        EX_VUMPS_TFI))
        pwe = ex.pwe.PlaneWaveExcitationEngine(
            u, m, {'lanczos_params': {'N_max': 40}}, **kw)
        for k, p in enumerate(EX_MOMENTA):
            Es, psis, N = pwe.run(p)
            out[f'{case}.E{k}'] = np.asarray(float(np.real(Es[0])))
            out[f'{case}.L{k}'] = np.asarray(psis[0].L)
        out[f'{case}.lambda_C1'] = np.asarray(pwe.lambda_C1)
        out[f'{case}.energy_density'] = np.asarray(pwe.energy_density)
    elif case == 'multi':
        m = tfi()

        def make():
            psi = ex.mps.MPS.from_product_state(m.lat.mps_sites(),
                                                ['up', 'up'], bc='infinite')
            ex.dmrg.run(psi, m, {'trunc_params': {'chi_max': 16,
                                                  'svd_min': 1e-12},
                                 'max_sweeps': 40, 'mixer': True}, **kw)
            psi.canonical_form()
            return ex.uniform_mps.UniformMPS.from_MPS(psi)
        u = uniform('u', m, make)
        for k, p in enumerate(EX_MOMENTA):
            e1 = ex.pwe.PlaneWaveExcitationEngine(
                u, m, {'lanczos_params': {'N_max': 40}}, **kw)
            out[f'{case}.E1_{k}'] = np.asarray(float(np.real(
                e1.run(p)[0][0])))
            for size in (1, 2):
                ms = ex.pwe.MultiSitePlaneWaveExcitationEngine(
                    u, m, {'excitation_size': size,
                           'lanczos_params': {'N_max': 40}})
                Es, psis, N = ms.run(p)
                out[f'{case}.Ems{size}_{k}'] = np.asarray(float(np.real(
                    Es[0])))
                out[f'{case}.n_sites{size}_{k}'] = np.asarray(
                    psis[0].n_sites)
    elif case == 'haldane':
        m = ex.SpinChain(dict(EX_SPIN1))
        u = uniform('u', m, vumps_state(m, ['1.0', '-1.0'], 24, 14,
                                        EX_VUMPS_SPIN1))
        pwe = ex.pwe.PlaneWaveExcitationEngine(
            u, m, {'lanczos_params': {'N_max': 60}}, **kw)
        Es, psis, N = pwe.run(np.pi, qtotal_change=[2])
        out[f'{case}.gap'] = np.asarray(float(np.real(Es[0])))
        out[f'{case}.N'] = np.asarray(N)
        out[f'{case}.chi'] = np.asarray(u.chi)
    elif case in ('sim_orthogonal', 'sim_builder'):
        L = 8 if case == 'sim_orthogonal' else 6
        chi = 32 if L == 8 else 16
        m = tfi(L, 'finite')
        psi, E = dmrg_state('psi0', m, ['up'] * L, 'finite', {
            'trunc_params': {'chi_max': chi, 'svd_min': 1e-12},
            'max_sweeps': 15 if L == 8 else 10})
        w = ex.ed_spectrum(m.H_MPO)
        opts = {'model_class': 'TFIChain',
                'model_params': {'L': L, 'J': 1., 'g': EX_G,
                                 'bc_MPS': 'finite', 'conserve': None},
                'algorithm_class': 'TwoSiteDMRGEngine',
                'algorithm_params': {'trunc_params': {'chi_max': chi,
                                                      'svd_min': 1e-12},
                                     'max_sweeps': 20 if L == 8 else 15,
                                     'min_sweeps': 6 if L == 8 else 4},
                'N_excitations': 2 if L == 8 else 1, 'save_psi': False,
                'output_filename': None, 'ground_state_energy': E}
        if L == 6:
            opts['initial_state_params'] = {
                'randomize_params': {'N_steps': 3},
                'use_highest_excitation': False}
        sim = ex.gss.OrthogonalExcitations(opts, ground_state_data=psi,
                                           **kw)
        with sim:
            res = sim.run()
        out[f'{case}.gaps'] = np.asarray(res['excitation_energies'])
        out[f'{case}.ed_gaps'] = np.asarray(w[1:3] - w[0])
        if L == 6:
            sim.options['initial_state_params'] = {}
            builder = ex.gss.ExcitationInitialState(
                sim, {'use_highest_excitation': False,
                      'randomize_params': {'N_steps': 1}})
            out[f'{case}.overlap'] = np.asarray(abs(complex(
                builder.run().overlap(sim.ground_state))))
    elif case == 'sim_plane_wave':
        m = tfi()
        u = uniform('u', m, vumps_state(m, ['up', 'up'], 12, 10,
                                        EX_VUMPS_TFI))
        sim = ex.gss.PlaneWaveExcitations(
            {'model_class': 'TFIChain', 'model_params': dict(EX_TFI_INF),
             'algorithm_params': {'lanczos_params': {'N_max': 40}},
             'momenta': list(EX_MOMENTA), 'save_psi': False,
             'output_filename': None}, ground_state_data=u, **kw)
        with sim:
            res = sim.run()
        out[f'{case}.momenta'] = np.asarray(res['momenta'])
        out[f'{case}.energies'] = np.asarray(res['excitation_energies'])
    elif case == 'operators':
        arrays = ex_operator_input(package)
        Mat, block = ex_operators(package, arrays)
        sp, kr = ex.sparse, ex.krylov
        H1, H2, v, w, o = (arrays[k] for k in ('H1', 'H2', 'v', 'w', 'o'))
        results = {
            'sum': sp.SumNpcLinearOperator(Mat(H1), Mat(H2)).matvec(v),
            'shift': sp.ShiftNpcLinearOperator(Mat(H1), 0.7).matvec(v),
            'boost': sp.BoostNpcLinearOperator(Mat(H1), [2.5], [o]
                                               ).matvec(v),
            'ortho': sp.OrthogonalNpcLinearOperator(Mat(H1), [o]).matvec(v),
            'sum_adj': sp.SumNpcLinearOperator(Mat(H1), Mat(arrays['C'])
                                               ).adjoint().matvec(v),
            'shift_adj': sp.ShiftNpcLinearOperator(Mat(arrays['C']), 0.3j
                                                   ).adjoint().matvec(v),
            'boost_list': sp.BoostNpcLinearOperator(block, [1.5], [[o, w]]
                                                    ).matvec([v, w])}
        for k, r in results.items():
            out[f'{case}.{k}'] = _dense(r)
        E0, psi0, N = kr.LanczosGroundState(block, [v, w],
                                            dict(EX_KRYLOV)).run()
        out[f'{case}.lanczos_E'] = np.asarray(E0)
        out[f'{case}.lanczos_psi'] = _dense(psi0)
        evals, _, _ = kr.Arnoldi(block, [v, w], dict(
            EX_KRYLOV, which='SR', num_ev=2)).run()
        out[f'{case}.arnoldi_E'] = np.asarray(evals)
        x, res = kr.GMRES(sp.ShiftNpcLinearOperator(block, 9.),
                          [v * 0., w * 0.], [v, w], dict(EX_GMRES)).run()
        out[f'{case}.gmres_x'] = _dense(x)
    else:
        raise ValueError(case)
    return out


def excitation_reference():
    """tenpy_tpu's runs of every case of :data:`EX_CASES`."""
    flat = {}
    for case in EX_CASES:
        t0 = time.time()
        res = excitation_case('jax', case)
        flat.update(res)
        print(f"{case}: {time.time() - t0:.1f} s, {len(res)} values",
              flush=True)
    return flat


# ================================================================ segments
# tests/test_torch_segment.py runs the port on the cases of
# tests/test_segment.py and tests/test_topological_excitations.py (cut to
# small sizes) from the infinite ground states tenpy_tpu made, and holds it
# to tenpy_tpu's runs in tests/benchmark_data/segment_reference.npz
# (--write-segment): the extracted lattice, model, MPO and MPS, the
# segment canonical form, segment DMRG, OrthogonalExcitations of an
# infinite ground state, TopologicalExcitations and the charge statistics.
SEG_REF = os.path.join(_ROOT, 'tests', 'benchmark_data',
                       'segment_reference.npz')
SEG_CASES = ('extract', 'canon', 'fixed', 'ortho_tfi', 'spin1', 'stats',
             'topo_tfi', 'topo_xxz_avg', 'topo_xxz_mp')
SEG_TFI = {'L': 2, 'J': 1., 'g': 1.5, 'bc_MPS': 'infinite', 'conserve': None}
SEG_SPIN1 = dict(EX_SPIN1)
SEG_SQUARE = {'lattice': 'Square', 'Lx': 1, 'Ly': 2, 'S': 0.5,
              'bc_MPS': 'infinite', 'Jx': 1., 'Jy': 1., 'Jz': 1.}
SEG_TOPO_TFI = {'L': 2, 'J': 1., 'g': 0.4, 'bc_MPS': 'infinite',
                'conserve': None}
SEG_TOPO_XXZ = {'L': 2, 'Jxx': 1., 'Jz': 3., 'hz': 0., 'bc_MPS': 'infinite'}
SEG_ENLARGE = 4
SEG_SPIN1_CHI = 16
SEG_SPIN1_ENLARGE = 3
SEG_OP_SITE = 4
# the two-site DMRG of every segment run (no mixer, as the JAX tests)
SEG_DMRG = {'trunc_params': {'chi_max': 24, 'svd_min': 1e-10},
            'max_sweeps': 6, 'min_sweeps': 3, 'mixer': False}


def segment_inputs(package='jax'):
    """The infinite ground states of the segment cases, made by
    ``package``'s DMRG and canonicalized: ``tfi`` (g=1.5, chi 24),
    ``spin1`` (the S=1 Heisenberg chain, chi 24), ``topo_tfi.gs0/1`` (the
    two broken states of the g=0.4 chain, chi 16) and ``topo_xxz.gs0/1``
    (the two Neel states of the Jz=3 XXZ chain, chi 16).  Returns the
    flat dict of the states and the states themselves."""
    ex = _EX(package)
    kw = ex.kw
    flat, states = {}, {}

    def finish(key, psi):
        psi.canonical_form()
        flat.update(state_flat(key, psi))
        states[key] = psi

    m = ex.tf_ising.TFIChain(dict(SEG_TFI))
    psi = ex.mps.MPS.from_product_state(m.lat.mps_sites(), ['up', 'up'],
                                        bc='infinite')
    ex.dmrg.run(psi, m, {'trunc_params': {'chi_max': 24, 'svd_min': 1e-12},
                         'max_sweeps': 40, 'mixer': True}, **kw)
    finish('tfi', psi)
    m = ex.SpinChain(dict(SEG_SPIN1))
    # the Haldane state by iDMRG from the Neel state, then single-site VUMPS
    # (the chi=24 iDMRG alone stalls at -1.39961 per site from the Neel
    # state; from Sz=0 on every site it reaches -1.40138 in a state whose
    # segment holds a Delta Sz=1 state 7e-4 below its ground state)
    psi = ex.mps.MPS.from_product_state(m.lat.mps_sites(), ['1.0', '-1.0'],
                                        bc='infinite')
    ex.dmrg.run(psi, m, {'trunc_params': {'chi_max': SEG_SPIN1_CHI,
                                          'svd_min': 1e-10},
                         'max_sweeps': 14, 'mixer': True}, **kw)
    eng = ex.vumps.SingleSiteVUMPSEngine(psi, m, dict(EX_VUMPS_SPIN1), **kw)
    eng.run()
    finish('spin1', eng.psi.to_MPS())
    s2 = 1. / np.sqrt(2.)
    for key, m, inits in (
            ('topo_tfi', ex.tf_ising.TFIChain(dict(SEG_TOPO_TFI)),
             ([np.array([s2, s2])] * 2, [np.array([s2, -s2])] * 2)),
            ('topo_xxz', ex.xxz_chain.XXZChain(dict(SEG_TOPO_XXZ)),
             (['up', 'down'], ['down', 'up']))):
        for k, init in enumerate(inits):
            psi = ex.mps.MPS.from_product_state(m.lat.mps_sites(), init,
                                                bc='infinite')
            # no mixer: it mixes the broken sectors back into a cat state
            ex.dmrg.TwoSiteDMRGEngine(psi, m, {
                'trunc_params': {'chi_max': 16, 'svd_min': 1e-12},
                'max_sweeps': 30}, **kw).run()
            finish(f'{key}.gs{k}', psi)
    return flat, states


def _dense_list(prefix, arrays):
    return {f'{prefix}.{i}': np.asarray(a.to_ndarray())
            for i, a in enumerate(arrays)}


def _Id(ids):
    return np.array([-1 if x is None else int(x) for x in ids])


def segment_case(package, case, inputs, states=None):
    """One of :data:`SEG_CASES` in ``package`` ('jax' or 'torch') from the
    states of :func:`segment_inputs`: the port reads them from the flat
    dict ``inputs``, tenpy_tpu takes its own ``states``.  A flat dict of
    the case's values under ``<case>.``."""
    import warnings
    warnings.simplefilter('ignore')
    ex = _EX(package)
    kw = ex.kw
    out = {}

    def state(key, m):
        if states is not None:
            return states[key].copy()
        return load_state(inputs, key, m.lat.mps_sites())

    def env_energy(env):
        return float(np.real(env.full_contraction(1)))

    def sim_opts(model_class, model_params, **extra):
        opts = {'model_class': model_class,
                'model_params': dict(model_params),
                'segment_enlarge': SEG_ENLARGE,
                'algorithm_params': dict(SEG_DMRG),
                'save_psi': False, 'output_filename': None}
        opts.update(extra)
        return opts

    if case == 'extract':
        m = ex.tf_ising.TFIChain(dict(SEG_TFI))
        psi = state('tfi', m)
        m_seg = m.extract_segment(enlarge=3)
        out['first_last'] = np.asarray(m_seg.lat.segment_first_last)
        out['n_sites'] = np.asarray(len(m_seg.lat.mps_sites()))
        out['order'] = np.asarray(m_seg.lat.order)
        H = m_seg.H_MPO
        out['bc'] = np.array([m_seg.lat.bc_MPS, H.bc])
        out.update(_dense_list('W', H._W))
        out['IdL'] = _Id(H.IdL)
        out['IdR'] = _Id(H.IdR)
        out.update(_dense_list('H_bond', [h for h in m_seg.H_bond
                                          if h is not None]))
        m2 = m.extract_segment(0, 5)
        out['first_last_2'] = np.asarray(m2.lat.segment_first_last)
        psi_seg = psi.extract_segment(0, 5)
        out['seg_bc'] = np.array(psi_seg.bc)
        out['sigmaz'] = np.asarray(psi_seg.expectation_value('Sigmaz'))
        out['sigmaz_inf'] = np.asarray(psi.expectation_value('Sigmaz'))
        out['seg_S'] = np.concatenate([np.sort(np.asarray(s)) for s in
                                       psi_seg._S])
        sq = ex.spins.SpinModel(dict(SEG_SQUARE))
        sq_seg = sq.extract_segment(enlarge=2)
        out['sq_order'] = np.asarray(sq_seg.lat.order)
        out['sq_Ls'] = np.asarray(sq_seg.lat.Ls)
        out.update(_dense_list('sq_W', sq_seg.H_MPO._W))
        out['sq_IdL'] = _Id(sq_seg.H_MPO.IdL)
        out['sq_IdR'] = _Id(sq_seg.H_MPO.IdR)
    elif case == 'canon':
        m = ex.tf_ising.TFIChain(dict(SEG_TFI))
        psi = state('tfi', m)
        env_data, Es, _ = ex.mpo.MPOTransferMatrix.find_init_LP_RP(
            m.H_MPO, psi, calc_E=True)
        m_seg = m.extract_segment(enlarge=3)
        first, last = m_seg.lat.segment_first_last
        for key, eps in (('small', 1e-8), ('big', 0.1)):
            seg = psi.extract_segment(first, last)
            env = ex.mpo.MPOEnvironment(seg, m_seg.H_MPO, seg,
                                        **dict(env_data))
            out[f'{key}.E_before'] = np.asarray(env_energy(env))
            B = seg.get_B(2, 'B')
            X = ex.npc.tensordot(seg.get_site(2).get_op('Sigmax'), B,
                                 axes=[['p*'], ['p']])
            X.itranspose(B.get_leg_labels())
            seg.set_B(2, B + X * eps, form='B')
            UL, VR = seg.canonical_form_finite(envs_to_update=[env])
            out[f'{key}.E_after'] = np.asarray(env_energy(env))
            out[f'{key}.norm_test'] = np.asarray(
                float(np.max(seg.norm_test())))
            out[f'{key}.S'] = np.concatenate([np.sort(np.asarray(s))
                                              for s in seg._S])
            out[f'{key}.UL_is'] = np.asarray(seg.segment_boundaries[0]
                                             is UL)
            out[f'{key}.sigmaz'] = np.asarray(seg.expectation_value('Sigmaz'))
    elif case == 'fixed':
        m = ex.tf_ising.TFIChain(dict(SEG_TFI))
        psi = state('tfi', m)
        env_data, Es, _ = ex.mpo.MPOTransferMatrix.find_init_LP_RP(
            m.H_MPO, psi, calc_E=True)
        m_seg = m.extract_segment(enlarge=3)
        f, l = m_seg.lat.segment_first_last
        seg = psi.extract_segment(f, l)
        out['sigmaz0'] = np.asarray(seg.expectation_value('Sigmaz'))
        eng = ex.dmrg.TwoSiteDMRGEngine(
            seg, m_seg, {'trunc_params': {'chi_max': 24, 'svd_min': 1e-12},
                         'max_sweeps': 4, 'mixer': False},
            resume_data={'init_env_data': dict(env_data)}, **kw)
        E, seg = eng.run()
        out['E'] = np.asarray(float(E))
        out['sigmaz'] = np.asarray(seg.expectation_value('Sigmaz'))
    elif case == 'ortho_tfi':
        m = ex.tf_ising.TFIChain(dict(SEG_TFI))
        psi = state('tfi', m)
        sim = ex.gss.OrthogonalExcitations(
            sim_opts('TFIChain', SEG_TFI, N_excitations=1,
                     apply_local_op={'i': SEG_OP_SITE, 'op': 'Sigmax'}),
            ground_state_data=psi, **kw)
        with sim:
            res = sim.run()
        out['gaps'] = np.asarray(res['excitation_energies'])
        out['e_density'] = np.asarray(res['ground_state_energy_density'])
        out['E0'] = np.asarray(res['ground_state_energy'])
    elif case == 'spin1':
        m = ex.SpinChain(dict(SEG_SPIN1))
        psi = state('spin1', m)
        opts = sim_opts('SpinChain', SEG_SPIN1, N_excitations=1,
                        segment_enlarge=SEG_SPIN1_ENLARGE,
                        apply_local_op={'i': SEG_SPIN1_ENLARGE, 'op': 'Sp'},
                        initial_state_params={
                            'use_highest_excitation': False})
        opts['algorithm_params'].update(
            trunc_params={'chi_max': SEG_SPIN1_CHI, 'svd_min': 1e-10},
            max_sweeps=2, min_sweeps=2)
        sim = ex.gss.OrthogonalExcitations(opts, ground_state_data=psi,
                                           **kw)
        with sim:
            res = sim.run()
        gs = sim.ground_state
        out['gaps'] = np.asarray(res['excitation_energies'])
        out['e_density'] = np.asarray(res['ground_state_energy_density'])
        out['dq'] = np.asarray([np.asarray(x.get_total_charge())
                                - np.asarray(gs.get_total_charge())
                                for x in sim.excitations])
        if package == 'torch':   # tenpy_tpu's segment overlap is not one
            out['overlap'] = np.asarray(abs(complex(
                sim.excitations[0].overlap(gs))))
            out['norms'] = np.asarray([abs(complex(x.overlap(x)))
                                       for x in sim.excitations])
    elif case == 'stats':
        m = ex.SpinChain(dict(SEG_SPIN1))
        psi = state('spin1', m)
        seg = psi.extract_segment(0, 2 * SEG_SPIN1_ENLARGE - 1)
        for key, st, bonds in (('inf', psi, (0, 1)),
                               ('seg', seg, (0, 3, seg.L))):
            for b in bonds:
                pq = sorted((tuple(np.asarray(q).ravel()), p)
                            for q, p in st.probability_per_charge(b))
                out[f'{key}.{b}.q'] = np.asarray([q for q, _ in pq])
                out[f'{key}.{b}.p'] = np.asarray([p for _, p in pq])
                out[f'{key}.{b}.avg'] = np.asarray(st.average_charge(b))
                out[f'{key}.{b}.var'] = np.asarray(st.charge_variance(b))
        out['total'] = np.asarray(seg.get_total_charge())
        out['total_phys'] = np.asarray(seg.get_total_charge(True))
    elif case.startswith('topo_'):
        if case == 'topo_tfi':
            m = ex.tf_ising.TFIChain(dict(SEG_TOPO_TFI))
            cls, params, key, extra = 'TFIChain', SEG_TOPO_TFI, 'topo_tfi', {}
        else:
            m = ex.xxz_chain.XXZChain(dict(SEG_TOPO_XXZ))
            cls, params, key = 'XXZChain', SEG_TOPO_XXZ, 'topo_xxz'
            extra = {'join_method': 'average charge' if case.endswith('avg')
                     else 'most probable charge'}
        gs = [state(f'{key}.gs{k}', m) for k in (0, 1)]
        # the second join method only glues (the relaxation is the first's)
        n_exc = 0 if case == 'topo_xxz_mp' else 1
        opts = sim_opts(cls, params, N_excitations=n_exc, **extra)
        opts['algorithm_params']['trunc_params'] = {'chi_max': 16,
                                                    'svd_min': 1e-10}
        sim = ex.gss.TopologicalExcitations(opts, gs_data_alpha=gs[0],
                                            gs_data_beta=gs[1], **kw)
        with sim:
            res = sim.run()
        glued = sim.ground_state
        out['gaps'] = np.asarray(res['excitation_energies'])
        out['E_ref'] = np.asarray(res['ground_state_energy'])
        out['glued_S'] = np.sort(np.asarray(glued.get_SL(glued.L // 2)))
        out['glued_norm_test'] = np.asarray(float(np.max(
            glued.norm_test())))
        out['glued_charge'] = np.asarray(glued.get_total_charge())
    else:
        raise ValueError(case)
    return {f'{case}.{k}': v for k, v in out.items()}


def segment_reference():
    """tenpy_tpu's inputs and runs of every case of :data:`SEG_CASES`."""
    t0 = time.time()
    flat, states = segment_inputs('jax')
    print(f"inputs: {time.time() - t0:.1f} s", flush=True)
    for case in SEG_CASES:
        t0 = time.time()
        res = segment_case('jax', case, flat, states)
        flat.update(res)
        print(f"{case}: {time.time() - t0:.1f} s, {len(res)} values",
              flush=True)
    return flat


# ----------------------------------------------------------- the model layer
# sites, lattices, terms and models of ``tenpy_tpu`` against the port, on
# the cases of tests/test_models.py, test_models_2d.py, test_lattice.py,
# test_site.py and test_terms.py.  Every case is a function of the package
# ('jax' or 'torch') returning flat values; the writer stores JAX's, the
# port's test computes its own and compares key by key.
MODELS_REF = os.path.join(_ROOT, 'tests', 'benchmark_data',
                          'models_reference.npz')


def _pkg(package, name):
    import importlib
    root = 'tenpy_tpu' if package == 'jax' else 'tenpy_tpu_torch'
    return importlib.import_module(f'{root}.{name}')


def _arr(a):
    """A dense numpy copy of an Array of either package."""
    return np.array(a.to_ndarray())


def _js(x):
    """``x`` as a JSON string array (numpy values made plain)."""
    def plain(v):
        if isinstance(v, dict):
            return {str(k): plain(w) for k, w in v.items()}
        if isinstance(v, (list, tuple, np.ndarray)):
            return [plain(w) for w in v]
        if isinstance(v, (np.integer, np.bool_)):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
        return v
    return np.array(json.dumps(plain(x), sort_keys=True))


def site_flat(prefix, site):
    """A site's leg charges, state labels, operators (dense) and
    Jordan-Wigner and hermitian-conjugate bookkeeping."""
    out = {'qflat': site.leg.to_qflat(), 'qconj': np.asarray(site.leg.qconj),
           'labels': _js(site.state_labels),
           'opnames': _js(sorted(site.opnames)),
           'need_JW': _js(sorted(site.need_JW_string)),
           'hc_ops': _js(site.hc_ops),
           'JW_parity': _js(site.charge_to_JW_parity)}
    for name in site.opnames:
        out['op.' + name] = _arr(site.get_op(name))
    return {f'{prefix}.{k}': v for k, v in out.items()}


def _sites_cases(package):
    S = _pkg(package, 'networks.site')
    spin = lambda: S.SpinHalfSite('Sz')   # noqa: E731
    ferm = lambda: S.FermionSite('N')     # noqa: E731
    up_dn, _ = S.spin_half_species(S.FermionSite, 'N', 'Sz')
    b_up, _ = S.spin_half_species(S.BosonSite, 'parity', None, Nmax=2)
    common = [S.SpinHalfSite('Sz'), S.FermionSite('N')]
    perms = S.set_common_charges(common, 'independent')
    kron = S.kron(spin().Sp, spin().Sm)
    return {
        'hole': S.SpinHalfHoleSite(),
        'hole_parity': S.SpinHalfHoleSite('parity', 'parity'),
        'hole_none': S.SpinHalfHoleSite(None, None),
        'boson_N': S.BosonSite(3, 'N'),
        'boson_parity': S.BosonSite(2, 'parity'),
        'boson_none': S.BosonSite(4, None, filling=0.5),
        'clock_Z': S.ClockSite(3, 'Z'),
        'clock_none': S.ClockSite(4, None),
        'clock_2': S.ClockSite(2, 'Z'),
        'grouped_fermions': S.GroupedSite([ferm(), ferm()]),
        'grouped_spins': S.GroupedSite([spin(), spin()], ['a', 'b']),
        'grouped_independent': S.GroupedSite(
            [spin(), S.SpinSite(1., 'Sz')], charges='independent'),
        'grouped_drop': S.GroupedSite([spin(), ferm()], charges='drop'),
        'grouped_of_three': S.group_sites([spin(), spin(), spin()], n=3)[0],
        'species_up': up_dn[0], 'species_down': up_dn[1],
        'species_boson': b_up[0],
        'common_spin': common[0], 'common_fermion': common[1],
    }, {'common_perms': _js(perms), 'kron': _arr(kron),
        'kron_qflat': kron.get_leg('p').to_qflat()}


def sites_case(package):
    """Every new site of :func:`_sites_cases`, ``kron`` and the
    permutations of ``set_common_charges``."""
    sites, extra = _sites_cases(package)
    flat = {f'sites.{k}': v for k, v in extra.items()}
    for name, site in sites.items():
        flat.update(site_flat(f'sites.{name}', site))
    return flat


def lattice_flat(prefix, lat, multi=None, find_pairs=False):
    """A lattice's order, pairs, ``possible_couplings`` of every pair,
    ``possible_multi_couplings`` of ``multi`` and the geometry."""
    lat.test_sanity()
    out = {'order': np.asarray(lat.order), 'N_sites': np.asarray(lat.N_sites),
           'bc': _js(lat.boundary_conditions), 'basis': lat.basis,
           'positions': lat.position_vectors,
           'pairs': _js({k: [(u1, u2, list(np.asarray(dx)))
                             for u1, u2, dx in v]
                         for k, v in lat.pairs.items()})}
    for key, entries in lat.pairs.items():
        for n, (u1, u2, dx) in enumerate(entries):
            i, j, lat_idx, shape = lat.possible_couplings(u1, u2, dx)
            for k, v in (('i', i), ('j', j), ('lat', lat_idx),
                         ('shape', np.asarray(shape))):
                out[f'pc.{key}.{n}.{k}'] = np.asarray(v)
    if multi is not None:
        ijkl, lat_idx, shape = lat.possible_multi_couplings(multi)
        out.update({'multi.ijkl': ijkl, 'multi.lat': lat_idx,
                    'multi.shape': np.asarray(shape)})
    out['positions_all'] = lat.position(np.asarray(lat.order))
    out['mps2lat'] = lat.mps2lat_values(np.arange(lat.N_sites))
    out['mps2lat_u0'] = lat.mps2lat_values(
        np.arange(len(lat.mps_idx_fix_u(0))), u=0)
    if find_pairs:
        out['found'] = _js({k: [(u1, u2, list(dx)) for u1, u2, dx in v]
                            for k, v in lat.find_coupling_pairs().items()})
        out['BZ.recip'] = lat.BZ.reciprocal_basis
        out['BZ.vertices'] = lat.BZ.vertices()
    return {f'{prefix}.{k}': v for k, v in out.items()}


def lattices_case(package):
    """The new lattices and orders, in the shapes of
    tests/test_lattice.py, test_models.py and test_models_2d.py."""
    La = _pkg(package, 'models.lattice')
    S = _pkg(package, 'networks.site')
    TC = _pkg(package, 'models.toric_code')
    s, f = S.SpinHalfSite('Sz'), S.FermionSite('N')
    m3 = [('A', [0, 0], 0), ('B', [1, 0], 1), ('C', [0, 1], 0)]
    m1 = [('A', [-1], 0), ('B', [0], 0), ('C', [1], 0)]
    per, inf = ['periodic', 'periodic'], 'infinite'
    cases = {
        'ladder': (La.Ladder(4, s, bc='periodic', bc_MPS=inf), m1, False),
        'nleg': (La.NLegLadder(3, 3, s), None, False),
        'triangular': (La.Triangular(3, 3, s, bc='periodic'), m3, True),
        'triangular_cyl': (La.Triangular(2, 3, s, bc=['open', 'periodic']),
                           m3, False),
        'honeycomb': (La.Honeycomb(2, 2, [s, s], bc=per, bc_MPS=inf), m3,
                      False),
        'honeycomb_pbc': (La.Honeycomb(3, 3, [s, s], bc='periodic'), None,
                          True),
        'honeycomb_cyl3': (La.Honeycomb(1, 3, f, bc=per, bc_MPS=inf), m3,
                           False),
        'honeycomb_shift': (La.Honeycomb(2, 3, [s, s], bc=['periodic', -1],
                                         bc_MPS=inf), m3, False),
        'honeycomb_grouped': (La.Honeycomb(2, 2, s,
                                           order=('grouped', [[1], [0]])),
                              None, False),
        'kagome': (La.Kagome(3, 3, [s] * 3, bc='periodic'), m3, True),
        'kagome_cyl': (La.Kagome(1, 2, s, bc=['open', 'periodic']), None,
                       False),
        'square_snake': (La.Square(3, 4, s, order='snake',
                                   bc=['open', 'periodic']), m3, True),
        'square_fstyle': (La.Square(3, 4, s, order='Fstyle'), None, False),
        'chain_folded': (La.Chain(6, s, order='folded', bc='periodic'), m1,
                         False),
        'trivial': (La.TrivialLattice([s, f, s]), None, False),
        'multispecies': (La.MultiSpeciesLattice(La.Square(2, 2, f), [f, f],
                                                ['up', 'down']), None, False),
        'dual_square': (TC.DualSquare(2, 2, s), None, False),
    }
    flat = {}
    for name, (lat, multi, find) in cases.items():
        flat.update(lattice_flat(f'lattices.{name}', lat, multi, find))
    return flat


def mpo_flat(prefix, H):
    """An MPO's W tensors (dense), virtual charges and IdL/IdR."""
    out = {'L': np.asarray(H.L), 'IdL': _js(H.IdL), 'IdR': _js(H.IdR),
           'chi': np.asarray(H.chi)}
    for i in range(H.L):
        W = H.get_W(i)
        out[f'W.{i}'] = _arr(W.transpose(['wL', 'wR', 'p', 'p*']))
        out[f'wL.{i}'] = W.get_leg('wL').to_qflat()
    return {f'{prefix}.{k}': v for k, v in out.items()}


def model_flat(prefix, m):
    """A model's MPO (:func:`mpo_flat`) and, for a
    ``NearestNeighborModel``, its bond Hamiltonians (dense)."""
    flat = mpo_flat(prefix, m.H_MPO)
    flat[f'{prefix}.max_range'] = np.asarray(m.H_MPO.max_range)
    for i, h in enumerate(getattr(m, 'H_bond', None) or []):
        if h is not None:
            flat[f'{prefix}.H_bond.{i}'] = _arr(h.transpose(
                ['p0', 'p0*', 'p1', 'p1*']))
    return flat


# (module, class, parameters) of every model held to JAX: the cases of
# tests/test_models.py:62-75 (MODELS_VS_ED) and :112, of
# tests/test_models_2d.py and test_models.py:137, and infinite and option
# variants of the new models
MODEL_CASES = {
    'tfi': ('tf_ising', 'TFIChain', {'L': 6, 'J': 1., 'g': 1.3}),
    'xxz': ('xxz_chain', 'XXZChain', {'L': 6, 'Jxx': 1., 'Jz': 0.7,
                                      'hz': 0.1}),
    'spin_half': ('spins', 'SpinChain', {'L': 6, 'S': 0.5, 'Jx': 1.,
                                         'Jy': 1., 'Jz': 0.3, 'hz': 0.2}),
    'spin_one': ('spins', 'SpinChain', {'L': 4, 'S': 1., 'Jx': 1., 'Jy': 1.,
                                        'Jz': 1.}),
    'nnn2': ('spins_nnn', 'SpinChainNNN2', {'L': 6, 'Jx': 1., 'Jy': 1.,
                                            'Jz': 0.5, 'Jxp': 0.4,
                                            'Jyp': 0.4, 'Jzp': 0.2}),
    'fermion_chain': ('fermions_spinless', 'FermionChain',
                      {'L': 6, 'J': 1., 'V': 0.5, 'mu': 0.3}),
    'hubbard_chain': ('hubbard', 'FermiHubbardChain', {'L': 4, 't': 1.,
                                                       'U': 4., 'mu': 1.}),
    'bose_hubbard': ('hubbard', 'BoseHubbardChain', {'L': 4, 't': 1.,
                                                     'U': 2., 'n_max': 2}),
    'tj': ('tj_model', 'tJChain', {'L': 4, 't': 1., 'J': 0.4}),
    'clock': ('clock', 'ClockChain', {'L': 4, 'q': 3, 'J': 1., 'g': 0.7}),
    'pxp': ('pxp', 'PXPChain', {'L': 6, 'Omega': 1.}),
    'tfi_ladder': ('tf_ising', 'TFIModel', {'lattice': 'Square', 'Lx': 2,
                                            'Ly': 3, 'J': 1., 'g': 1.2,
                                            'bc_y': 'ladder'}),
    'aklt': ('aklt', 'AKLTChain', {'L': 2, 'bc_MPS': 'infinite',
                                   'conserve': 'Sz'}),
    'toric': ('toric_code', 'ToricCode', {'Lx': 2, 'Ly': 2,
                                          'bc_MPS': 'finite',
                                          'conserve': None}),
    'toric_inf': ('toric_code', 'ToricCode', {'Lx': 1, 'Ly': 2,
                                              'bc_MPS': 'infinite'}),
    'hofstadter_fermions': ('hofstadter', 'HofstadterFermions', {
        'Lx': 3, 'Ly': 2, 'phi': (1, 2), 'bc_MPS': 'finite',
        'bc_y': 'cylinder', 'conserve': 'N'}),
    'hofstadter_bosons': ('hofstadter', 'HofstadterBosons', {
        'Lx': 2, 'Ly': 3, 'phi': (1, 3), 'Nmax': 2, 'U': 1., 'mu': 0.2,
        'bc_MPS': 'infinite', 'bc_y': 'cylinder'}),
    'haldane': ('haldane', 'FermionicHaldaneModel', {
        'Lx': 2, 'Ly': 2, 'bc_MPS': 'finite', 'conserve': 'N'}),
    'haldane_cylinder': ('haldane', 'FermionicHaldaneModel', {
        'Lx': 1, 'Ly': 3, 'bc_MPS': 'infinite', 'bc_y': 'cylinder',
        'conserve': 'N', 't1': -1., 'V': 0., 'mu': 0.}),
    'haldane_bosons': ('haldane', 'BosonicHaldaneModel', {
        'Lx': 1, 'Ly': 3, 'bc_MPS': 'infinite', 'bc_y': 'cylinder',
        'V': 0.5, 'mu': 0.1, 't2': 0.2 + 0.1j}),
    'triangular': ('spins', 'SpinModel', {
        'lattice': 'Triangular', 'Lx': 2, 'Ly': 3, 'Jx': 1., 'Jy': 1.,
        'Jz': 1., 'bc_MPS': 'finite', 'bc_y': 'cylinder', 'conserve': 'Sz',
        'S': 0.5}),
    'kagome': ('spins', 'SpinModel', {
        'lattice': 'Kagome', 'Lx': 1, 'Ly': 2, 'Jx': 1., 'Jy': 1.,
        'Jz': 1., 'bc_MPS': 'finite', 'bc_y': 'cylinder', 'conserve': 'Sz',
        'S': 0.5}),
    'hubbard2': ('hubbard', 'FermiHubbardModel2', {
        'L': 3, 't': 1., 'U': 4., 'mu': 0.5, 'V': 0.3, 'bc_MPS': 'finite'}),
    'hubbard2_infinite': ('hubbard', 'FermiHubbardModel2', {
        'L': 2, 't': 1., 'U': 4., 'bc_MPS': 'infinite'}),
    'bose_hubbard_square': ('hubbard', 'BoseHubbardModel', {
        'lattice': 'Square', 'Lx': 2, 'Ly': 2, 'n_max': 2, 'U': 3.,
        'V': 0.5, 'bc_MPS': 'infinite'}),
    'fermions_honeycomb': ('fermions_spinless', 'FermionModel', {
        'lattice': 'Honeycomb', 'Lx': 1, 'Ly': 2, 'V': 0.5,
        'bc_MPS': 'infinite'}),
    'tj_ladder': ('tj_model', 'tJModel', {'lattice': 'Ladder', 'L': 2,
                                          'bc_MPS': 'infinite'}),
    'clock_infinite': ('clock', 'ClockChain', {'L': 2, 'q': 4,
                                               'conserve': None,
                                               'bc_MPS': 'infinite'}),
    'nnn_grouped': ('spins_nnn', 'SpinChainNNN', {'L': 3, 'Jz': 0.5,
                                                  'Jxp': 0.4, 'Jyp': 0.4,
                                                  'Jzp': 0.2, 'hz': 0.1}),
    'nnn_grouped_infinite': ('spins_nnn', 'SpinChainNNN', {
        'L': 2, 'Jx': 1., 'Jy': 0.8, 'bc_MPS': 'infinite'}),
    'nnn2_infinite': ('spins_nnn', 'SpinChainNNN2', {
        'L': 2, 'Jxp': 0.5, 'bc_MPS': 'infinite'}),
    'pxp_infinite': ('pxp', 'PXPChain', {'L': 3, 'bc_MPS': 'infinite'}),
    'explicit_hc': ('hubbard', 'FermiHubbardChain', {
        'L': 4, 'U': 2., 'mu': 0.3, 'explicit_plus_hc': True}),
    'sort_mpo_legs': ('hubbard', 'FermiHubbardModel', {
        'lattice': 'Square', 'Lx': 2, 'Ly': 2, 'bc_MPS': 'infinite',
        'U': 4., 'sort_mpo_legs': True}),
}
# the cases whose spectrum is held to JAX's (every state: at most 256)
MODEL_ED_CASES = ['tfi', 'xxz', 'spin_half', 'spin_one', 'nnn2',
                  'fermion_chain', 'hubbard_chain', 'bose_hubbard', 'tj',
                  'clock', 'pxp', 'toric', 'haldane', 'triangular', 'kagome',
                  'hubbard2', 'nnn_grouped', 'explicit_hc']


def make_model(package, case):
    module, cls, params = MODEL_CASES[case]
    return getattr(_pkg(package, 'models.' + module), cls)(dict(params))


def model_case(package, case):
    """A model's MPO and bond Hamiltonians (:func:`model_flat`)."""
    return model_flat(f'model.{case}', make_model(package, case))


def ed_case(package, case):
    """The full spectrum of a finite model (from its MPO)."""
    ed = _pkg(package, 'algorithms.exact_diag')
    H = np.asarray(ed.get_numpy_Hamiltonian(make_model(package, case)))
    return {f'ed.{case}': np.linalg.eigvalsh(H)}


def dsl_models(package):
    """A model of the DSL parts no model of the zoo uses, in ``package``:
    exponentially decaying couplings, single terms by MPS and lattice
    index, a multi-coupling term and external-flux phases."""
    model = _pkg(package, 'models.model')
    lattice = _pkg(package, 'models.lattice')
    site = _pkg(package, 'networks.site')

    class DSL(model.CouplingMPOModel):
        def init_sites(self, p):
            return site.FermionSite('N') if p.get('fermions', False) \
                else site.SpinHalfSite('Sz')

        def init_terms(self, p):
            L = self.lat.N_sites
            ferm = p.get('fermions', False)
            a, b = ('Cd', 'C') if ferm else ('Sp', 'Sm')
            n = 'N' if ferm else 'Sz'
            self.add_exponentially_decaying_coupling(0.7, 0.4, n, n)
            self.add_exponentially_decaying_coupling(
                0.3, 0.5, a, b, subsites=np.arange(0, L, 2), plus_hc=True)
            self.add_onsite_term(0.2, 1, n)
            self.add_coupling_term(0.3, 0, 2, n, n)
            self.add_multi_coupling_term(0.4, [0, 1, 3], [n, n, n])
            if self.lat.dim == 2:
                phase = [0., 0.7]
                s = self.coupling_strength_add_ext_flux(-1., [0, 1], phase)
                self.add_coupling(s, 0, a, 0, b, [0, 1], plus_hc=True)
                self.add_local_term(0.5, [(n, [0, 0, 0]), (n, [1, 1, 0])])
                self.add_local_term(0.25, [(a, [0, 1, 0]), (b, [1, 0, 0]),
                                           (n, [1, 1, 0])], plus_hc=False)

    return {
        'dsl_finite': DSL({'L': 6, 'bc_MPS': 'finite'}),
        'dsl_infinite': DSL({'L': 4, 'bc_MPS': 'infinite'}),
        'dsl_fermions': DSL({'L': 6, 'fermions': True}),
        'dsl_flux': DSL({'lattice': lattice.Square(2, 3, site.FermionSite(
            'N'), bc=['open', 'periodic'], bc_MPS='finite'),
            'fermions': True}),
    }


def dsl_case(package, case):
    return model_flat(f'dsl.{case}', dsl_models(package)[case])


def terms_case(package):
    """``TermList`` and the multi-coupling and exponentially decaying
    terms through ``MPOGraph`` (the cases of tests/test_terms.py)."""
    terms = _pkg(package, 'networks.terms')
    site = _pkg(package, 'networks.site')
    mpo = _pkg(package, 'networks.mpo')
    spin, ferm = site.SpinHalfSite('Sz'), site.FermionSite('N')
    flat = {}
    tl = terms.TermList([[('Sz', 0)], [('Sz', 0), ('Sz', 1)],
                         [('Sz', 2), ('Sp', 1), ('Sm', 3)],
                         [('Sp', 0), ('Sm', 0)]], [0.5, 2., -0.3, 1.])
    flat['terms.str'] = np.array(str(tl))
    flat['terms.limits'] = np.asarray(tl.limits())
    flat['terms.max_range'] = np.asarray(tl.max_range())
    fl = terms.TermList([[('Cd', 2), ('C', 0)], [('C', 3), ('Cd', 1),
                                                 ('N', 2)]], [1., 0.5])
    fl.order_combine([ferm] * 4)
    flat['terms.fermion_order'] = np.array(str(fl))
    tl.order_combine([spin] * 4)
    flat['terms.ordered'] = np.array(str(tl))
    lat = _pkg(package, 'models.lattice').Square(2, 2, spin, bc='periodic')
    ll = terms.TermList.from_lattice_locations(
        lat, [[('Sz', [0, 0, 0]), ('Sz', [1, 1, 0])], [('Sp', [0, 1, 0])]],
        [0.5, 1.5], shift=[1, 0])
    flat['terms.lattice_locations'] = np.array(str(ll))
    flat['terms.algebra'] = np.array(str(ll.shift(2) + tl * 2.))
    for bc in ('finite', 'infinite'):
        H = mpo.MPOGraph.from_term_list(tl, [spin] * 4, bc).build_MPO()
        flat.update(mpo_flat(f'terms.term_list_{bc}', H))
        mct = terms.MultiCouplingTerms(4)
        mct.add_multi_coupling_term(1., [0, 1, 2], ['Sz', 'Sz', 'Sz'], 'Id')
        mct.add_multi_coupling_term(0.5, [0, 3], ['Sp', 'Sm'], 'Id')
        mct.add_multi_coupling_term(0.25, [1, 2, 5] if bc == 'infinite'
                                    else [1, 2, 3], ['Sp', 'Sz', 'Sm'],
                                    ['Id', 'Id'])
        mct._test_terms([spin] * 4)
        H = mpo.MPOGraph.from_terms([mct], [spin] * 4, bc).build_MPO()
        flat.update(mpo_flat(f'terms.multi_{bc}', H))
        flat[f'terms.multi_{bc}.list'] = np.array(str(mct.to_TermList()))
        edt = terms.ExponentiallyDecayingTerms(6 if bc == 'finite' else 2)
        edt.add_exponentially_decaying_coupling(2., 0.5, 'Sz', 'Sz')
        edt._test_terms([spin] * edt.L)
        H = mpo.MPOGraph.from_terms([edt], [spin] * edt.L, bc).build_MPO()
        flat.update(mpo_flat(f'terms.exp_{bc}', H))
        flat[f'terms.exp_{bc}.list'] = np.array(str(edt.to_TermList(
            0.01, bc)))
    fmct = terms.MultiCouplingTerms(4)
    args = fmct.multi_coupling_term_handle_JW(
        0.5, [('Cd', 0), ('N', 1), ('C', 2), ('N', 3)], [ferm] * 4)
    flat['terms.fermion_JW'] = _js(args)
    return flat


def spectrum_case(package, flat_state):
    """``entanglement_spectrum`` (plain and by charge) of the finite
    Haldane DMRG state, loaded from ``flat_state`` into ``package``."""
    m = make_model(package, 'haldane')
    if package == 'jax':
        psi = flat_state
    else:
        psi = load_state(flat_state, 'dmrg.psi', m.lat.mps_sites())
    out = {}
    for ib, spec in enumerate(psi.entanglement_spectrum()):
        out[f'spectrum.{ib}'] = np.asarray(spec)
    for ib, spec in enumerate(psi.entanglement_spectrum(by_charge=True)):
        out[f'spectrum_q.{ib}.charges'] = np.array([q for q, _ in spec])
        out[f'spectrum_q.{ib}.sizes'] = np.array([len(v) for _, v in spec])
        out[f'spectrum_q.{ib}.values'] = np.concatenate([v for _, v in spec])
    return out


# tests/test_models_2d.py:74-81: the finite 2x2 Haldane patch by DMRG
HALDANE_DMRG_OPTIONS = {'trunc_params': {'chi_max': 64, 'svd_min': 1e-12},
                        'max_sweeps': 30, 'mixer': True,
                        'N_sweeps_check': 2}


def haldane_dmrg(package):
    """``dmrg.run`` on the finite 2x2 Haldane patch from the half-filled
    product state: ``(E, psi)``."""
    import copy
    m = make_model(package, 'haldane')
    mps = _pkg(package, 'networks.mps')
    dmrg = _pkg(package, 'algorithms.dmrg')
    L = m.lat.N_sites
    psi = mps.MPS.from_product_state(m.lat.mps_sites(),
                                     (['full', 'empty'] * L)[:L],
                                     bc='finite')
    kw = {} if package == 'jax' else {'device': 'cpu'}
    E = dmrg.run(psi, m, copy.deepcopy(HALDANE_DMRG_OPTIONS), **kw)['E']
    return float(np.real(E)), psi


# the Haldane cylinder of examples/chern_insulators/haldane.py (config #5's
# Haldane half) by device_ramp from the half-filled product state: to
# chi=16 on the CPU (the port's test) and the first stage, chi=64, of the
# chip run's chi=256 ramp (chip_smoke.py phase 16: there an inner stage,
# whose sweeps all expand; settle_sweeps=0 makes this run's last stage the
# same).  The y-translation symmetry of the cylinder leaves degenerate
# pairs in the Schmidt spectrum, so a stage that cuts chi decides by
# roundoff which member it keeps: after stages 2, 4, ..., 32 a change of t1
# by 1e-13 moved the chi=64 stage's energies by 1e-6 and its first update
# by 1e-4 on a CPU; the stage from the product state moves by 1e-13
HALDANE_CYLINDER = MODEL_CASES['haldane_cylinder'][2]
HALDANE_INIT = ['full', 'empty'] * 3
HALDANE_RAMPS = {
    'chi16': {'chi_max': 16, 'chi_list': [[8, 1], [16, 2]],
              'svd_min': 1e-10, 'lanczos_K': 10, 'lanczos_K_seam': 60,
              'multiple': 8, 'backend': 'svd'},
    'chi64': {'chi_max': 64, 'chi_list': [[64, 2]], 'svd_min': 1e-10,
              'lanczos_K': 10, 'lanczos_K_seam': 60, 'n_sweeps': 2,
              'settle_sweeps': 0, 'backend': 'svd'},
}


def haldane_ramp(package, case):
    """``device_ramp`` of the Haldane cylinder (``tenpy_tpu`` op by op,
    jit off; the port on the CPU): the energies of every sweep, of every
    update of each stage's first sweep, the stages and the charge-unit
    rescale."""
    import contextlib
    m = make_model(package, 'haldane_cylinder')
    mps = _pkg(package, 'networks.mps')
    pd = _pkg(package, 'algorithms.packed_dmrg')
    psi = mps.MPS.from_product_state(m.lat.mps_sites(), HALDANE_INIT,
                                     bc='infinite')
    upd, gauges = [], []
    orig_update, orig_setup = (pd.DeviceSweepEngine._update,
                               pd.DeviceSweepEngine._setup)

    def recording_update(self, *args, **kw):
        # tenpy_tpu's update returns its energy; the port keeps them in
        # sweep_stats['update_E0']
        E0, err = orig_update(self, *args, **kw)
        upd.append(float(E0))
        return E0, err

    def recording_setup(self):
        orig_setup(self)
        gauges.append(getattr(self, '_gauge_info', None)
                      or getattr(self, 'gauge', None))

    if package == 'jax':
        pd.DeviceSweepEngine._update = recording_update
    pd.DeviceSweepEngine._setup = recording_setup
    t0 = time.time()
    try:
        if package == 'jax':
            import jax
            ctx = jax.disable_jit()
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            kw = {} if package == 'jax' else {'device': 'cpu'}
            eng = pd.device_ramp(psi, m, dict(HALDANE_RAMPS[case]), **kw)
    finally:
        pd.DeviceSweepEngine._update = orig_update
        pd.DeviceSweepEngine._setup = orig_setup
    st = eng.sweep_stats
    n_upd = 2 * psi.L
    # the stages as device_ramp makes them (tenpy_tpu keeps no record)
    opts = HALDANE_RAMPS[case]
    stages = opts.get('chi_list')
    if stages is None:
        stages, c = [], 1
        while 2 * c < opts['chi_max']:
            c *= 2
            stages.append((c, opts['sweeps_per_stage']))
        stages.append((opts['chi_max'], opts['sweeps_per_stage']))
    n_sw = [n for _, n in stages[:-1]] + [max(stages[-1][1],
                                              opts.get('n_sweeps', 0))]
    first = list(np.cumsum([0] + n_sw[:-1]))
    if package != 'jax':
        upd = [float(e) for sweep in st['update_E0'] for e in sweep]
    k = gauges[0]['k'] if gauges and gauges[0] is not None else None
    out = {'sweep_E': np.asarray(st['E'], float),
           'stage_chi': np.asarray([c for c, _ in stages]),
           'stage_first': np.asarray(first),
           'stage_update_E0': np.asarray([upd[f * n_upd:(f + 1) * n_upd]
                                          for f in first]),
           'gauge_k': np.asarray(k if k is not None else [1]),
           'N': np.real(np.asarray(psi.expectation_value('N'))),
           'seconds': np.asarray(time.time() - t0),
           'options': np.array(json.dumps(HALDANE_RAMPS[case])),
           'model': np.array(json.dumps(HALDANE_CYLINDER))}
    return {f'ramp.{case}.{key}': v for key, v in out.items()}


def write_models(path, cases):
    """Write :func:`models_reference` into ``path``; of the Haldane ramps
    only ``cases`` run (tenpy_tpu op by op: about 6 min for 'chi16', much
    longer for 'chi64'), the others are kept from an existing file."""
    old = exchange.load_flat(path) if os.path.exists(path) else {}
    flat = models_reference([c for c in cases if c in HALDANE_RAMPS])
    for case in HALDANE_RAMPS:
        if case not in cases:
            flat.update({k: v for k, v in old.items()
                         if k.startswith(f'ramp.{case}.')})
    exchange.save_flat(path, flat)
    print(f"wrote {path} ({os.path.getsize(path) / 1e6:.3f} MB)", flush=True)


def models_reference(ramps=tuple(HALDANE_RAMPS)):
    """tenpy_tpu's values of every case of the model layer, with the
    Haldane ramps ``ramps``."""
    t0 = time.time()
    flat = sites_case('jax')
    flat.update(lattices_case('jax'))
    flat.update(terms_case('jax'))
    for case in MODEL_CASES:
        flat.update(model_case('jax', case))
    for case in MODEL_ED_CASES:
        flat.update(ed_case('jax', case))
    for case in dsl_models('jax'):
        flat.update(dsl_case('jax', case))
    print(f"sites, lattices, terms, models: {time.time() - t0:.1f} s",
          flush=True)
    t0 = time.time()
    E, psi = haldane_dmrg('jax')
    flat['dmrg.E'] = np.asarray(E)
    flat.update(state_flat('dmrg.psi', psi))
    flat.update(spectrum_case('jax', psi))
    print(f"Haldane 2x2 DMRG: E={E!r} ({time.time() - t0:.1f} s)",
          flush=True)
    for case in ramps:
        t0 = time.time()
        res = haldane_ramp('jax', case)
        flat.update(res)
        print(f"Haldane ramp {case}: E={res[f'ramp.{case}.sweep_E']} "
              f"({time.time() - t0:.1f} s)", flush=True)
    return flat


# ------------------------------------------------ mixed_xk and dipoles
XK_REF = os.path.join(_ROOT, 'tests', 'benchmark_data', 'xk_reference.npz')
TOL_W = 1e-14


def check_flat(out, ref, prefix, tol=TOL_W):
    """Every value of ``ref`` under ``prefix`` against the port's ``out``
    (the same keys): strings and integers exactly, floats to ``tol``
    relative to the largest entry (at least 1)."""
    keys = sorted(k for k in ref if k.startswith(prefix + '.'))
    assert keys and sorted(out) == keys
    for k in keys:
        a, b = np.asarray(out[k]), ref[k]
        if b.dtype.kind in 'US':
            assert str(a) == str(b), k
        elif b.dtype.kind in 'biu':
            assert a.shape == b.shape and np.array_equal(a, b), k
        else:
            assert a.shape == b.shape, k
            scale = max(1., float(np.abs(b).max(initial=0.)))
            assert np.abs(a - b).max(initial=0.) <= tol * scale, k


def _leg_flat(prefix, leg):
    return {f'{prefix}.slices': np.asarray(leg.slices),
            f'{prefix}.charges': np.asarray(leg.charges),
            f'{prefix}.qconj': np.asarray(leg.qconj),
            f'{prefix}.mod': np.asarray(leg.chinfo.mod),
            f'{prefix}.names': _js(list(leg.chinfo.names))}


def _array_flat(prefix, a):
    out = {f'{prefix}.dense': _arr(a), f'{prefix}.qtotal': np.asarray(
        a.qtotal)}
    for k, leg in enumerate(a.legs):
        out.update(_leg_flat(f'{prefix}.leg{k}', leg))
    return out


def dipole_charges_case(package):
    """``DipolarChargeInfo`` (shifts, equality, the checks of its moduli),
    the ``ChargeInfo`` and ``LegCharge`` charge mappings and ``Array``'s
    ``add_charge``, ``drop_charge`` and ``change_charge``."""
    ch = _pkg(package, 'linalg.charges')
    S = _pkg(package, 'networks.site')
    ci = ch.DipolarChargeInfo([1, 1], ['2*Sz', 'dipole'], charge_idcs=[0],
                              dipole_idcs=[1])
    ci_zn = ch.DipolarChargeInfo([4, 2], ['q', 'p'], [0], [1])
    q = np.array([[2, 0], [-2, 0], [0, 3]])
    out = {'shift_h': ci.shift_charges_horizontal(q, 5),
           'shift': ci.shift_charges(q, np.array([5, 0])),
           'shift_zn': ci_zn.shift_charges(np.array([[1, 0], [3, 1]]),
                                           np.array([3, 0])),
           'trivial_shift': np.array([ci.trivial_shift,
                                      ch.ChargeInfo([1]).trivial_shift]),
           'eq': np.array([
               ci == ch.ChargeInfo([1, 1], ['2*Sz', 'dipole']),
               ci == ch.DipolarChargeInfo([1, 1], ['a', 'b'], [0], [1]),
               ci == ci_zn, ci == ch.DipolarChargeInfo([1, 1], None, [1],
                                                       [0])]),
           'repr': np.array(repr(ci))}
    raised = []
    for args in (([3, 2], None, [0], [1]), ([1, 1], None, [0], [0]),
                 ([1, 1], None, [0], [1], [1]), ([1, 1], None, [2], [1])):
        try:
            ch.DipolarChargeInfo(*args)
            raised.append(False)
        except ValueError:
            raised.append(True)
    out['raises'] = np.array(raised)
    ci2 = ch.ChargeInfo([1, 3], ['a', 'b'])
    leg = ch.LegCharge.from_qflat(ci2, [[1, 0], [1, 2], [-1, 1], [0, 0]])
    leg_c = ch.LegCharge.from_qflat(ch.ChargeInfo([2], ['c']),
                                    [[0], [1], [1], [1]])
    legs = {'add': ch.LegCharge.from_add_charge([leg, leg_c]),
            'drop_a': ch.LegCharge.from_drop_charge(leg, 'a'),
            'drop_1': ch.LegCharge.from_drop_charge(leg, 1),
            'drop_all': ch.LegCharge.from_drop_charge(leg),
            'change': ch.LegCharge.from_change_charge(leg, 'b', 2, 'b2'),
            'flip': leg.flip_charges_qconj(),
            'extend': leg.extend(2, [1, 1]),
            'qind': ch.LegCharge.from_qind(ci2, [0, 2, 3], [[1, 1], [0, 2]],
                                           -1)}
    dip_leg = ch.LegCharge.from_qflat(ci, [[2, 0], [0, 0], [-2, 0]])
    legs['mapped'] = dip_leg.apply_charge_mapping(ci.shift_charges,
                                                  {'dx': np.array([3, 0])})
    for name, l in legs.items():
        out.update(_leg_flat(f'leg.{name}', l))
    for name, c in (('add', ch.ChargeInfo.add([ci2, ch.ChargeInfo([2],
                                                                  ['c'])])),
                    ('drop', ch.ChargeInfo.drop(ci2, 'a')),
                    ('change', ch.ChargeInfo.change(ci2, 1, 5, 'x'))):
        out[f'chinfo.{name}'] = _js([list(c.mod), list(c.names)])
    Sp = S.SpinSite(1., 'Sz').Sp
    par = ch.LegCharge.from_qflat(ch.ChargeInfo([2], ['par']), [0, 1, 0])
    arrays = {'add': Sp.add_charge([par, par.conj()]),
              'drop': Sp.add_charge([par, par.conj()]).drop_charge(0),
              'drop_name': Sp.add_charge([par, par.conj()]).drop_charge(
                  'par'),
              'drop_all': Sp.drop_charge(),
              'change': Sp.change_charge(0, 4, 'Z4')}
    for name, a in arrays.items():
        out.update(_array_flat(f'array.{name}', a))
    return {f'charges.{k}': v for k, v in out.items()}


def dipole_sites_case(package):
    """The dipolar sites and a dipolar chain's position-shifted
    ``mps_sites``."""
    S = _pkg(package, 'networks.site')
    spins = _pkg(package, 'models.spins')
    flat = {}
    for name, site in (('spin1', S.SpinSite(1., 'dipole')),
                       ('spin_half', S.SpinSite(0.5, 'dipole')),
                       ('boson', S.BosonSite(2, 'dipole'))):
        flat.update(site_flat(f'dsites.{name}', site))
    m = spins.DipolarSpinChain({'L': 6, 'S': 1, 'conserve': 'dipole'})
    for i, site in enumerate(m.lat.mps_sites()):
        flat[f'dsites.mps.{i}'] = site.leg.to_qflat()
        flat[f'dsites.mps_Sp.{i}'] = np.asarray(site.Sp.qtotal)
    return flat


HELICAL_MULTI = [('Sz', [0, 0], 0), ('Sz', [1, 0], 0), ('Sz', [0, 1], 0)]


def dipole_lattices_case(package):
    """``IrregularLattice`` and ``HelicalLattice``: orders, index maps,
    couplings, and the helix enlarged."""
    La = _pkg(package, 'models.lattice')
    S = _pkg(package, 'networks.site')
    s = S.SpinHalfSite(None)
    out = {}
    reg = La.Square(3, 3, s)
    irr = La.IrregularLattice(reg, remove=[[1, 1, 0], [2, 0, 0]])
    irr.test_sanity()
    out['irr.order'] = np.asarray(irr.order)
    out['irr.N_sites'] = np.asarray(irr.N_sites)
    out['irr.fix_u'] = np.asarray(irr.mps_idx_fix_u(0))
    out['irr.n_mps_sites'] = np.asarray(len(irr.mps_sites()))
    reg = La.Square(3, 3, s, bc=['periodic', -1], bc_MPS='infinite')
    hel = La.HelicalLattice(reg, 3)
    hel.test_sanity()
    out['hel.order'] = np.asarray(hel.order)
    out['hel.N_sites'] = np.asarray(hel.N_sites)
    out['hel.mps2lat'] = np.asarray(hel.mps2lat_idx(np.arange(7)))
    out['hel.lat2mps'] = np.asarray(hel.lat2mps_idx(
        np.array([[1, 2, 0], [2, 2, 0], [0, 1, 0]])))
    for key, entries in hel.pairs.items():
        for n, (u1, u2, dx) in enumerate(entries):
            i, j, lat_idx, shape = hel.possible_couplings(u1, u2, dx)
            for k, v in (('i', i), ('j', j), ('lat', lat_idx),
                         ('shape', np.asarray(shape))):
                out[f'hel.pc.{key}.{n}.{k}'] = np.asarray(v)
    ijkl, lat_idx, shape = hel.possible_multi_couplings(
        [(op, np.array(dx), u) for op, dx, u in HELICAL_MULTI])
    out['hel.multi.ijkl'] = np.asarray(ijkl)
    out['hel.multi.lat'] = np.asarray(lat_idx)
    big = hel.enlarge_mps_unit_cell(3)
    if big is None:          # tenpy_tpu enlarges in place
        big = hel
    out['hel.enlarged.order'] = np.asarray(big.order)
    out['hel.enlarged.N_sites'] = np.asarray(big.N_sites)
    return {f'lattices.{k}': v for k, v in out.items()}


DIPOLE_MODEL_CASES = {
    'dipolar_spin': ('spins', 'DipolarSpinChain', {
        'L': 8, 'S': 1, 'J3': 1., 'J4': 0.3, 'conserve': 'dipole'}),
    'dipolar_spin_sz': ('spins', 'DipolarSpinChain', {
        'L': 6, 'S': 1, 'J3': 1., 'J4': 0., 'conserve': 'Sz'}),
    'dipolar_spin_half': ('spins', 'DipolarSpinChain', {
        'L': 5, 'S': 0.5, 'J3': 0.7, 'J4': 0.2}),
    'dipolar_boson': ('hubbard', 'DipolarBoseHubbardChain', {
        'L': 6, 'Nmax': 2, 't': 1., 'U': 2., 'mu': 0.5, 't4': 0.2,
        'conserve': 'dipole'}),
    'xxz2': ('xxz_chain', 'XXZChain2', {'L': 6, 'Jxx': 1., 'Jz': 0.7,
                                        'hz': 0.1}),
    'xxz2_infinite': ('xxz_chain', 'XXZChain2', {
        'L': 2, 'Jxx': 1., 'Jz': 0.7, 'hz': 0.1, 'bc_MPS': 'infinite'}),
}
XK_MODEL_CASES = {
    'spinless_xk': ('mixed_xk', 'SpinlessMixedXKSquare', {
        'Lx': 2, 'Ly': 3, 't': 1., 'V': 0.5, 'bc_MPS': 'finite'}),
    'spinless_xk_nok': ('mixed_xk', 'SpinlessMixedXKSquare', {
        'Lx': 2, 'Ly': 2, 't': 1., 'V': 0.5, 'bc_MPS': 'finite',
        'conserve_k': False}),
    'spinless_xk_inf': ('mixed_xk', 'SpinlessMixedXKSquare', {
        'Lx': 1, 'Ly': 2, 't': 1., 'V': 1., 'bc_MPS': 'infinite'}),
    'hubbard_xk': ('mixed_xk', 'HubbardMixedXKSquare', {
        'Lx': 1, 'Ly': 2, 't': 1., 'U': 2.5, 'bc_MPS': 'finite'}),
    # the chip smoke's phase-17a cell
    'hubbard_xk_cylinder': ('mixed_xk', 'HubbardMixedXKSquare', {
        'Lx': 2, 'Ly': 4, 't': 1., 'U': 8., 'bc_MPS': 'infinite'}),
    'molecular': ('molecular', 'MolecularModel', None),
}


def molecular_params(seed=5, norb=3):
    """tests/test_molecular.py's integrals: a symmetric one-body tensor
    and a two-body tensor with the real-orbital symmetries, from
    ``seed``."""
    rng = np.random.default_rng(seed)
    h1 = rng.normal(size=(norb, norb))
    h2 = rng.normal(size=(norb,) * 4)
    perms = [(0, 1, 2, 3), (1, 0, 3, 2), (2, 3, 0, 1), (3, 2, 1, 0),
             (1, 0, 2, 3), (0, 1, 3, 2), (2, 3, 1, 0), (3, 2, 0, 1)]
    return {'one_body_tensor': (h1 + h1.T) / 2,
            'two_body_tensor': sum(h2.transpose(p) for p in perms) / 8,
            'constant': 0.37, 'cons_N': 'N', 'cons_Sz': 'Sz'}


def make_case_model(package, cases, case):
    module, cls, params = cases[case]
    params = molecular_params() if params is None else dict(params)
    return getattr(_pkg(package, 'models.' + module), cls)(params)


def case_model_flat(package, cases, case):
    """:func:`model_flat` and the physical legs of a case's model."""
    m = make_case_model(package, cases, case)
    flat = model_flat(f'model.{case}', m)
    for i, site in enumerate(m.lat.mps_sites()):
        flat[f'model.{case}.p.{i}'] = site.leg.to_qflat()
    return flat


# conversions between H_bond and H_MPO, on (module, class, params)
CONVERSION_CASES = {
    'xxz': ('xxz_chain', 'XXZChain', {'L': 6, 'Jxx': 1., 'Jz': 0.7,
                                      'hz': 0.1}),
    'xxz_infinite': ('xxz_chain', 'XXZChain', {
        'L': 2, 'Jxx': 1., 'Jz': 0.7, 'hz': 0.1, 'bc_MPS': 'infinite'}),
    'tfi': ('tf_ising', 'TFIChain', {'L': 5, 'J': 1., 'g': 1.3,
                                     'conserve': None}),
    'spin_one_infinite': ('spins', 'SpinChain', {
        'L': 2, 'S': 1., 'Jz': 0.5, 'hz': 0.2, 'D': 0.3,
        'bc_MPS': 'infinite'}),
}


def conversion_case(package, case):
    """``calc_H_bond_from_MPO`` of the model's MPO, ``from_MPOModel`` and
    ``calc_H_MPO_from_bond`` (its dense Hamiltonian for finite bc, its own
    bond terms for infinite bc)."""
    mdl = _pkg(package, 'models.model')
    m = make_case_model(package, CONVERSION_CASES, case)
    pre = f'conv.{case}'
    flat = {}
    mm = mdl.MPOModel(m.lat, m.H_MPO)
    for i, h in enumerate(mm.calc_H_bond_from_MPO()):
        if h is not None:
            flat[f'{pre}.from_mpo.{i}'] = _arr(h.transpose(
                ['p0', 'p0*', 'p1', 'p1*']))
    nn = mdl.NearestNeighborModel.from_MPOModel(mm)
    for i, h in enumerate(nn.H_bond):
        if h is not None:
            flat[f'{pre}.nn.{i}'] = _arr(h.transpose(
                ['p0', 'p0*', 'p1', 'p1*']))
    H2 = nn.calc_H_MPO_from_bond()
    flat[f'{pre}.mpo_chi'] = np.asarray(H2.chi)
    if m.lat.bc_MPS == 'finite':
        ed = _pkg(package, 'algorithms.exact_diag')
        flat[f'{pre}.dense'] = np.asarray(ed.get_numpy_Hamiltonian(
            mdl.MPOModel(m.lat, H2)))
    else:
        back = mdl.MPOModel(m.lat, H2).calc_H_bond_from_MPO()
        for i, h in enumerate(back):
            flat[f'{pre}.back.{i}'] = _arr(h.transpose(
                ['p0', 'p0*', 'p1', 'p1*']))
    return flat


DIPOLE_DMRG = {'trunc_params': {'chi_max': 50, 'svd_min': 1e-12},
               'max_sweeps': 20, 'mixer': True, 'N_sweeps_check': 2}
DIPOLE_SPIN = {'L': 8, 'S': 1, 'J3': 1., 'J4': 0.}
DIPOLE_BOSON = {'L': 6, 'Nmax': 2, 't': 1., 'U': 2., 'mu': 0.5,
                'conserve': 'dipole'}
DIPOLE_BOSON_INIT = ['1', '2', '0'] * 2


def dipole_dmrg(package, which):
    """tests/test_dipole.py's finite runs: ``(E, psi)`` of ``dmrg.run``
    on the dipolar S=1 chain with 'dipole' or 'Sz' conserved, or on the
    dipolar Bose-Hubbard chain."""
    import copy
    mps = _pkg(package, 'networks.mps')
    dmrg = _pkg(package, 'algorithms.dmrg')
    if which == 'boson':
        m = _pkg(package, 'models.hubbard').DipolarBoseHubbardChain(
            dict(DIPOLE_BOSON))
        init = DIPOLE_BOSON_INIT
    else:
        m = _pkg(package, 'models.spins').DipolarSpinChain(
            dict(DIPOLE_SPIN, conserve=which))
        init = ['up', 'down'] * (DIPOLE_SPIN['L'] // 2)
    psi = mps.MPS.from_product_state(m.lat.mps_sites(), init, bc='finite')
    kw = {} if package == 'jax' else {'device': 'cpu'}
    E = dmrg.run(psi, m, copy.deepcopy(DIPOLE_DMRG), **kw)['E']
    return float(np.real(E)), psi


def dipole_infinite_raises(package):
    try:
        _pkg(package, 'models.spins').DipolarSpinChain(
            {'L': 4, 'S': 1, 'conserve': 'dipole', 'bc_MPS': 'infinite'})
    except NotImplementedError:
        return True
    return False


# ED spectra: the x-k models and their real-space counterparts
XK_ED_CASES = {
    'spinless': ({'Lx': 2, 'Ly': 3, 't': 1., 'V': 0.5, 'bc_MPS': 'finite'},
                 ('fermions_spinless', 'FermionModel', {
                     'lattice': 'Square', 'Lx': 2, 'Ly': 3,
                     'bc_y': 'cylinder', 'bc_MPS': 'finite', 'J': 1.,
                     'V': 0.5, 'mu': 0., 'conserve': 'N'})),
    'hubbard': ({'Lx': 1, 'Ly': 2, 't': 1., 'U': 2.5, 'bc_MPS': 'finite'},
                ('hubbard', 'FermiHubbardModel', {
                    'lattice': 'Square', 'Lx': 1, 'Ly': 2,
                    'bc_y': 'cylinder', 'bc_MPS': 'finite', 't': 1.,
                    'U': 2.5})),
}


def xk_ed_case(package, case):
    """The full spectra of an x-k model and of its real-space form."""
    xk = _pkg(package, 'models.mixed_xk')
    ed = _pkg(package, 'algorithms.exact_diag')
    params, (module, cls, rparams) = XK_ED_CASES[case]
    m = (xk.SpinlessMixedXKSquare if case == 'spinless'
         else xk.HubbardMixedXKSquare)(dict(params))
    real = getattr(_pkg(package, 'models.' + module), cls)(dict(rparams))
    return {f'xk_ed.{case}.xk': np.linalg.eigvalsh(np.asarray(
                ed.get_numpy_Hamiltonian(m))),
            f'xk_ed.{case}.real': np.linalg.eigvalsh(np.asarray(
                ed.get_numpy_Hamiltonian(real)))}


def molecular_ed(package):
    """The molecular model's spectrum from its MPO."""
    ed = _pkg(package, 'algorithms.exact_diag')
    m = make_case_model(package, XK_MODEL_CASES, 'molecular')
    return np.linalg.eigvalsh(np.asarray(ed.get_numpy_Hamiltonian(m)))


# tests/test_mixed_xk.py's 3x3 spinless cylinder, at chi 64
XK_3X3 = {'Lx': 3, 'Ly': 3, 't': 1., 'V': 0.8, 'bc_MPS': 'finite',
          'conserve_k': True}
XK_3X3_DMRG = {'trunc_params': {'chi_max': 64, 'svd_min': 1e-12},
               'max_sweeps': 30, 'mixer': True}


def xk_3x3_dmrg(package):
    """``(E, psi, model)``: ``dmrg.run`` on the 3x3 spinless x-k cylinder
    from the (N=3, ky=0) product state."""
    import copy
    xk = _pkg(package, 'models.mixed_xk')
    mps = _pkg(package, 'networks.mps')
    dmrg = _pkg(package, 'algorithms.dmrg')
    m = xk.SpinlessMixedXKSquare(dict(XK_3X3))
    state = ['empty'] * 9
    for x in range(3):
        state[int(m.lat.lat2mps_idx([x, 0]))] = 'full'
    psi = mps.MPS.from_product_state(m.lat.mps_sites(), state, bc='finite')
    kw = {} if package == 'jax' else {'device': 'cpu'}
    E = dmrg.run(psi, m, copy.deepcopy(XK_3X3_DMRG), **kw)['E']
    return float(np.real(E)), psi, m


def xk_measurements(m, psi):
    """The ``real_to_mixed_*`` measurements of tests/test_mixed_xk.py on
    ``psi``: density, density-density and ``<Cd C>``."""
    one = np.ones((1, 1))
    tls = {'onsite': m.real_to_mixed_onsite(one, (1, 2)),
           'two_site': m.real_to_mixed_two_site(one, (0, 0), one, (1, 1)),
           'n_site': m.real_to_mixed_n_site([one, one, one],
                                            [(0, 0), (1, 1), (2, 2)]),
           'any': m.real_to_mixed_correlations_any(
               ['Cd', 'C'], [(1., [0, 0])], [(0, 0), (1, 1)])}
    out = {}
    for name, tl in tls.items():
        val, terms = psi.expectation_value_terms_sum(tl)
        out[f'meas.{name}'] = np.asarray(val)
        out[f'meas.{name}.terms'] = np.asarray(terms)
        out[f'meas.{name}.strength'] = np.asarray(tl.strength)
        out[f'meas.{name}.sites'] = np.array(
            [[i for _, i in t] for t in tl.terms])
    return out


XK_IDMRG = {'Lx': 1, 'Ly': 2, 'bc_MPS': 'infinite', 't': 1., 'V': 1.}
XK_IDMRG_OPTIONS = {'trunc_params': {'chi_max': 32, 'svd_min': 1e-12},
                    'max_sweeps': 6, 'min_sweeps': 6, 'mixer': True,
                    'mixer_params': {'disable_after': 3},
                    'N_sweeps_check': 1, 'mixer_env_reseed': 'tm'}


def xk_idmrg(package):
    """The Ly=2 infinite spinless x-k cylinder by iDMRG with the mixer
    off after three sweeps and the environments re-seeded from the
    transfer matrix: every sweep's energy, the final chi."""
    import copy
    xk = _pkg(package, 'models.mixed_xk')
    mps = _pkg(package, 'networks.mps')
    dmrg = _pkg(package, 'algorithms.dmrg')
    m = xk.SpinlessMixedXKSquare(dict(XK_IDMRG))
    L = m.lat.N_sites
    psi = mps.MPS.from_product_state(m.lat.mps_sites(),
                                     (['full', 'empty'] * L)[:L],
                                     bc='infinite')
    kw = {} if package == 'jax' else {'device': 'cpu'}
    eng = dmrg.TwoSiteDMRGEngine(psi, m, copy.deepcopy(XK_IDMRG_OPTIONS),
                                 **kw)
    E, _ = eng.run()
    return {'idmrg.E': np.asarray(eng.sweep_stats['E'], float),
            'idmrg.E_run': np.asarray(float(np.real(E))),
            'idmrg.chi': np.asarray(psi.chi)}


HELICAL_TFI = {'J': 1., 'g': 2., 'conserve': None, 'bc_MPS': 'infinite'}
HELICAL_DMRG = {'trunc_params': {'chi_max': 16, 'svd_min': 1e-10},
                'mixer': True, 'N_sweeps_check': 1}
HELICAL_SWEEPS = 8


def helical_models(package):
    """The TFI model on the 3-cell helix and on its regular 3x3
    lattice."""
    La = _pkg(package, 'models.lattice')
    S = _pkg(package, 'networks.site')
    tf = _pkg(package, 'models.tf_ising')
    reg = La.Square(3, 3, S.SpinHalfSite(None), bc=['periodic', -1],
                    bc_MPS='infinite')
    hel = La.HelicalLattice(reg, 3)
    return (tf.TFIModel(dict(HELICAL_TFI, lattice=hel)),
            tf.TFIModel(dict(HELICAL_TFI, lattice=reg)))


def helical_case(package):
    """The helical TFI model's MPO and its iDMRG from all up: the energy
    of each of ``HELICAL_SWEEPS`` iterations of the engine (sweep and
    statistics; the run's final canonical form, the same in both
    packages, left out for its cost)."""
    import copy
    mps = _pkg(package, 'networks.mps')
    dmrg = _pkg(package, 'algorithms.dmrg')
    m, _ = helical_models(package)
    flat = mpo_flat('helical.mpo', m.H_MPO)
    psi = mps.MPS.from_product_state(m.lat.mps_sites(), ['up'] * 3,
                                     bc='infinite')
    kw = {} if package == 'jax' else {'device': 'cpu'}
    eng = dmrg.TwoSiteDMRGEngine(psi, m, copy.deepcopy(HELICAL_DMRG), **kw)
    eng.pre_run_initialize()
    for _ in range(HELICAL_SWEEPS):
        eng.run_iteration()
    flat['helical.sweep_E'] = np.asarray(eng.sweep_stats['E'], float)
    flat['helical.chi'] = np.asarray(psi.chi)
    return flat


def xk_reference():
    """tenpy_tpu's values for tests/test_torch_mixed_xk.py and
    tests/test_torch_dipole.py."""
    t0 = time.time()
    flat = dipole_charges_case('jax')
    flat.update(dipole_sites_case('jax'))
    flat.update(dipole_lattices_case('jax'))
    for cases in (DIPOLE_MODEL_CASES, XK_MODEL_CASES):
        for case in cases:
            flat.update(case_model_flat('jax', cases, case))
    for case in CONVERSION_CASES:
        flat.update(conversion_case('jax', case))
    for case in XK_ED_CASES:
        flat.update(xk_ed_case('jax', case))
    flat['molecular.ed'] = molecular_ed('jax')
    flat['dipole.infinite_raises'] = np.asarray(dipole_infinite_raises(
        'jax'))
    print(f"charges, sites, lattices, models, spectra: "
          f"{time.time() - t0:.1f} s", flush=True)
    for which in ('dipole', 'Sz', 'boson'):
        t0 = time.time()
        E, psi = dipole_dmrg('jax', which)
        flat[f'dipole_dmrg.{which}.E'] = np.asarray(E)
        flat.update(state_flat(f'dipole_dmrg.{which}.psi', psi))
        print(f"dipolar DMRG {which}: E={E!r} ({time.time() - t0:.1f} s)",
              flush=True)
    t0 = time.time()
    E, psi, m = xk_3x3_dmrg('jax')
    flat['xk_3x3.E'] = np.asarray(E)
    flat.update(state_flat('xk_3x3.psi', psi))
    flat.update({f'xk_3x3.{k}': v for k, v in xk_measurements(m, psi).items()})
    print(f"3x3 x-k DMRG: E={E!r} ({time.time() - t0:.1f} s)", flush=True)
    t0 = time.time()
    flat.update({f'xk.{k}': v for k, v in xk_idmrg('jax').items()})
    print(f"x-k iDMRG: E={flat['xk.idmrg.E']} ({time.time() - t0:.1f} s)",
          flush=True)
    t0 = time.time()
    flat.update(helical_case('jax'))
    print(f"helical: E={flat['helical.sweep_E']} ({time.time() - t0:.1f} s)",
          flush=True)
    return flat


# the one-sided Jacobi SVD (tests/test_torch_jacobi.py): one ragged list of
# groups (N, R, C), tall, wide, odd C tall and wide, and a square-ish one,
# with rank-deficient entries (zero rows and columns, as a padded sector of
# tests/test_packed_complex.py) and one with equal singular values; the
# split of tests/test_torch_split_backends.py's theta at its chi and svd_min
JACOBI_GROUPS = ((3, 14, 8), (3, 8, 14), (3, 12, 9), (3, 9, 13), (3, 16, 12))
JACOBI_BACKENDS = ('jacobi', 'jacobi32')
JACOBI_CHI, JACOBI_SVD_MIN, JACOBI_THETA_SEED = 20, 1e-10, 10


def jacobi_groups(complex_):
    """The seeded groups of the Jacobi tests (numpy, f64 or complex128)."""
    rng = np.random.default_rng(17 + int(complex_))
    Ms = []
    for shape in JACOBI_GROUPS:
        M = rng.standard_normal(shape)
        if complex_:
            M = M + 1j * rng.standard_normal(shape)
        Ms.append(M)
    Ms[0][2, 5:, :] = 0.            # tall, rank 5 < 8 columns
    Ms[1][0, 4:, :] = 0.            # wide, rank 4 < 8 rows
    Ms[4][1, :, 8:] = 0.            # zero columns and rows
    Ms[4][1, 10:, :] = 0.
    Ms[2][0] = np.linalg.qr(Ms[2][0])[0]    # nine singular values 1
    return Ms


def jacobi_reference():
    """tenpy_tpu's values for tests/test_torch_jacobi.py: the singular
    values of ``_decomp_jacobi`` per group, and ``split_truncate``'s S,
    err, n_kept and A S B with both Jacobi backends."""
    from tenpy_tpu.linalg import packed as jpk
    from tenpy_tpu.linalg import packed_split as jps
    from test_torch_split_backends import _theta
    flat = {}
    t0 = time.time()
    for complex_ in (False, True):
        tag = 'c128' if complex_ else 'f64'
        for g, M in enumerate(jacobi_groups(complex_)):
            flat[f'decomp.{tag}.{g}.M'] = M
            for backend in JACOBI_BACKENDS:
                kw = {'M_im': M.imag} if complex_ else {}
                _, S, _ = jps._decomp_jacobi(
                    M.real, bulk_f32=backend == 'jacobi32', **kw)
                flat[f'decomp.{tag}.{backend}.{g}.S'] = np.asarray(S)
        thp = jpk.pack(_theta(JACOBI_THETA_SEED, complex_), multiple=8,
                       pad_labels=('vL', 'vR'))
        bond = jps.bond_layout(thp.legs, thp.qtotal, [0, 0], multiple=8)
        plan = jps.split_plan(thp, bond, [0, 0], group_multiple=8)
        for backend in JACOBI_BACKENDS:
            A, S, B, err, _, n = jps.split_truncate(
                thp, plan, JACOBI_CHI, JACOBI_SVD_MIN, backend=backend)
            rec = jpk.tensordot(jps.scale_bond(A, S,
                                               jps.scale_bond_plan(A, 'vR')),
                                B, axes=(['vR'], ['vL']))
            key = f'split.{tag}.{backend}'
            flat[f'{key}.S'] = np.asarray(S)
            flat[f'{key}.err'] = np.asarray(float(err))
            flat[f'{key}.n'] = np.asarray(int(n))
            flat[f'{key}.rec'] = np.asarray(jpk.unpack(rec).to_numpy())
    print(f"Jacobi decompositions and splits: {time.time() - t0:.1f} s",
          flush=True)
    return flat


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--write',
                    help='output .npz path (chi=256 Hubbard cylinder)')
    ap.add_argument('--write-ramps',
                    help='output .npz path (device_ramp references)')
    ap.add_argument('--write-small',
                    help='output .npz path (chi=16 Ly=2 cylinder state)')
    ap.add_argument('--write-write-back',
                    help='output .npz path (write-back references)')
    ap.add_argument('--write-hofstadter',
                    help='output .npz path (Hofstadter references)')
    ap.add_argument('--write-tebd',
                    help='output .npz path (DeviceTEBDEngine references)')
    ap.add_argument('--write-states',
                    help='output .npz path (written-back JAX states)')
    ap.add_argument('--write-host-dmrg',
                    help='output .npz path (dmrg.run references)')
    ap.add_argument('--write-ramp-drift',
                    help='output .npz path (the ramp write-back drift)')
    ap.add_argument('--write-simulation',
                    help='output .npz path (simulation references)')
    ap.add_argument('--write-time-evolution',
                    help='output .npz path (time-evolution references)')
    ap.add_argument('--write-vumps',
                    help='output .npz path (VUMPS references)')
    ap.add_argument('--write-purification',
                    help='output .npz path (purification references)')
    ap.add_argument('--write-excitations',
                    help='output .npz path (excitation references)')
    ap.add_argument('--write-segment',
                    help='output .npz path (segment references)')
    ap.add_argument('--write-models',
                    help='output .npz path (model-layer references)')
    ap.add_argument('--write-xk-models',
                    help='output .npz path (mixed_xk and dipole '
                         'references)')
    ap.add_argument('--write-jacobi',
                    help='output .npz path (one-sided Jacobi references)')
    ap.add_argument('--cases', nargs='+',
                    help='write-back, Hofstadter or Haldane-ramp cases to '
                         '(re)compute')
    args = ap.parse_args(argv)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    if args.write_ramps:
        write_ramps(args.write_ramps)
    if args.write_small:
        write_small(args.write_small)
    if args.write_write_back:
        write_write_back(args.write_write_back, args.cases
                         or ['chi256'] + list(WRITE_BACK_CASES))
    if args.write_hofstadter:
        write_hofstadter(args.write_hofstadter,
                         args.cases or list(HOFSTADTER_CASES))
    if args.write_models:
        write_models(args.write_models, args.cases or list(HALDANE_RAMPS))
    for path, make in ((args.write_tebd, tebd_reference),
                       (args.write_states, written_back_states),
                       (args.write_host_dmrg, host_dmrg_reference),
                       (args.write_ramp_drift, ramp_drift_reference),
                       (args.write_simulation, simulation_reference),
                       (args.write_time_evolution,
                        time_evolution_reference),
                       (args.write_vumps, vumps_reference),
                       (args.write_purification, purification_reference),
                       (args.write_excitations, excitation_reference),
                       (args.write_segment, segment_reference),
                       (args.write_xk_models, xk_reference),
                       (args.write_jacobi, jacobi_reference)):
        if path:
            exchange.save_flat(path, make())
            print(f"wrote {path} ({os.path.getsize(path) / 1e6:.3f} MB)",
                  flush=True)
    if not args.write:
        return
    t0 = time.time()
    m, psi = _hubbard_chi256()
    reference, _ = jax_reference(psi, m, SMOKE_OPTIONS, SMOKE_REF_SWEEPS)
    reference['options'] = np.array(json.dumps(SMOKE_OPTIONS))
    print(f"JAX reference: {SMOKE_REF_SWEEPS} sweeps, "
          f"E={reference['sweep_E']} max_err={reference['sweep_max_err']} "
          f"seconds={reference['cpu_seconds']}", flush=True)
    flat = export_flat(psi, m, SMOKE_OPTIONS, reference=reference)
    exchange.save_flat(args.write, flat)
    print(f"wrote {args.write} ({os.path.getsize(args.write) / 1e6:.2f} MB) "
          f"in {time.time() - t0:.0f} s", flush=True)


if __name__ == '__main__':
    main()
