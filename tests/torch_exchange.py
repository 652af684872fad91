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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--write',
                    help='output .npz path (chi=256 Hubbard cylinder)')
    ap.add_argument('--write-ramps',
                    help='output .npz path (device_ramp references)')
    ap.add_argument('--write-small',
                    help='output .npz path (chi=16 Ly=2 cylinder state)')
    args = ap.parse_args(argv)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    if args.write_ramps:
        write_ramps(args.write_ramps)
    if args.write_small:
        write_small(args.write_small)
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
