"""The port's segment boundary conditions against ``tenpy_tpu``.

The cases of ``tests/test_segment.py`` and
``tests/test_topological_excitations.py``, cut to small sizes, run through
the port on the CPU from the infinite ground states ``tenpy_tpu`` made
(read from ``tests/benchmark_data/segment_reference.npz``, written by
``python tests/torch_exchange.py --write-segment``; no JAX runs here) and
are held to ``tenpy_tpu``'s runs at 1e-10: the extracted lattice, model,
MPO and MPS, the segment canonical form with its boundary rotations, the
fixed point of segment DMRG, ``OrthogonalExcitations`` of an infinite
ground state (TFI and the charged S=1 excitations), ``TopologicalExcitations``
(the TFI kink, and the Neel domain wall of the XXZ chain with both
``join_method`` values) and the charge statistics.  The projected packed
Lanczos (the card's route of an orthogonalized update, here through the
kernel's plain version on CPU tensors) is held to the host's
``LanczosGroundState`` with ``orthogonal_to``: E at 1e-10, the Ritz vector
at 1 - 1e-8 in overlap.
"""
import numpy as np
import pytest
import torch

import torch_exchange as tx
from tenpy_tpu_torch.algorithms import mps_common
from tenpy_tpu_torch.algorithms.dmrg import TwoSiteDMRGEngine
from tenpy_tpu_torch.linalg import np_conserved as npc
from tenpy_tpu_torch.linalg.krylov_based import LanczosGroundState
from tenpy_tpu_torch.models.lattice import Square
from tenpy_tpu_torch.models.tf_ising import TFIChain
from tenpy_tpu_torch.models.xxz_chain import XXZChain
from tenpy_tpu_torch.networks import exchange
from tenpy_tpu_torch.networks.mps import MPS
from tenpy_tpu_torch.networks.site import SpinHalfSite
from tenpy_tpu_torch.simulations import ground_state_search as gss

torch.set_num_threads(1)

TOL_JAX = 1e-10
# the Ritz vectors of the card's and the host's projected Lanczos
TOL_OVERLAP = 1e-8


@pytest.fixture(scope='module')
def ref():
    return exchange.load_flat(tx.SEG_REF)


def _check(out, ref, skip=()):
    """Every value of a case against tenpy_tpu's: arrays at TOL_JAX,
    strings and integers exactly."""
    for k, v in out.items():
        if k.split('.', 1)[1] in skip:
            continue
        r = ref[k]
        if r.dtype.kind in 'fc':
            assert v.shape == r.shape, k
            assert np.allclose(v, r, rtol=0, atol=TOL_JAX), \
                (k, float(np.max(np.abs(v - r))))
        else:
            assert np.array_equal(v, r), (k, v, r)


@pytest.mark.parametrize('case', ['extract', 'canon', 'fixed', 'stats'])
def test_segment_vs_jax(case, ref):
    """tests/test_segment.py:32 (the lattice, model, MPO and MPS of a
    segment; and of a 2D cylinder), :46 (segment DMRG keeps the ground
    state), :125 (canonical_form_finite on a perturbed segment, the
    environments rotated with it) and the charge statistics, at 1e-10."""
    out = tx.segment_case('torch', case, ref)
    _check(out, ref)
    if case == 'extract':
        assert np.allclose(out['extract.sigmaz'],
                           out['extract.sigmaz_inf'][0], atol=1e-10)
    elif case == 'canon':
        for key in ('small', 'big'):
            assert out[f'canon.{key}.norm_test'] < 1e-10
            assert out[f'canon.{key}.UL_is']
        # a perturbation at 1e-8 leaves the embedded energy as it was
        assert abs(out['canon.small.E_after'] - out['canon.small.E_before']) \
            < 1e-6 * abs(out['canon.small.E_before'])
    elif case == 'fixed':
        assert np.allclose(out['fixed.sigmaz'], out['fixed.sigmaz0'],
                           atol=1e-8)


def test_segment_sweeps_keep_embedding(monkeypatch, ref):
    """A DMRG run on a segment (tenpy_tpu's dmrg.py:265-272) keeps the
    start environments it was given and never calls canonical_form,
    which would rotate the boundary bases out of the embedding."""
    from tenpy_tpu_torch.networks.mpo import MPOTransferMatrix
    m = TFIChain(dict(tx.SEG_TFI))
    psi = tx.load_state(ref, 'tfi', m.lat.mps_sites())
    env_data = MPOTransferMatrix.find_init_LP_RP(m.H_MPO, psi)
    m_seg = m.extract_segment(enlarge=2)
    seg = psi.extract_segment(*m_seg.lat.segment_first_last)

    def refuse(self, **kwargs):
        raise AssertionError("canonical_form on a segment")

    monkeypatch.setattr(MPS, 'canonical_form', refuse)
    eng = TwoSiteDMRGEngine(seg, m_seg, {
        'trunc_params': {'chi_max': 24, 'svd_min': 1e-12},
        'max_sweeps': 2, 'min_sweeps': 2, 'mixer': False},
        resume_data={'init_env_data': dict(env_data)}, device='cpu')
    eng.run()
    LP0 = eng.env.get_LP(0, store=False)
    RP = eng.env.get_RP(seg.L - 1, store=False)
    assert npc.norm(LP0 - env_data['init_LP']) == 0.
    assert npc.norm(RP - env_data['init_RP']) == 0.
    assert eng.env.get_LP_age(0) == 0


def test_lattice_segment_keeps_class():
    """Chain and Square survive enlarge_mps_unit_cell and
    extract_segment; a partial unit cell raises, as in tenpy_tpu."""
    site = SpinHalfSite(conserve='Sz')
    lat = Square(2, 3, site, bc=['periodic', 'periodic'],
                 bc_MPS='infinite')
    big = lat.enlarge_mps_unit_cell(3)
    assert type(big) is Square and big.Ls == (6, 3) and big.N_sites == 18
    assert np.array_equal(big.order[:6], lat.order)
    assert np.array_equal(big.order[6:12, 0], lat.order[:, 0] + 2)
    seg = lat.extract_segment(enlarge=2)
    assert type(seg) is Square and seg.bc_MPS == 'segment'
    assert seg.segment_first_last == (0, 11) and lat.bc_MPS == 'infinite'
    with pytest.raises(NotImplementedError):
        lat.extract_segment(0, 4)
    chain = TFIChain(dict(tx.SEG_TFI)).extract_segment(enlarge=2)
    assert type(chain.lat).__name__ == 'Chain'
    assert len(chain.H_bond) == chain.lat.N_sites == 4


def test_segment_hdf5_and_copy(tmp_path, ref):
    """segment_boundaries survive copy and an HDF5 round trip."""
    from tenpy_tpu_torch.tools import io as tio
    m = TFIChain(dict(tx.SEG_TFI))
    psi = tx.load_state(ref, 'tfi', m.lat.mps_sites())
    seg = psi.extract_segment(0, 3)
    B = seg.get_B(1, 'B')
    seg.set_B(1, B + B * 0.1, form='B')
    U_L, V_R = seg.canonical_form_finite()
    assert seg.copy().segment_boundaries[0] is U_L
    path = str(tmp_path / 'seg.h5')
    tio.save({'psi': seg}, path)
    back = tio.load(path)['psi']
    assert back.bc == 'segment'
    for a, b in zip(back.segment_boundaries, seg.segment_boundaries):
        assert npc.norm(a - b) < 1e-14


def test_orthogonal_excitations_tfi_vs_jax(ref):
    """tests/test_segment.py:65: the gap of the infinite g=1.5 chain on a
    segment of 4 unit cells, JAX's to 1e-10 and the exact 2|g - J| from
    above (the box shifts the momentum)."""
    out = tx.segment_case('torch', 'ortho_tfi', ref)
    _check(out, ref)
    gap = out['ortho_tfi.gaps'][0]
    assert 1. - 1e-6 < gap < 1.1
    assert abs(out['ortho_tfi.e_density'] - (-1.6719262215362676)) < 1e-8


def test_orthogonal_excitations_spin1_vs_jax(ref):
    """tests/test_segment.py:90 at chi 16 on 3 unit cells: the S=1
    chain's excitation in the Delta Sz = +1 sector, JAX's gap to 1e-10,
    above the Haldane gap, its charge +2 (in units of 2 Sz), normalized
    and, in another sector, orthogonal to the ground state (the excitation
    projected against an earlier one of its sector: the projected Lanczos
    tests below and the smoke's phase 15a)."""
    out = tx.segment_case('torch', 'spin1', ref)
    _check(out, ref, skip=('overlap', 'norms'))
    gaps = out['spin1.gaps']
    assert len(gaps) == 1 and 0.41047925 < gaps[0] < 0.6
    assert np.all(out['spin1.dq'] == 2)
    assert out['spin1.overlap'] < 1e-12
    assert np.allclose(out['spin1.norms'], 1., atol=1e-10)


@pytest.mark.parametrize('case', ['topo_tfi', 'topo_xxz_avg',
                                  'topo_xxz_mp'])
def test_topological_excitations_vs_jax(case, ref):
    """tests/test_topological_excitations.py on 4 unit cells: the TFI kink
    (g=0.4; exact 2(J - g) from above, within the JAX test's 5%) and the
    domain wall between the two Neel states of the Jz=3 XXZ chain (Sz
    conserved), glued with either join_method (relaxed after the first):
    JAX's energies, reference energy and glued state to 1e-10."""
    out = tx.segment_case('torch', case, ref)
    _check(out, ref)
    if case == 'topo_tfi':
        E_exact = 2. * (1. - 0.4)
        assert E_exact - 1e-6 < out[f'{case}.gaps'][0] < 1.05 * E_exact


def test_orthogonal_excitations_infinite_card_route_vs_jax(ref):
    """The TFI case of test_orthogonal_excitations_tfi_vs_jax with every
    two-site update on the card's route (``device_K``: the packed Lanczos,
    projected against the ground state, the kernel's plain version on CPU
    tensors): JAX's gap to 1e-10 (the packed Lanczos stops by the host
    ``LanczosGroundState``'s rule, which JAX's host route runs)."""
    m = TFIChain(dict(tx.SEG_TFI))
    psi = tx.load_state(ref, 'tfi', m.lat.mps_sites())
    opts = {'model_class': 'TFIChain', 'model_params': dict(tx.SEG_TFI),
            'segment_enlarge': tx.SEG_ENLARGE, 'N_excitations': 1,
            'apply_local_op': {'i': tx.SEG_OP_SITE, 'op': 'Sigmax'},
            'algorithm_params': dict(tx.SEG_DMRG, lanczos_params={
                'device_K': 20, 'P_tol': 1e-14}),
            'save_psi': False, 'output_filename': None}
    sim = gss.OrthogonalExcitations(opts, ground_state_data=psi,
                                    device='cpu')
    res = sim.run()
    st = sim.engine.device_lanczos_stats
    assert st['projected'] > 0 and st['plain'] == 0
    assert abs(res['excitation_energies'][0] - ref['ortho_tfi.gaps'][0]) \
        < 1e-10


# ---------------------------------------------- the projected packed Lanczos
@pytest.fixture(scope='module')
def xxz_states():
    """The open L=8 XXZ chain (Sz conserved): its ground state, its first
    excitation in the same sector, and ``Sp`` on the ground state (the
    Sz = +1 sector, the same boundary legs)."""
    m = XXZChain({'L': 8, 'Jxx': 1., 'Jz': 1.3, 'hz': 0.1,
                  'bc_MPS': 'finite'})
    opts = {'trunc_params': {'chi_max': 16, 'svd_min': 1e-12},
            'max_sweeps': 3, 'mixer': False}
    neel = ['up', 'down'] * 4
    gs = MPS.from_product_state(m.lat.mps_sites(), neel)
    TwoSiteDMRGEngine(gs, m, opts, device='cpu').run()
    ex = MPS.from_product_state(m.lat.mps_sites(), ['down', 'up'] * 4)
    TwoSiteDMRGEngine(ex, m, opts, orthogonal_to=[gs], device='cpu').run()
    up = gs.copy()
    up.apply_local_op(4, 'Sp', unitary=False, renormalize=True)
    return m, gs, ex, up


@pytest.mark.parametrize('case', ['one', 'two', 'other_sector',
                                  'guess_on_projected'])
def test_projected_packed_lanczos_vs_host(case, xxz_states):
    """The card's route of an orthogonalized two-site update
    (``_diag_device_lanczos``: the projected vectors packed in the guess's
    layout, ``P H P v`` per matvec) against the host's
    ``LanczosGroundState(orthogonal_to=...)`` on the same effective H,
    both 30 steps from the same guess: E to 1e-10, the Ritz vectors
    to 1 - 1e-8 in overlap and in their overlaps with each projected
    vector of their sector (a projected vector is the state's part in the
    update's space, of norm below 1, and ``P = 1 - o o^dagger`` keeps a
    part of it, as in ``tenpy_tpu``); a vector of another sector is
    skipped; a guess on a projected vector runs the same recursion."""
    m, gs, ex, up = xxz_states
    ortho = {'one': [gs], 'two': [gs, ex], 'other_sector': [up, gs],
             'guess_on_projected': [gs]}[case]
    K = 30
    psi = MPS.from_product_state(m.lat.mps_sites(), ['down', 'up'] * 4)
    psi.perturb({'N_steps': 2, 'seed': 5,
                 'trunc_params': {'chi_max': 16}})
    eng = TwoSiteDMRGEngine(psi, m, {'lanczos_params': {
        'N_min': K, 'N_max': K, 'P_tol': 0., 'device_K': K}},
        orthogonal_to=ortho, device='cpu')
    eng.i0 = 3
    eng.move_right = True
    theta = eng.prepare_update_local()
    eff = eng.eff_H
    vecs = eff.ortho_vecs
    assert len(vecs) == len(ortho)
    if case == 'guess_on_projected':
        theta = vecs[0] + theta * 0.05
    assert eng._use_device_lanczos()
    E_h, th_h, N_h = LanczosGroundState(eff, theta, eng.lanczos_params).run()
    E_d, th_d, N_d, _ = eng._diag_device_lanczos(theta)
    assert N_h == N_d == K
    assert abs(E_d - E_h) <= TOL_JAX * max(1., abs(E_h))
    ov = abs(complex(npc.inner(th_h.conj(), th_d, axes='range')))
    assert ov >= 1. - TOL_OVERLAP
    kept = 0
    for o in vecs:
        if not np.array_equal(o.qtotal, theta.qtotal):
            continue
        kept += 1
        ov_h, ov_d = (abs(complex(npc.inner(o.conj(), th, axes='range')))
                      for th in (th_h, th_d))
        assert abs(ov_d - ov_h) < TOL_OVERLAP
    assert kept == (1 if case == 'other_sector' else len(ortho))
    assert eng.device_lanczos_stats['projected'] == 1


def test_pack_ortho_layout(xxz_states):
    """pack_ortho gives each same-sector vector the guess's layout and
    skips another sector's."""
    m, gs, ex, up = xxz_states
    eng = TwoSiteDMRGEngine(ex.copy(), m, {}, orthogonal_to=[gs, up],
                            device='cpu')
    eng.i0 = 2
    theta = eng.prepare_update_local()
    like = mps_common.pack_virtual(theta, 'cpu')
    packed = mps_common.pack_ortho(eng.eff_H.ortho_vecs, like, 'cpu')
    assert len(packed) == 1 and packed[0]._same_struct(like)


def test_topological_excitations_from_yaml(tmp_path, ref):
    """``simulation_class: TopologicalExcitations`` from a parameter file
    (``ground_state_filename_left/right``) runs the TFI kink, as the
    TFI case with the keywords does."""
    from tenpy_tpu_torch.simulations.simulation import run_simulation
    from tenpy_tpu_torch.tools import io as tio
    m = TFIChain(dict(tx.SEG_TOPO_TFI))
    files = []
    for k in (0, 1):
        path = str(tmp_path / f'gs{k}.h5')
        tio.save({'psi': tx.load_state(ref, f'topo_tfi.gs{k}',
                                       m.lat.mps_sites())}, path)
        files.append(path)
    algo = dict(tx.SEG_DMRG, trunc_params={'chi_max': 16, 'svd_min': 1e-10})
    res = run_simulation(
        'TopologicalExcitations', model_class='TFIChain',
        model_params=dict(tx.SEG_TOPO_TFI), segment_enlarge=tx.SEG_ENLARGE,
        N_excitations=1, ground_state_filename_left=files[0],
        ground_state_filename_right=files[1], algorithm_params=algo,
        save_psi=False, output_filename=None, device='cpu')
    assert abs(res['excitation_energies'][0] - ref['topo_tfi.gaps'][0]) \
        < TOL_JAX
