"""The host pieces under the port's ``dmrg.run`` against ``tenpy_tpu``'s.

``LanczosGroundState`` and ``lanczos_arpack``, ``eigh_rho``,
``concatenate``, ``eigh`` with a sort order, ``gauge_total_charge``,
``FlatHermitianOperator.from_NpcArray``, ``OrthogonalNpcLinearOperator``,
the two-site effective Hamiltonian and ``full_diag_effH``, the
``EventHandler`` and the ``DictCache`` with its sub-caches.  The arrays are
seeded random U(1)xU(1) arrays built in ``tenpy_tpu`` and carried into the
port through the exchange format, as in ``tests/test_torch_np_conserved.py``;
each case applies the same function in both packages.
"""
import numpy as np
import pytest
import torch

import tenpy_tpu.linalg.np_conserved as jnpc
from tenpy_tpu.linalg import krylov_based as jkrylov, sparse as jsparse, \
    truncation as jtrunc
from tenpy_tpu.tools import cache as jcache, events as jevents
from tenpy_tpu_torch.algorithms import dmrg, mps_common
from tenpy_tpu_torch.linalg import krylov_based, sparse, truncation
from tenpy_tpu_torch.linalg import np_conserved as npc
from tenpy_tpu_torch.networks.mpo import MPOEnvironment
from tenpy_tpu_torch.tools import cache, events, params

import torch_exchange as tx
from test_torch_np_conserved import _close, _dense, _leg, _random

torch.set_num_threads(1)


class _MatOp:
    """``tensordot(mat, v)`` on vectors with one leg: a hermitian test
    operator for the Krylov solvers, in either package."""

    def __init__(self, mat, npc_mod):
        self.mat = mat
        self.npc = npc_mod
        self.dtype = mat.dtype

    def matvec(self, v):
        return self.npc.tensordot(self.mat, v, axes=[[1], [0]])


def _hermitian(seed, n=6):
    """A random hermitian U(1)xU(1) matrix and a guess vector in one charge
    sector, in both packages: ``(jmat, mat, jv, v)``."""
    rng = np.random.default_rng(seed)
    jleg, _ = _leg(rng, n, +1)
    ja, _ = _random(rng, [jleg, jleg.conj()], ['a', 'a*'], qtotal=[0, 0])
    jmat = ja + ja.conj().itranspose([1, 0]).iset_leg_labels(['a', 'a*'])
    q = tuple(jmat.chinfo.make_valid(jleg.charges[jmat._qdata[0][0]]
                                     * jleg.qconj))
    jv, v = _random(rng, [jleg], ['a'], qtotal=q)
    return jmat, tx.to_host(jmat), jv, v


@pytest.mark.parametrize('seed', [0, 1])
def test_lanczos_ground_state_vs_jax(seed):
    jmat, mat, jv, v = _hermitian(seed)
    opts = {'N_max': 12, 'P_tol': 1e-14, 'N_min': 2}
    E, psi, N = krylov_based.LanczosGroundState(_MatOp(mat, npc), v,
                                                dict(opts)).run()
    jE, jpsi, jN = jkrylov.LanczosGroundState(_MatOp(jmat, jnpc), jv,
                                              dict(opts)).run()
    assert N == jN
    assert abs(E - jE) <= 1e-12 * max(abs(jE), 1.)
    _close(psi, jpsi)
    # the Ritz vector from a cache of 2 (second pass) is the same vector
    E2, psi2, _ = krylov_based.LanczosGroundState(
        _MatOp(mat, npc), v, dict(opts, N_cache=2)).run()
    assert abs(E2 - E) <= 1e-14 * max(abs(E), 1.)
    assert abs(abs(complex(npc.inner(psi.conj(), psi2, axes='range')))
               - 1.) <= 1e-10
    # ARPACK agrees on the lowest eigenvalue of the sector
    Ea, psia = krylov_based.lanczos_arpack(_MatOp(mat, npc), v, dict(opts))
    assert abs(Ea - E) <= 1e-10 * max(abs(E), 1.)


def test_flat_hermitian_and_orthogonal_operators_vs_jax():
    jmat, mat, jv, v = _hermitian(3)
    q = v.qtotal
    flat = sparse.FlatHermitianOperator.from_NpcArray(mat, charge_sector=q)
    jflat = jsparse.FlatHermitianOperator.from_NpcArray(jmat,
                                                        charge_sector=q)
    assert flat.shape == jflat.shape
    x = np.random.default_rng(4).standard_normal(flat.shape[0])
    assert np.abs(flat.matvec(x) - jflat.matvec(x)).max() <= 1e-13
    _close(flat.flat_to_npc(x), jflat.flat_to_npc(x))
    # P H P with the lowest eigenvector projected out
    E, V = flat.eigenvectors(num_ev=1, which='SA')
    jE, jV = jflat.eigenvectors(num_ev=1, which='SA')
    assert abs(E[0] - jE[0]) <= 1e-10 * max(abs(jE[0]), 1.)
    o, jo = V[0], tx.to_jax(V[0])
    op = sparse.OrthogonalNpcLinearOperator(_MatOp(mat, npc), [o])
    jop = jsparse.OrthogonalNpcLinearOperator(_MatOp(jmat, jnpc), [jo])
    _close(op.matvec(v), jop.matvec(jv))
    _close(op.matvec(o), jop.matvec(jo))
    assert npc.norm(op.matvec(o)) <= 1e-12


@pytest.mark.parametrize('sort', [None, 'm>', '<'])
def test_eigh_and_eigh_rho_vs_jax(sort):
    jmat, mat, _, _ = _hermitian(7, n=8)
    # a density matrix: M M^dagger, normalized
    jrho = jnpc.tensordot(jmat, jmat.conj(), axes=[[1], [1]])
    jrho = jrho / jnpc.trace(jrho)
    rho = tx.to_host(jrho)
    W, V = npc.eigh(rho, sort=sort)
    jW, jV = jnpc.eigh(jrho, sort=sort)
    assert np.abs(W - np.asarray(jW)).max() <= 1e-13
    recon = npc.tensordot(V.scale_axis(W, 1), V.conj(), axes=[[1], [1]])
    assert np.abs(_dense(recon) - _dense(rho)).max() <= 1e-13
    trunc = {'chi_max': 5, 'svd_min': 1e-6}
    Wk, Vk, err, renorm = truncation.eigh_rho(rho, trunc, sort=sort)
    jWk, jVk, jerr, jrenorm = jtrunc.eigh_rho(jrho, dict(trunc), sort=sort)
    assert np.abs(np.sort(Wk) - np.sort(np.asarray(jWk))).max() <= 1e-13
    assert abs(err.eps - jerr.eps) <= 1e-13 and abs(renorm - jrenorm) <= 1e-13
    assert Vk.shape == jVk.shape


def test_concatenate_and_gauge_total_charge_vs_jax():
    rng = np.random.default_rng(11)
    jl0, _ = _leg(rng, 4, +1)
    jl1, _ = _leg(rng, 3, -1)
    jl2, _ = _leg(rng, 5, -1)
    ja, a = _random(rng, [jl0, jl1], ['x', 'y'], qtotal=[0, 0])
    jb = jnpc.Array.from_func(lambda size: rng.standard_normal(size),
                              [jl0, jl2], qtotal=ja.qtotal, labels=['x', 'y'])
    b = tx.to_host(jb)
    c = npc.concatenate([a, b], axis='y')
    jc = jnpc.concatenate([ja, jb], axis='y')
    _close(c, jc)
    assert c.get_leg('y').ind_len == a.shape[1] + b.shape[1]
    q = (1, -1)
    g = a.gauge_total_charge('y', q)
    jg = ja.gauge_total_charge('y', q)
    assert g.qtotal == tuple(jg.qtotal) == q
    assert np.array_equal(g.get_leg('y').charges, jg.get_leg('y').charges)
    g.test_sanity()


def test_effective_H_and_full_diag_vs_jax():
    """``TwoSiteH`` (plain and combined), ``OneSiteH`` (both directions,
    plain and combined) and ``ZeroSiteH`` on a Heisenberg chain's product
    state, and ``full_diag_effH`` in the guess's sector and over all
    sectors, against tenpy_tpu's."""
    model, psi, _ = tx.host_dmrg_case('excited', 'torch')
    jmodel, jpsi, _ = tx.host_dmrg_case('excited', 'jax')
    from tenpy_tpu.algorithms import dmrg as jdmrg, mps_common as jmc
    from tenpy_tpu.networks.mpo import MPOEnvironment as JEnv
    env = MPOEnvironment(psi, model.H_MPO, psi)
    jenv = JEnv(jpsi, jmodel.H_MPO, jpsi)
    cases = [(mps_common.TwoSiteH, jmc.TwoSiteH, 2, c, True)
             for c in (False, True)]
    cases += [(mps_common.OneSiteH, jmc.OneSiteH, 1, c, r)
              for c in (False, True) for r in (True, False)]
    for H_cls, jH_cls, n, combine, move_right in cases:
        H = H_cls(env, 2, combine, move_right)
        jH = jH_cls(jenv, 2, combine, move_right)
        assert H.N == jH.N
        theta = H.combine_theta(psi.get_theta(2, n))
        jtheta = jH.combine_theta(jpsi.get_theta(2, n))
        _close(H.matvec(theta), jH.matvec(jtheta))
        _close(H.to_matrix(), jH.to_matrix())
        if n == 1 and combine:
            # to_matrix ignores the combined legs (in both packages), so
            # the ED result cannot take the guess's legs: both raise
            with pytest.raises(ValueError):
                dmrg.full_diag_effH(H, theta)
            with pytest.raises(ValueError):
                jdmrg.full_diag_effH(jH, jtheta)
            continue
        E, th = dmrg.full_diag_effH(H, theta)
        jE, jth = jdmrg.full_diag_effH(jH, jtheta)
        assert abs(E - jE) <= 1e-12 * abs(jE)
        ov = abs(np.vdot(_dense(jth).ravel(), _dense(th).ravel()))
        assert abs(ov - 1.) <= 1e-12
        # over all sectors (tenpy_tpu's ED_all raises: its unit vector sits
        # on the conjugate leg): the lowest eigenvalue of JAX's matrix
        E, th = dmrg.full_diag_effH(H, theta, keep_sector=False)
        mat = _dense(jH.to_matrix())
        assert abs(E - np.linalg.eigvalsh(mat)[0]) <= 1e-12 * abs(E)
        v = _dense(th.combine_legs([list(range(th.rank))])
                   if th.rank > 1 else th)
        assert abs(np.vdot(v, _dense(H.to_matrix()) @ v) - E) <= 1e-12 * abs(E)
        with pytest.raises(ValueError, match='same qconj'):
            jdmrg.full_diag_effH(jH, jtheta, keep_sector=False)
    H0 = mps_common.ZeroSiteH(env, 3)
    jH0 = jmc.ZeroSiteH(jenv, 3)
    S = npc.diag(1., psi.get_B(3).get_leg('vL'), labels=['vL', 'vR'])
    jS = jnpc.diag(1., jpsi.get_B(3).get_leg('vL'), labels=['vL', 'vR'])
    _close(H0.matvec(S), jH0.matvec(jS))


def test_event_handler_vs_jax():
    got = {}
    for mod, key in ((events, 'port'), (jevents, 'jax')):
        ev = mod.EventHandler('x')
        calls = []
        ev.connect(lambda x: calls.append(('a', x)) or 'a', priority=1)
        lid = ev.id_of_last_connected
        ev.connect(lambda x: calls.append(('b', x)), priority=5)
        ev.connect(lambda x: calls.append(('c', x)) or 'c', priority=3)
        res = ev.emit(7)
        first = ev.emit_until_result(8)
        ev.disconnect(lid)
        res2 = ev.emit(9)
        got[key] = (calls, res, first, res2, len(ev.copy().listeners))
    assert got['port'] == got['jax']


def test_dict_cache_vs_jax():
    got = {}
    for mod, key in ((cache, 'port'), (jcache, 'jax')):
        c = mod.DictCache.trivial()
        sub = c.create_subcache('env')
        sub2 = sub.create_subcache('x')
        sub['LP_0'] = 1
        sub2['RP_1'] = 2
        c['top'] = 3
        sub.set_short_term_keys('LP_0')
        sub.preload('LP_0')
        trace = [sorted(c.keys()), 'LP_0' in sub, 'RP_1' in sub,
                 sub.get('RP_9', 'none'), sub2['RP_1'], c['env/LP_0'],
                 sorted(c.short_term_cache)]
        del sub['LP_0']
        trace += ['LP_0' in sub, sorted(c.keys())]
        got[key] = trace
    assert got['port'] == got['jax']


def test_config_subconfig_and_dict_interface():
    cfg = params.Config({'trunc_params': {'chi_max': 8}, 'a': 1}, 'test')
    sub = cfg.subconfig('trunc_params')
    assert sub.get('svd_min', 1e-14, 'real') == 1e-14
    sub['chi_max'] = 16
    assert cfg['trunc_params'] is sub and 'chi_max' in sub
    assert sub.options == {'chi_max': 16, 'svd_min': 1e-14}
    assert cfg.setdefault('b', 2) == 2 and 'b' in cfg
    assert cfg.unused == {'a'}
