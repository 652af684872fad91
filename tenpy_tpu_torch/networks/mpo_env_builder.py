r"""Channel-wise GMRES construction of converged iMPS MPO environments.

Port of ``tenpy_tpu/networks/mpo_env_builder.py`` (Phien et al., PRB 86,
245107, 2012).  A Hamiltonian-like MPO is upper triangular up to a
permutation of its virtual states, so the environment is built channel by
channel in topological order:

* the opening identity channel (``IdL`` for LP) is the identity;
* channels without a self-cycle are finite sums of lower channels' inflow;
* channels with a ``|lambda| < 1`` identity self-cycle solve
  ``(1 - lambda T) X = C`` with GMRES;
* the closing identity channel carries the geometric series ``sum_n T^n(C)``:
  the extensive part ``eps * n * Id`` (``eps`` the energy per unit cell) is
  split off and the rest solved with GMRES on ``1 - T + |Id><rho|``.

The environments are host :class:`~tenpy_tpu_torch.linalg.np_conserved.
Array` s and every contraction is a host tensordot.
"""

from __future__ import annotations

import logging

import numpy as np

from ..linalg import np_conserved as npc
from ..linalg.krylov_based import GMRES
from ..linalg.sparse import NpcLinearOperator
from .mpo import _E0

logger = logging.getLogger(__name__)

__all__ = ['MPOEnvironmentBuilder']


class _GeometricSolveOp(NpcLinearOperator):
    """``x -> x - T(x) [+ <rho|x> c0]`` for the channel geometric series."""

    def __init__(self, tm_fn, dtype, c0=None, rho=None):
        self.tm_fn = tm_fn
        self.dtype = dtype
        self.c0 = c0
        self.rho = rho

    def matvec(self, x):
        y = x - self.tm_fn(x)
        if self.c0 is not None:
            # <rho|x> = tr(rho^dag x)  (rho hermitian)
            coeff = complex(npc.inner(self.rho, x, axes='range',
                                      do_conj=True))
            y = y + self.c0 * coeff
        return y


class MPOEnvironmentBuilder:
    """Channel-wise converged LP/RP environments for an infinite MPS + MPO.

    Parameters
    ----------
    H : :class:`~tenpy_tpu_torch.networks.mpo.MPO`
        Infinite Hamiltonian-like MPO with IdL/IdR structure.
    psi : :class:`~tenpy_tpu_torch.networks.mps.MPS`
        Infinite MPS in canonical form, same unit cell length as ``H``.

    Raises
    ------
    ValueError
        If the MPO lacks the required Schur structure (exactly two
        unit-norm identity cycles, acyclic channel graph otherwise).
    """

    def __init__(self, H, psi):
        if psi.finite or H.bc != 'infinite':
            raise ValueError("MPOEnvironmentBuilder needs infinite MPS/MPO")
        if H.L != psi.L:
            raise ValueError("unit cell mismatch H.L != psi.L")
        self.H = H
        self.ket = psi
        self.L = psi.L
        self.dtype = npc.result_type(H.dtype, psi.get_B(0, None).dtype)
        self._edges = self._extract_graph()     # per site: {(a, b): op}
        self._out_edges = [{} for _ in range(self.L)]
        for j, edges in enumerate(self._edges):
            for (a, b) in edges:
                self._out_edges[j].setdefault(a, []).append(b)
        self._analyze_channels()

    # ------------------------------------------------------------ graph
    def _extract_graph(self):
        """Per-site FSM edges from the W tensors: (wL=a, wR=b) -> op."""
        edges = []
        for j in range(self.L):
            W = self.H.get_W(j)
            p_leg = W.get_leg('p')
            Wn = W.transpose(['wL', 'wR', 'p', 'p*']).to_numpy()
            DL, DR = Wn.shape[:2]
            scale = max(float(np.max(np.abs(Wn))), 1e-300)
            site_edges = {}
            for a in range(DL):
                for b in range(DR):
                    op = Wn[a, b]
                    if np.max(np.abs(op)) > 1e-14 * scale:
                        site_edges[(a, b)] = npc.Array.from_ndarray(
                            op, [p_leg, p_leg.conj()], labels=['p', 'p*'],
                            warn_wrong_sector=False)
            edges.append(site_edges)
        return edges

    @staticmethod
    def _id_factor(op):
        """``gamma`` if ``op == gamma * Id`` (gamma real > 0), else None."""
        d = op.shape[0]
        dense = op.to_numpy()
        gamma = np.trace(dense).real / d
        if gamma <= 0:
            return None
        if np.max(np.abs(dense - gamma * np.eye(d))) > 1e-12 * max(gamma, 1.):
            return None
        return gamma

    def _analyze_channels(self):
        """Unit-cell path counts -> cycles, their weights, a topological
        order."""
        L = self.L
        D0 = self.H.get_W(0).get_leg('wL').ind_len
        adj = []
        for j in range(L):
            A = np.zeros((self.H.get_W(j).get_leg('wL').ind_len,
                          self.H.get_W(j).get_leg('wR').ind_len), np.int64)
            for (a, b) in self._edges[j]:
                A[a, b] = 1
            adj.append(A)
        # path counts through the unit cell (clipped at 2: 0/1/many)
        P = adj[0]
        for j in range(1, L):
            P = np.minimum(P @ adj[j], 2)
        self._cycles = {}          # outer index -> path [a, n_1, ..., a]
        self._cycle_weight = {}    # outer index -> product of id factors
        for a in range(D0):
            if P[a, a] == 0:
                continue
            if P[a, a] > 1:
                raise ValueError(f"channel {a} has multiple self-cycles")
            suffix = [None] * (L + 1)
            e_a = np.zeros(adj[-1].shape[1], np.int64)
            e_a[a] = 1
            suffix[L] = e_a
            for j in range(L - 1, -1, -1):
                suffix[j] = np.minimum(adj[j] @ suffix[j + 1], 2)
            path = [a]
            weight = 1.
            for j in range(L):
                cands = [b for b in self._out_edges[j].get(path[-1], ())
                         if suffix[j + 1][b] > 0]
                if len(cands) != 1:
                    raise ValueError(f"ambiguous cycle through channel {a}")
                b = cands[0]
                gamma = self._id_factor(self._edges[j][(path[-1], b)])
                if gamma is None:
                    raise ValueError(
                        f"non-identity operator on cycle of channel {a}")
                weight *= gamma
                path.append(b)
            if weight > 1. + 1e-10:
                raise ValueError(f"cycle of channel {a} has norm {weight} > 1")
            self._cycles[a] = path
            self._cycle_weight[a] = weight
        ones = [a for a, w in self._cycle_weight.items()
                if abs(w - 1.) < 1e-12]
        if len(ones) != 2:
            raise ValueError(f"need exactly 2 unit-norm cycles, found "
                             f"{len(ones)}")
        self._ones = set(ones)
        # topological order of the collapsed channel graph
        R = (P > 0)
        np.fill_diagonal(R, False)
        indeg = R.sum(axis=0).copy()
        order, queue = [], sorted(np.nonzero(indeg == 0)[0].tolist())
        while queue:
            a = queue.pop(0)
            order.append(a)
            for b in np.nonzero(R[a])[0]:
                indeg[b] -= 1
                if indeg[b] == 0:
                    queue.append(int(b))
        if len(order) != D0:
            raise ValueError("channel graph is cyclic beyond self-cycles")
        if order[0] not in self._ones or order[-1] not in self._ones:
            raise ValueError("unit-norm cycles not at the boundary of the "
                             "order")
        self._order = order

    # ---------------------------------------------------- stable gauges
    def _stable_forms(self, form):
        """Exactly isometric A- or B-form unit-cell tensors without
        ``S^-1``: re-orthonormalized through the unit cell with QR/LQ on
        inversion-free per-site tensors.

        The Q factor keeps the site tensor's total charge, so its inner leg
        carries the bond's own charges.  ``tenpy_tpu`` leaves the charge in
        R (L): on a unit cell of nonzero total charge (the half-filled
        Hubbard model with N conserved) its bond charges then drift by that
        charge around the cell, the builder raises, and ``find_init_LP_RP``
        falls back to the Arnoldi route, which the port does not have.
        Where every site's qtotal is zero (the engine's uniform charge gauge
        on a cell of zero total charge) both give the same tensors.  Where
        the sites carry charge but the cell does not, the tensors agree
        densely and only their inner legs' charges differ.  The
        environments and energies agree in both cases
        (``tests/test_torch_mpo_env.py``).  A bond matrix S (a
        UniformMPS's C) needs the forms stored: re-orthonormalizing would
        rotate the cell's boundary basis.  A UniformMPS has forms of None,
        so the builder raises and ``find_init_LP_RP`` takes Arnoldi, as in
        ``tenpy_tpu``."""
        psi = self.ket
        L = self.L
        target = psi._valid_forms[form]
        if all(psi.form[i] == target for i in range(L)):
            return [psi.get_B(i, form) for i in range(L)]
        Ts = []
        aL = 1.
        for k in range(L):
            st = psi.form[k]
            if st is None:
                raise ValueError("psi not in canonical form")
            if k == L - 1:
                aR = 1.
            else:
                aR = 1. - psi.form[k + 1][0]
                if st[1] > aR + 1e-12:
                    aR = st[1]
            Ts.append(psi.get_B(k, (aL, aR)))
            aL = 1. - aR
        out = []
        X = None
        if form == 'A':
            for T in Ts:
                M = T if X is None else npc.tensordot(X, T,
                                                      axes=[['vR'], ['vL']])
                M = M.combine_legs([['vL', 'p']], qconj=[+1])
                Q, X = npc.qr(M, inner_labels=['vR', 'vL'], pos_diag_R=True,
                              qtotal_Q=M.qtotal)
                out.append(Q.split_legs([0]))
        else:
            for T in reversed(Ts):
                M = T if X is None else npc.tensordot(T, X,
                                                      axes=[['vR'], ['vL']])
                M = M.combine_legs([['p', 'vR']], qconj=[-1])
                X, Q = npc.lq(M, inner_labels=['vR', 'vL'], pos_diag_L=True,
                              qtotal_L=np.zeros(len(M.qtotal), np.int64),
                              inner_qconj=+1)
                out.insert(0, Q.split_legs([1]))
        return out

    # ------------------------------------------------------ contractions
    def _contract_step(self, x, j, op, which):
        """One site of the generalized transfer matrix on the 2-leg env."""
        ket, bra = self._Ms[j], self._Mcs[j]
        if which == 'LP':     # x legs (vR*, vR), move right
            x = npc.tensordot(x, ket, axes=[['vR'], ['vL']])
            x = npc.tensordot(x, op, axes=[['p'], ['p*']])
            x = npc.tensordot(bra, x, axes=[['vL*', 'p*'], ['vR*', 'p']])
            return x.itranspose(['vR*', 'vR'])
        x = npc.tensordot(ket, x, axes=[['vR'], ['vL']])   # (vL*, vL), left
        x = npc.tensordot(x, op, axes=[['p'], ['p*']])
        x = npc.tensordot(x, bra, axes=[['vL*', 'p'], ['vR*', 'p*']])
        return x.itranspose(['vL', 'vL*'])

    def _sites(self, which):
        return range(self.L) if which == 'LP' else range(self.L - 1, -1, -1)

    def _tm_full(self, x, which):
        """Plain MPS transfer matrix over the unit cell."""
        for j in self._sites(which):
            x = self._contract_step(x, j, self._Ids[j], which)
        return x

    def _tm_cycle(self, x, cycle, which):
        """Transfer matrix along a cycle's edge operators."""
        for j in self._sites(which):
            x = self._contract_step(
                x, j, self._edges[j][(cycle[j], cycle[j + 1])], which)
        return x

    # ------------------------------------------------------------ solves
    def _gmres(self, op, b, options):
        opts = {'N_min_gmres': 0, 'res': 1e-11, 'N_max_gmres': 30,
                'restart': 20}
        opts.update(options or {})
        x, res = GMRES(op, b, b, opts).run()
        if res > opts['res']:
            logger.warning("env-builder GMRES: residual %.2e > tol %.2e",
                           res, opts['res'])
        return x

    # -------------------------------------------------------- main build
    def init_LP_RP_iterative(self, which='both', calc_E=False,
                             gmres_options=None):
        """Converged LP/RP boundary environments (and energies).

        Returns the ``init_env_data`` dict (``init_LP, init_RP, age_LP,
        age_RP``); with ``calc_E`` also ``(Es, E0)`` as
        :meth:`~tenpy_tpu_torch.networks.mpo.MPOTransferMatrix.
        find_init_LP_RP` does."""
        names = ['RP', 'LP'] if which == 'both' else [which]
        envs, Es = {}, {}
        real_in = not self.ket.dtype.is_complex and \
            not self.H.dtype.is_complex
        for name in names:
            env, eps = self._build_one(name, gmres_options)
            if real_in:
                # real H and psi: keep the environments real (GMRES runs in
                # complex arithmetic)
                env = env.real_if_close(tol=1e-10)
            envs[name] = env
            Es[name] = eps / self.L
        init_env_data = {}
        if 'LP' in envs:
            init_env_data['init_LP'] = envs['LP']
            init_env_data['age_LP'] = 0
        if 'RP' in envs:
            init_env_data['init_RP'] = envs['RP']
            init_env_data['age_RP'] = 0
        if not calc_E:
            return init_env_data
        E0 = None
        if which == 'both':
            E0 = _E0(envs['LP'], self.ket.get_SL(0), envs['RP'])
        return init_env_data, [Es.get('RP'), Es.get('LP')], E0

    def _build_one(self, name, gmres_options):
        L = self.L
        ket = self.ket
        if name == 'LP':
            labels = ['vR*', 'vR']
            vleg = ket.get_B(0, 'A').get_leg('vL')
            c0 = npc.diag(1., vleg, dtype=self.dtype, labels=labels)
            S = ket.get_SL(0)
            w_leg = self.H.get_W(0).get_leg('wL').conj()
            w_label, axis_labels = 'wR', ['vR*', 'wR', 'vR']
            order = self._order
            self._Ms = self._stable_forms('A')
        else:
            labels = ['vL', 'vL*']
            vleg = ket.get_B(L - 1, 'B').get_leg('vR')
            c0 = npc.diag(1., vleg.conj(), dtype=self.dtype, labels=labels)
            S = ket.get_SR(L - 1)
            w_leg = self.H.get_W(L - 1).get_leg('wR').conj()
            w_label, axis_labels = 'wL', ['vL*', 'wL', 'vL']
            order = list(reversed(self._order))
            self._Ms = self._stable_forms('B')
        self._Mcs = [M.conj() for M in self._Ms]
        self._Ids = [npc.diag(1., ket.sites[i].leg, labels=['p', 'p*'])
                     for i in range(L)]
        if isinstance(S, npc.Array):        # a UniformMPS's C
            if name == 'LP':
                rho = npc.tensordot(S, S.conj(), axes=[['vR'], ['vR*']])
            else:
                rho = npc.tensordot(S.conj(), S, axes=[['vL*'], ['vL']])
            rho.iset_leg_labels(labels)
        else:
            rho = npc.diag(np.asarray(S) ** 2, c0.legs[1].conj(),
                           labels=labels)
        grid = self._fresh_grid(name)
        env_parts = []
        eps = None
        seen_one = False
        for j_outer in order:
            cyc = self._cycles.get(j_outer)
            if j_outer in self._ones:
                if not seen_one:
                    seen_one = True
                    E = c0
                else:
                    C = self._ctot_loop(grid, cyc, name)
                    eps = float(np.real(complex(
                        npc.inner(rho, C, axes='range', do_conj=True))))
                    op = _GeometricSolveOp(
                        lambda x: self._tm_full(x, name), self.dtype,
                        c0=c0, rho=rho)
                    E = self._gmres(op, C - c0 * eps, gmres_options)
            elif cyc is not None:
                C = self._ctot_loop(grid, cyc, name)
                op = _GeometricSolveOp(
                    lambda x, c=cyc: self._tm_cycle(x, c, name), self.dtype)
                E = self._gmres(op, C, gmres_options)
            else:
                node = grid[L - 1][j_outer] if name == 'LP' \
                    else grid[0][j_outer]
                if node[1]:
                    raise ValueError(f"channel {j_outer} has pending inflow "
                                     f"{node[1]!r}: inconsistent order")
                E = node[0]
                if E is None:
                    E = npc.zeros(c0.legs, dtype=self.dtype, labels=labels)
            if npc.norm(E) > 0.:
                env_parts.append(E.add_leg(w_leg, j_outer, axis=1,
                                           label=w_label))
            self._push(grid, E, j_outer, name)
        env = env_parts[0]
        for part in env_parts[1:]:
            env = env + part
        env.itranspose(axis_labels)
        return env, eps

    # ---------------------------------------------------- grid machinery
    def _fresh_grid(self, name):
        """``grid[j][b] = [partial sum or None, pending ingoing indices]``:
        for LP on the bond right of site j (wR of site j), for RP on the
        bond left of site j (wL of site j)."""
        grid = []
        for j in range(self.L):
            W = self.H.get_W(j)
            if name == 'LP':
                layer = [[None, set()] for _ in range(W.get_leg('wR').ind_len)]
                for (a, b) in self._edges[j]:
                    layer[b][1].add(a)
            else:
                layer = [[None, set()] for _ in range(W.get_leg('wL').ind_len)]
                for (a, b) in self._edges[j]:
                    layer[a][1].add(b)
            grid.append(layer)
        return grid

    def _push(self, grid, x, j_outer, name):
        """Propagate channel value ``x`` through the unit cell into grid."""
        ready = [(x, j_outer)]
        for j in self._sites(name):
            nxt = []
            for val, i in ready:
                if name == 'LP':
                    targets = [(i, b) for b in self._out_edges[j].get(i, ())]
                else:
                    targets = [(a, i) for (a, b) in self._edges[j] if b == i]
                for (a, b) in targets:
                    contrib = self._contract_step(val, j,
                                                  self._edges[j][(a, b)], name)
                    tgt, src = (b, a) if name == 'LP' else (a, b)
                    node = grid[j][tgt]
                    node[0] = contrib if node[0] is None else node[0] + contrib
                    node[1].discard(src)
                    if not node[1]:
                        nxt.append((node[0], tgt))
            ready = nxt

    def _ctot_loop(self, grid, cycle, name):
        """Total non-cycle inflow into a cycle channel after one unit
        cell."""
        c = None
        for j in self._sites(name):
            if c is not None:
                c = self._contract_step(
                    c, j, self._edges[j][(cycle[j], cycle[j + 1])], name)
            nxt = grid[j][cycle[j + 1] if name == 'LP' else cycle[j]][0]
            if nxt is not None:
                c = nxt if c is None else c + nxt
        if c is None:
            raise ValueError("cycle channel with no inflow")
        return c
