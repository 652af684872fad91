r"""Lattice geometry: unit cell, MPS order, neighbour pairs, couplings.

Port of ``tenpy_tpu/models/lattice.py``: ``Lattice`` (with its orders,
``possible_couplings`` and ``possible_multi_couplings``), ``get_order``,
``get_order_grouped``, ``SimpleBZ``, ``TrivialLattice``,
``SimpleLattice``, ``MultiSpeciesLattice``, ``Chain``, ``Ladder``,
``NLegLadder``, ``Square``, ``Triangular``, ``Honeycomb``, ``Kagome``,
``IrregularLattice`` (a regular lattice with sites removed),
``HelicalLattice`` and ``get_lattice``, with the same conventions:

* a lattice site is ``(x_0, ..., x_{dim-1}, u)`` with ``u`` indexing the
  unit cell;
* ``order`` is an ``(N_sites, dim+1)`` array: row ``i`` is the lattice index
  of MPS site ``i``;
* ``bc`` per axis is ``'open'``, ``'periodic'`` or an integer (periodic,
  shifted along axis 0 by that many cells on each wrap); for
  ``bc_MPS='infinite'`` axis 0 is the infinite direction.

Sites whose charges shift with their position (dipole conservation) are
shifted to each site's lattice position by :meth:`Lattice.mps_sites`.
The plotting helpers are not ported.
"""

from __future__ import annotations

import copy
import itertools

import numpy as np

from ..networks.site import Site

__all__ = ['Lattice', 'TrivialLattice', 'SimpleLattice',
           'MultiSpeciesLattice', 'IrregularLattice', 'HelicalLattice',
           'Chain', 'Ladder', 'NLegLadder', 'Square', 'Triangular',
           'Honeycomb', 'Kagome', 'get_lattice', 'get_order',
           'get_order_grouped', 'SimpleBZ']


class Lattice:
    """Unit cells of sites with an MPS order and neighbour tables.

    Parameters
    ----------
    Ls : list of int
        Extent in each direction.
    unit_cell : list of Site
    order : str | ndarray
        MPS order: ``'default'``/``'Cstyle'``, ``'Fstyle'``, ``'snake'``,
        ``('grouped', groups)`` or an explicit order array.
    bc : (list of) {'open', 'periodic', int}
    bc_MPS : 'finite' | 'segment' | 'infinite'
    basis : array (dim, D) | None
        Lattice vectors (default: unit vectors).
    positions : array (len(unit_cell), D) | None
        Positions of the sites within the unit cell.
    pairs : dict
        Neighbour tables ``{'nearest_neighbors': [(u1, u2, dx), ...], ...}``.
    """

    _valid_bc_MPS = ('finite', 'segment', 'infinite')

    def __init__(self, Ls, unit_cell, order='default', bc='open',
                 bc_MPS='finite', basis=None, positions=None, pairs=None):
        self.Ls = tuple(int(L) for L in Ls)
        self.unit_cell = list(unit_cell)
        self.Lu = len(self.unit_cell)
        self.dim = len(self.Ls)
        self.shape = self.Ls + (self.Lu,)
        self.N_cells = int(np.prod(self.Ls))
        self.N_sites = self.N_cells * self.Lu
        self.chinfo = self.unit_cell[0].leg.chinfo
        if bc_MPS not in self._valid_bc_MPS:
            raise ValueError(f"invalid bc_MPS {bc_MPS!r}")
        self.bc_MPS = bc_MPS
        self._set_bc(bc)
        self.basis = np.asarray(np.eye(self.dim) if basis is None else basis,
                                float)
        self.position_vectors = np.asarray(
            np.zeros((self.Lu, self.basis.shape[1])) if positions is None
            else positions, float)
        self.pairs = dict(pairs or {})
        self._order_name = order
        self.order = self.ordering(order)

    def _set_bc(self, bc):
        if isinstance(bc, str):
            bc = [bc] * self.dim
        bc = list(bc)
        if len(bc) != self.dim:
            raise ValueError("bc length != dim")
        self.bc = np.zeros(self.dim, bool)     # True = open
        self.bc_shift = np.zeros(self.dim, int)
        for a, b in enumerate(bc):
            if isinstance(b, (int, np.integer)):
                self.bc_shift[a] = int(b)
            elif b not in ('open', 'periodic'):
                raise ValueError(f"invalid bc entry {b!r}")
            else:
                self.bc[a] = b == 'open'
        if self.bc_MPS == 'infinite' and self.bc[0]:
            raise ValueError("bc_MPS='infinite' requires periodic bc along "
                             "axis 0")
        if self.bc_shift[0] != 0:
            raise ValueError("no bc_shift along the MPS axis")

    @property
    def boundary_conditions(self):
        """``bc`` as given: 'open', 'periodic' or the shift per axis."""
        return ['open' if self.bc[a] else
                int(self.bc_shift[a]) if self.bc_shift[a] else 'periodic'
                for a in range(self.dim)]

    def ordering(self, order):
        """The ``(N_sites, dim+1)`` MPS order array."""
        if isinstance(order, np.ndarray):
            return order
        if order in ('default', 'Cstyle'):
            return get_order(self.shape, [True] * (self.dim + 1))
        if order == 'Fstyle':
            return get_order(self.shape[::-1],
                             [True] * (self.dim + 1))[:, ::-1]
        if order == 'snake':
            return get_order(self.shape, [True] * (self.dim + 1),
                             snake_winding=[False] * (self.dim + 1),
                             snaked=True)
        if isinstance(order, tuple) and order and order[0] == 'grouped':
            return get_order_grouped(self.shape, order[1])
        raise ValueError(f"unknown ordering {order!r}")

    @property
    def order(self):
        return self._order

    @order.setter
    def order(self, order):
        self._order = np.asarray(order, int)
        self._perm = np.full(self.shape, -1, dtype=int)
        for i, idx in enumerate(self._order):
            self._perm[tuple(idx)] = i

    def mps_sites(self):
        """The sites in MPS order (length ``N_sites``).  A unit-cell site
        whose charges shift with position (dipole conservation) is defined
        at position 0; each MPS site is a copy shifted to its lattice
        position."""
        sites = []
        for lat_idx in self._order:
            site = self.unit_cell[lat_idx[-1]]
            if site is not None and not site.leg.chinfo.trivial_shift:
                dx = np.array(lat_idx, int)
                dx[-1] = 0
                leg = site.leg.apply_charge_mapping(
                    site.leg.chinfo.shift_charges, func_kwargs={'dx': dx})
                site = copy.copy(site)
                site.change_charge(leg)
            sites.append(site)
        return sites

    def mps2lat_idx(self, i):
        """MPS index -> lattice index (modulo ``N_sites``)."""
        i = np.asarray(i)
        if i.ndim == 0:
            return self._order[int(i) % self.N_sites].copy()
        return self._order[i % self.N_sites].copy()

    def lat2mps_idx(self, lat_idx):
        """Lattice index -> MPS index (infinite bc: shifted by whole unit
        cells; a wrap of a shifted periodic axis moves axis 0 by its
        shift)."""
        lat_idx = np.asarray(lat_idx, int)
        single = lat_idx.ndim == 1
        lat = lat_idx.reshape(-1, self.dim + 1).copy()
        shift = np.zeros(lat.shape[0], int)
        for a in range(self.dim):
            La = self.Ls[a]
            if a == 0 and self.bc_MPS == 'infinite':
                cells = np.floor_divide(lat[:, 0], La)
                shift += cells * self.N_sites
                lat[:, 0] -= cells * La
            elif not self.bc[a]:
                wraps = np.floor_divide(lat[:, a], La)
                lat[:, a] -= wraps * La
                lat[:, 0] += wraps * self.bc_shift[a]
        if self.bc_MPS == 'infinite':
            cells = np.floor_divide(lat[:, 0], self.Ls[0])
            shift += cells * self.N_sites
            lat[:, 0] -= cells * self.Ls[0]
        if np.any(lat < 0) or np.any(lat >= np.array(self.shape)):
            raise IndexError("lattice index out of bounds (open bc?)")
        res = self._perm[tuple(lat.T)] + shift
        return int(res[0]) if single else res

    def mps_idx_fix_u(self, u=None):
        """MPS indices of all sites with unit-cell index ``u``."""
        if u is None:
            return np.arange(self.N_sites)
        return np.nonzero(self._order[:, -1] == u)[0]

    def mps_lat_idx_fix_u(self, u=None):
        idx = self.mps_idx_fix_u(u)
        return idx, self._order[idx, :-1]

    def position(self, lat_idx):
        """Real-space position of lattice site(s)."""
        lat_idx = np.asarray(lat_idx, int)
        lat = lat_idx.reshape(-1, self.dim + 1)
        pos = lat[:, :-1] @ self.basis + self.position_vectors[lat[:, -1]]
        return pos[0] if lat_idx.ndim == 1 else pos

    def mps2lat_values(self, A, axes=0, u=None):
        """An array indexed by MPS sites (along ``axes``) in lattice shape
        (``u``: only the sites of that unit-cell index)."""
        A = np.asarray(A)
        if axes != 0:
            A = np.moveaxis(A, axes, 0)
        if u is None:
            shape, order = self.shape, self._order
        else:
            shape = self.Ls
            order = self._order[self.mps_idx_fix_u(u)][:, :-1]
        res = np.empty(tuple(shape) + A.shape[1:], dtype=A.dtype)
        for k, lat in enumerate(order):
            res[tuple(lat)] = A[k]
        return res

    def possible_couplings(self, u1, u2, dx, strength=None):
        """Two-site couplings ``A_{u1, x} B_{u2, x+dx}``: returns
        ``(mps_i, mps_j, lat_indices, coupling_shape)``."""
        dx = np.asarray(dx, int)
        coupling_shape, shift_lat = self.coupling_shape(dx)
        Ls = np.array(self.Ls)
        mps_i, mps_j, lat_idx = [], [], []
        for x in itertools.product(*[range(n) for n in coupling_shape]):
            x0 = np.asarray(x, int) + shift_lat
            i_lat = np.concatenate([x0, [u1]])
            j_lat = np.concatenate([x0 + dx, [u2]])
            if any(self.bc[a] and not (0 <= i_lat[a] < Ls[a]
                                       and 0 <= j_lat[a] < Ls[a])
                   for a in range(self.dim)):
                continue
            try:
                i = self.lat2mps_idx(i_lat)
                j = self.lat2mps_idx(j_lat)
            except IndexError:
                continue
            if self.bc_MPS == 'infinite':
                # translate so that 0 <= min(i, j) < N_sites
                shift = (min(i, j) // self.N_sites) * self.N_sites
                i -= shift
                j -= shift
            mps_i.append(i)
            mps_j.append(j)
            lat_idx.append(x)
        lat_idx = np.array(lat_idx, int).reshape(len(mps_i), self.dim)
        return (np.array(mps_i, int), np.array(mps_j, int), lat_idx,
                tuple(coupling_shape))

    def possible_multi_couplings(self, ops):
        """Multi-site couplings of ``ops = [(opname, dx, u), ...]``: returns
        ``(mps_ijkl, lat_indices, coupling_shape)``."""
        dxs = np.array([dx for _, dx, _ in ops], int)
        us = [u for _, _, u in ops]
        dxs = dxs - dxs.min(axis=0)
        coupling_shape, shift_lat = self.coupling_shape(dxs.max(axis=0))
        Ls = np.array(self.Ls)
        mps_ijkl, lat_idx = [], []
        for x in itertools.product(*[range(n) for n in coupling_shape]):
            x0 = np.asarray(x, int) + shift_lat
            ijkl = []
            for dx, u in zip(dxs, us):
                lat = np.concatenate([x0 + dx, [u]])
                if any(self.bc[a] and not 0 <= lat[a] < Ls[a]
                       for a in range(self.dim)):
                    break
                try:
                    ijkl.append(self.lat2mps_idx(lat))
                except IndexError:
                    break
            else:
                if self.bc_MPS == 'infinite':
                    shift = (min(ijkl) // self.N_sites) * self.N_sites
                    ijkl = [i - shift for i in ijkl]
                mps_ijkl.append(ijkl)
                lat_idx.append(x)
        mps_ijkl = np.array(mps_ijkl, int).reshape(len(mps_ijkl), len(ops))
        lat_idx = np.array(lat_idx, int).reshape(len(mps_ijkl), self.dim)
        return mps_ijkl, lat_idx, tuple(coupling_shape)

    def coupling_shape(self, dx):
        """Shape of the coupling-strength array for offset ``dx`` (open axes
        shrink by ``|dx|``) and the index shift."""
        shape, shift = [], []
        for a in range(self.dim):
            La = self.Ls[a]
            if self.bc[a]:
                shape.append(max(La - abs(int(dx[a])), 0))
                shift.append(max(-int(dx[a]), 0))
            else:
                shape.append(La)
                shift.append(0)
        return tuple(shape), np.array(shift, int)

    def find_coupling_pairs(self, max_dx=3, cutoff=None, eps=1e-10):
        """Neighbour pairs found from the distances of the sites' positions:
        ``{'nearest_neighbors': ..., 'next_nearest_neighbors': ...,
        'next_next_nearest_neighbors': ...}``."""
        pos, info = [], []
        origin = np.zeros(self.dim, int)
        for u in range(self.Lu):
            for dx in itertools.product(*[range(-max_dx, max_dx + 1)]
                                        * self.dim):
                for u2 in range(self.Lu):
                    d = np.linalg.norm(
                        self.position(np.concatenate([np.array(dx), [u2]]))
                        - self.position(np.concatenate([origin, [u]])))
                    if d > eps:
                        pos.append(d)
                        info.append((u, u2, np.array(dx, int)))
        pos = np.array(pos)
        dists = np.sort(np.unique(np.round(pos, 8)))
        if cutoff is not None:
            dists = dists[dists <= cutoff]
        names = ['nearest_neighbors', 'next_nearest_neighbors',
                 'next_next_nearest_neighbors']
        result = {}
        for name, d in zip(names, dists):
            # d is rounded to 8 decimals: select with a matching tolerance
            sel = np.abs(pos - d) < max(eps, 1e-7)
            seen, pairs = set(), []
            for u, u2, dx in [info[i] for i in np.nonzero(sel)[0]]:
                if (u, u2, tuple(dx)) in seen or (u2, u, tuple(-dx)) in seen:
                    continue
                seen.add((u, u2, tuple(dx)))
                pairs.append((u, u2, dx))
            result[name] = pairs
        return result

    @property
    def BZ(self):
        """The first Brillouin zone of the basis (:class:`SimpleBZ`)."""
        if getattr(self, '_BZ', None) is None:
            self._BZ = SimpleBZ(self.basis, self.dim)
        return self._BZ

    def test_sanity(self):
        assert len(self._order) == self.N_sites
        assert sorted(map(tuple, self._order)) == sorted(
            itertools.product(*[range(n) for n in self.shape]))

    def enlarge_mps_unit_cell(self, factor=2):
        """A copy of the lattice (of the same class) with ``factor`` times
        as many unit cells along axis 0, each repeat of the MPS order
        shifted by whole lattice lengths; infinite bc only."""
        if self.bc_MPS != 'infinite':
            raise ValueError("enlarge_mps_unit_cell needs bc_MPS='infinite'")
        factor = int(factor)
        cp = copy.copy(self)
        cp.Ls = (self.Ls[0] * factor,) + self.Ls[1:]
        cp.shape = cp.Ls + (self.Lu,)
        cp.N_cells = self.N_cells * factor
        cp.N_sites = self.N_sites * factor
        shift = np.zeros(self.dim + 1, int)
        shift[0] = self.Ls[0]
        cp.order = np.concatenate([self._order + k * shift
                                   for k in range(factor)])
        return cp

    def extract_segment(self, first=0, last=None, enlarge=None):
        """A copy for the segment ``[first, last]`` of an infinite MPS:
        ``enlarge`` unit cells, or ``first=0`` and ``last = n N_sites -
        1``; bc_MPS ``'segment'`` and ``segment_first_last`` set.  A
        segment that is not a whole number of unit cells raises."""
        L = self.N_sites
        if enlarge is not None:
            if self.bc_MPS != 'infinite':
                raise ValueError("enlarge only possible for infinite MPS")
            if last is not None or first != 0:
                raise ValueError("specify either first+last or enlarge")
            assert enlarge > 0
            last = enlarge * L - 1
        elif last is None:
            last = L - 1
            enlarge = 1
        else:
            enlarge = last // L + 1
        if first != 0 or (last + 1) % L != 0:
            raise NotImplementedError("a segment of a partial unit cell "
                                      "(an irregular lattice) is not "
                                      "ported")
        cp = self.enlarge_mps_unit_cell(enlarge) if enlarge > 1 \
            else copy.copy(self)
        cp.bc_MPS = 'segment'
        cp.segment_first_last = (first, last)
        return cp

    def __repr__(self):
        return (f"{self.__class__.__name__}({list(self.Ls)}, "
                f"bc_MPS={self.bc_MPS!r})")


def get_order(shape, cstyle_priority, snake_winding=None, snaked=False):
    """C-style enumeration of a hypercubic index set; ``snaked``: every
    other row reversed, recursively (``tenpy_tpu`` reads neither
    ``cstyle_priority`` nor ``snake_winding``, nor does the port)."""
    if not snaked:
        return np.array(list(itertools.product(*[range(n) for n in shape])),
                        int)
    res = []

    def rec(prefix, axis, reverse):
        if axis == len(shape):
            res.append(tuple(prefix))
            return
        rng = reversed(range(shape[axis])) if reverse else range(shape[axis])
        for k, x in enumerate(rng):
            rec(prefix + [x], axis + 1, k % 2 == 1)

    rec([], 0, False)
    return np.array(res, int)


def get_order_grouped(shape, groups, priority=None):
    """An order that visits the unit-cell indices of each group together,
    cell by cell."""
    return np.array([tuple(cell) + (u,)
                     for cell in itertools.product(*[range(n)
                                                     for n in shape[:-1]])
                     for group in groups for u in group], int)


class SimpleBZ:
    """The first Brillouin zone of a lattice basis: its reciprocal vectors
    and vertices (its plotting is not ported)."""

    def __init__(self, basis, dim):
        self.basis = np.asarray(basis)
        self.dim = dim
        self.reciprocal_basis = 2 * np.pi * np.linalg.pinv(self.basis).T

    def vertices(self):
        """Corners of the first zone (2D: the Voronoi cell of the
        reciprocal lattice around the origin; 1D: the interval ends)."""
        recip = np.atleast_2d(self.reciprocal_basis)
        if self.dim == 1 or len(recip) == 1:
            g = np.linalg.norm(recip[0])
            return np.array([[-g / 2.], [g / 2.]])
        from scipy.spatial import Voronoi
        pts = [i * recip[0][:2] + j * recip[1][:2]
               for i in range(-2, 3) for j in range(-2, 3)]
        vor = Voronoi(np.asarray(pts))
        verts = vor.vertices[vor.regions[vor.point_region[12]]]
        return verts[np.argsort(np.arctan2(verts[:, 1], verts[:, 0]))]


class TrivialLattice(Lattice):
    """The sites as one unit cell (``Ls = [1]``)."""

    def __init__(self, mps_sites, **kwargs):
        super().__init__([1], mps_sites, **kwargs)


class SimpleLattice(Lattice):
    """Lattice with a single-site unit cell."""

    def __init__(self, Ls, site, **kwargs):
        super().__init__(Ls, [site], **kwargs)


class Chain(SimpleLattice):
    """1D chain; order ``'folded'`` maps a ring onto an open MPS as
    ``[0, L-1, 1, L-2, ...]``."""

    dim = 1

    def __init__(self, L, site, **kwargs):
        kwargs.setdefault('pairs', {
            'nearest_neighbors': [(0, 0, np.array([1]))],
            'next_nearest_neighbors': [(0, 0, np.array([2]))],
            'next_next_nearest_neighbors': [(0, 0, np.array([3]))],
        })
        super().__init__([L], site, **kwargs)

    def ordering(self, order):
        if isinstance(order, str) and order == 'folded':
            L = self.shape[0]
            idx = []
            for i in range((L + 1) // 2):
                idx.append(i)
                if i != L - 1 - i:
                    idx.append(L - 1 - i)
            return np.array([[i, 0] for i in idx], np.intp)
        return super().ordering(order)


class Ladder(Lattice):
    """Two-leg ladder."""

    dim = 1

    def __init__(self, L, sites, **kwargs):
        if isinstance(sites, Site):
            sites = [sites, sites]
        kwargs.setdefault('pairs', {
            'nearest_neighbors': [(0, 0, np.array([1])),
                                  (1, 1, np.array([1])),
                                  (0, 1, np.array([0]))],
            'next_nearest_neighbors': [(0, 1, np.array([1])),
                                       (1, 0, np.array([1]))],
        })
        kwargs.setdefault('positions', [[0., 0.], [0., 1.]])
        kwargs.setdefault('basis', [[1., 0.]])
        super().__init__([L], sites, **kwargs)


class NLegLadder(Lattice):
    """N-leg ladder."""

    dim = 1

    def __init__(self, L, n_legs, sites, **kwargs):
        if isinstance(sites, Site):
            sites = [sites] * n_legs
        kwargs.setdefault('pairs', {'nearest_neighbors': [
            (u, u, np.array([1])) for u in range(n_legs)] + [
            (u, u + 1, np.array([0])) for u in range(n_legs - 1)]})
        kwargs.setdefault('positions', [[0., u] for u in range(n_legs)])
        kwargs.setdefault('basis', [[1., 0.]])
        super().__init__([L], sites, **kwargs)


class Square(SimpleLattice):
    """2D square lattice."""

    dim = 2

    def __init__(self, Lx, Ly, site, **kwargs):
        kwargs.setdefault('pairs', {
            'nearest_neighbors': [(0, 0, np.array([1, 0])),
                                  (0, 0, np.array([0, 1]))],
            'next_nearest_neighbors': [(0, 0, np.array([1, 1])),
                                       (0, 0, np.array([1, -1]))],
            'next_next_nearest_neighbors': [(0, 0, np.array([2, 0])),
                                            (0, 0, np.array([0, 2]))],
        })
        super().__init__([Lx, Ly], site, **kwargs)


class Triangular(SimpleLattice):
    """2D triangular lattice."""

    dim = 2

    def __init__(self, Lx, Ly, site, **kwargs):
        kwargs.setdefault('basis', [[1., 0.], [0.5, 0.5 * np.sqrt(3.)]])
        kwargs.setdefault('pairs', {
            'nearest_neighbors': [(0, 0, np.array([1, 0])),
                                  (0, 0, np.array([0, 1])),
                                  (0, 0, np.array([1, -1]))],
            'next_nearest_neighbors': [(0, 0, np.array([2, -1])),
                                       (0, 0, np.array([1, 1])),
                                       (0, 0, np.array([-1, 2]))],
        })
        super().__init__([Lx, Ly], site, **kwargs)


class Honeycomb(Lattice):
    """2D honeycomb lattice (two-site unit cell), with next-nearest
    neighbours within each sublattice."""

    dim = 2

    def __init__(self, Lx, Ly, sites, **kwargs):
        if isinstance(sites, Site):
            sites = [sites, sites]
        basis = np.array([[1., 0.], [0.5, 0.5 * np.sqrt(3.)]])
        kwargs.setdefault('basis', basis)
        kwargs.setdefault('positions', np.array([[0., 0.],
                                                 (basis[0] + basis[1]) / 3.]))
        kwargs.setdefault('pairs', {
            'nearest_neighbors': [(0, 1, np.array([0, 0])),
                                  (1, 0, np.array([1, 0])),
                                  (1, 0, np.array([0, 1]))],
            'next_nearest_neighbors': [(0, 0, np.array([1, 0])),
                                       (0, 0, np.array([0, 1])),
                                       (0, 0, np.array([1, -1])),
                                       (1, 1, np.array([1, 0])),
                                       (1, 1, np.array([0, 1])),
                                       (1, 1, np.array([1, -1]))],
        })
        super().__init__([Lx, Ly], sites, **kwargs)


class Kagome(Lattice):
    """2D kagome lattice (three-site unit cell)."""

    dim = 2

    def __init__(self, Lx, Ly, sites, **kwargs):
        if isinstance(sites, Site):
            sites = [sites, sites, sites]
        basis = np.array([[1., 0.], [0.5, 0.5 * np.sqrt(3.)]])
        kwargs.setdefault('basis', basis)
        kwargs.setdefault('positions', np.array([[0., 0.], basis[0] / 2.,
                                                 basis[1] / 2.]))
        kwargs.setdefault('pairs', {
            'nearest_neighbors': [
                (0, 1, np.array([0, 0])), (0, 2, np.array([0, 0])),
                (1, 2, np.array([0, 0])), (1, 0, np.array([1, 0])),
                (2, 0, np.array([0, 1])), (2, 1, np.array([-1, 1]))],
        })
        super().__init__([Lx, Ly], sites, **kwargs)


class MultiSpeciesLattice(Lattice):
    """A :class:`SimpleLattice` with each site replaced by several species
    sites.

    Pair names: ``'<key>'`` and ``'<key>_all-all'`` (every species
    combination), ``'<key>_diag'`` (the same species on both ends),
    ``'<key>_<a>-<b>'``, and ``'onsite_<a>-<b>'`` (``a < b``) and
    ``'onsite_all-all'`` within one site of the simple lattice.
    """

    def __init__(self, simple_lattice, species_sites, species_names=None):
        self.simple_lattice = simple_lattice
        n_sp = len(species_sites)
        if species_names is None:
            species_names = [str(s) for s in range(n_sp)]
        self.species_names = list(species_names)
        unit_cell = list(species_sites) * simple_lattice.Lu
        positions = np.repeat(simple_lattice.position_vectors, n_sp, axis=0)
        pairs = {}
        for name, entries in simple_lattice.pairs.items():
            allall, diag = [], []
            by_sp = {(a, b): [] for a in range(n_sp) for b in range(n_sp)}
            for u1, u2, dx in entries:
                for s1 in range(n_sp):
                    for s2 in range(n_sp):
                        e = (u1 * n_sp + s1, u2 * n_sp + s2, dx)
                        allall.append(e)
                        if s1 == s2:
                            diag.append(e)
                        by_sp[s1, s2].append(e)
            pairs[name] = allall
            pairs[name + '_all-all'] = allall
            pairs[name + '_diag'] = diag
            for (a, b), lst in by_sp.items():
                pairs[f'{name}_{species_names[a]}-{species_names[b]}'] = lst
        zero_dx = np.zeros(simple_lattice.dim, np.intp)
        onsite_all = []
        for u in range(simple_lattice.Lu):
            for a in range(n_sp):
                for b in range(a + 1, n_sp):
                    e = (u * n_sp + a, u * n_sp + b, zero_dx)
                    onsite_all.append(e)
                    pairs.setdefault(
                        f'onsite_{species_names[a]}-{species_names[b]}',
                        []).append(e)
        pairs['onsite_all-all'] = onsite_all
        super().__init__(simple_lattice.Ls, unit_cell,
                         bc=simple_lattice.boundary_conditions,
                         bc_MPS=simple_lattice.bc_MPS,
                         basis=simple_lattice.basis, positions=positions,
                         pairs=pairs)


class IrregularLattice(Lattice):
    """A regular lattice with the sites ``remove`` (lattice indices)
    taken out of its MPS order; everything else is the regular
    lattice's."""

    def __init__(self, regular_lattice, remove=None):
        self.regular_lattice = reg = regular_lattice
        order = reg.order
        if remove is not None:
            remove_set = {tuple(r) for r in np.asarray(remove, int)}
            order = order[[k for k, idx in enumerate(order)
                           if tuple(idx) not in remove_set]]
        for name in ('Ls', 'unit_cell', 'Lu', 'dim', 'shape', 'N_cells',
                     'chinfo', 'bc_MPS', 'bc', 'bc_shift', 'basis',
                     'position_vectors', 'pairs'):
            setattr(self, name, getattr(reg, name))
        self.N_sites = len(order)
        self._order_name = 'irregular'
        self.order = order

    def test_sanity(self):
        assert len(self._order) == self.N_sites


class HelicalLattice(Lattice):
    """A 2D cylinder wound as a helix: with ``bc=['periodic', -1]`` on the
    regular lattice the site at ``(x, Ly-1)`` neighbours ``(x+1, 0)``, so
    the state is invariant under a shift by one lattice unit cell and the
    MPS unit cell holds only ``N_unit_cells`` of them.  The couplings are
    the regular lattice's with ``min(i, j, ...) < N_sites``."""

    def __init__(self, regular_lattice, N_unit_cells):
        reg = regular_lattice
        if isinstance(reg, HelicalLattice):
            raise ValueError("regular_lattice can't itself be helical")
        if reg.dim != 2:
            raise ValueError("HelicalLattice works only for 2D lattices")
        if reg.bc_MPS != 'infinite':
            raise ValueError("HelicalLattice requires bc_MPS='infinite'")
        if tuple(reg.bc_shift[1:]) != (-1,):
            raise ValueError("initialize the regular lattice with "
                             "bc=['periodic', -1] (shifted periodic "
                             "around y)")
        if reg.N_cells % N_unit_cells != 0 or N_unit_cells > reg.N_cells:
            raise ValueError("N_unit_cells incommensurate with the regular "
                             "lattice; increase Lx")
        self.regular_lattice = reg
        self._N_cells_helical = N_unit_cells
        for name in ('Ls', 'unit_cell', 'Lu', 'dim', 'shape', 'chinfo',
                     'bc_MPS', 'bc', 'bc_shift', 'basis', 'position_vectors',
                     'pairs'):
            setattr(self, name, getattr(reg, name))
        self.N_cells = N_unit_cells
        self.N_sites = N_unit_cells * reg.Lu
        self._order_name = 'helical'
        # the regular lattice's C-style order winds ring by ring
        self.order = np.asarray(reg.order, int)[:self.N_sites]

    def test_sanity(self):
        assert len(self._order) == self.N_sites

    def mps2lat_idx(self, i):
        return self.regular_lattice.mps2lat_idx(i)

    def lat2mps_idx(self, lat_idx):
        return self.regular_lattice.lat2mps_idx(lat_idx)

    def mps2lat_values(self, *args, **kwargs):
        raise NotImplementedError("ill-defined on a helix: values repeat "
                                  "with the helical period")

    def possible_couplings(self, u1, u2, dx, strength=None):
        mps_i, mps_j, lat_idx, coupling_shape = \
            self.regular_lattice.possible_couplings(u1, u2, dx)
        keep = np.min([mps_i, mps_j], axis=0) < self.N_sites
        return mps_i[keep], mps_j[keep], lat_idx[keep], coupling_shape

    def possible_multi_couplings(self, ops):
        mps_ijkl, lat_idx, coupling_shape = \
            self.regular_lattice.possible_multi_couplings(ops)
        keep = np.min(mps_ijkl, axis=1) < self.N_sites
        return mps_ijkl[keep, :], lat_idx[keep, :], coupling_shape

    def enlarge_mps_unit_cell(self, factor=2):
        """A helical lattice of ``factor`` times as many unit cells (on a
        longer regular lattice where this one's cannot hold them)."""
        reg = self.regular_lattice
        n = self._N_cells_helical * int(factor)
        if n > reg.N_cells or reg.N_cells % n != 0:
            reg = reg.enlarge_mps_unit_cell(factor)
        return HelicalLattice(reg, n)


def get_lattice(lattice_name):
    """The lattice class of a given name."""
    from ..tools.misc import find_subclass
    return find_subclass(Lattice, lattice_name)
