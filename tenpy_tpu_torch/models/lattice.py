r"""Lattice geometry: unit cell, MPS order, neighbour pairs, couplings.

Port of ``Lattice``, ``get_order``, ``SimpleLattice``, ``Chain``, ``Square``
and ``get_lattice`` from ``tenpy_tpu/models/lattice.py``, with the same
conventions:

* a lattice site is ``(x_0, ..., x_{dim-1}, u)`` with ``u`` indexing the
  unit cell;
* ``order`` is an ``(N_sites, dim+1)`` array: row ``i`` is the lattice index
  of MPS site ``i``;
* ``bc`` per axis is ``'open'`` or ``'periodic'``; for ``bc_MPS='infinite'``
  axis 0 is the infinite direction.
"""

from __future__ import annotations

import itertools

import numpy as np

__all__ = ['Lattice', 'SimpleLattice', 'Chain', 'Square', 'get_lattice',
           'get_order']


class Lattice:
    """Unit cells of sites with an MPS order and neighbour tables.

    Parameters
    ----------
    Ls : list of int
        Extent in each direction.
    unit_cell : list of Site
    order : str
        MPS order: ``'default'`` (C style).
    bc : (list of) {'open', 'periodic'}
    bc_MPS : 'finite' | 'segment' | 'infinite'
    pairs : dict
        Neighbour tables ``{'nearest_neighbors': [(u1, u2, dx), ...], ...}``.
    """

    _valid_bc_MPS = ('finite', 'segment', 'infinite')

    def __init__(self, Ls, unit_cell, order='default', bc='open',
                 bc_MPS='finite', pairs=None):
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
        self.pairs = dict(pairs or {})
        self.order = self.ordering(order)

    def _set_bc(self, bc):
        if isinstance(bc, str):
            bc = [bc] * self.dim
        bc = list(bc)
        if len(bc) != self.dim:
            raise ValueError("bc length != dim")
        self.bc = np.zeros(self.dim, bool)     # True = open
        for a, b in enumerate(bc):
            if b not in ('open', 'periodic'):
                raise ValueError(f"invalid bc entry {b!r}")
            self.bc[a] = b == 'open'
        if self.bc_MPS == 'infinite' and self.bc[0]:
            raise ValueError("bc_MPS='infinite' requires periodic bc along "
                             "axis 0")

    def ordering(self, order):
        """The ``(N_sites, dim+1)`` MPS order array (C style)."""
        if isinstance(order, np.ndarray):
            return order
        if order in ('default', 'Cstyle'):
            return get_order(self.shape)
        raise NotImplementedError(f"ordering {order!r} is not ported")

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
        """The sites in MPS order (length ``N_sites``)."""
        return [self.unit_cell[lat_idx[-1]] for lat_idx in self._order]

    def lat2mps_idx(self, lat_idx):
        """Lattice index -> MPS index (infinite bc: shifted by whole unit
        cells)."""
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
                lat[:, a] -= np.floor_divide(lat[:, a], La) * La
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

    def possible_couplings(self, u1, u2, dx):
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

    def __repr__(self):
        return (f"{self.__class__.__name__}({list(self.Ls)}, "
                f"bc_MPS={self.bc_MPS!r})")


def get_order(shape):
    """C-style enumeration of a hypercubic index set."""
    return np.array(list(itertools.product(*[range(n) for n in shape])), int)


class SimpleLattice(Lattice):
    """Lattice with a single-site unit cell."""

    def __init__(self, Ls, site, **kwargs):
        super().__init__(Ls, [site], **kwargs)


class Chain(SimpleLattice):
    """1D chain."""

    dim = 1

    def __init__(self, L, site, **kwargs):
        kwargs.setdefault('pairs', {
            'nearest_neighbors': [(0, 0, np.array([1]))],
            'next_nearest_neighbors': [(0, 0, np.array([2]))],
            'next_next_nearest_neighbors': [(0, 0, np.array([3]))],
        })
        super().__init__([L], site, **kwargs)


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


def get_lattice(lattice_name):
    """The lattice class of a given name."""
    from ..tools.misc import find_subclass
    return find_subclass(Lattice, lattice_name)
