r"""The host side of TEBD: Suzuki-Trotter tables and the bond gates.

Port of ``TEBDEngine.suzuki_trotter_time_steps``,
``TEBDEngine.suzuki_trotter_decomposition`` and ``TEBDEngine._calc_U_bond``
from ``tenpy_tpu/algorithms/tebd.py``, as plain functions: the device engine
(:class:`~tenpy_tpu_torch.algorithms.packed_tebd.DeviceTEBDEngine`) builds
its gates and its brickwall schedule from them.  The host ``TEBDEngine``
itself is not ported.

Convention: ``U_bond[i]`` acts on sites ``(i-1, i)``, like ``H_bond[i]``;
the bonds are updated in odd and even layers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..linalg import np_conserved as npc

__all__ = ['suzuki_trotter_time_steps', 'suzuki_trotter_decomposition',
           'calc_U_bond']


def suzuki_trotter_time_steps(order):
    """The fractions of ``dt`` of the distinct Trotter substeps of
    ``order`` (1, 2, 4 or ``'4_opt'``)."""
    if order == 1:
        return [1.]
    if order == 2:
        return [0.5, 1.]
    if order == 4:
        t1 = 1. / (4. - 4. ** (1 / 3.))
        t3 = 1. - 4. * t1
        return [t1 / 2., t1, (t1 + t3) / 2., t3]
    if order == '4_opt':
        # the optimized fourth order of Barthel and Zhang (11 layers)
        a1 = 0.095848502741203681182
        b1 = 0.42652466131587616168
        a2 = -0.078111158921637922695
        b2 = -0.12039526945509726545
        return [a1, b1, a2, b2, 0.5 - a1 - a2, 1. - 2. * (b1 + b2)]
    raise ValueError(f"unknown order {order!r}")


def suzuki_trotter_decomposition(order, N_steps):
    """The layers of ``N_steps`` Trotter steps: a list of ``(k, odd)``,
    the gates of substep ``k`` (an index into
    :func:`suzuki_trotter_time_steps`) applied to the odd (``odd=1``,
    starting at bond 1) or even bonds.  Adjacent half steps of order 2 and
    4 are merged."""
    even, odd = 0, 1
    if N_steps == 0:
        return []
    if order == 1:
        return [(0, odd), (0, even)] * N_steps
    if order == 2:
        a, a2, b = (0, odd), (1, odd), (1, even)
        return [a, b] + [a2, b] * (N_steps - 1) + [a]
    if order == 4:
        a, a2, b, c, d = (0, odd), (1, odd), (1, even), (2, odd), (3, even)
        steps = [a, b, a2, b, c, d, c, b, a2, b]
        return steps + ([a2] + steps[1:]) * (N_steps - 1) + [a]
    if order == '4_opt':
        steps = [(0, odd), (1, even), (2, odd), (3, even), (4, odd),
                 (5, even), (4, odd), (3, even), (2, odd), (1, even),
                 (0, odd)]
        return steps * N_steps
    raise ValueError(f"unknown order {order!r}")


def calc_U_bond(H_bond, dt, type_evo='real'):
    """The bond gate ``exp(-i dt H_bond)`` (``type_evo='real'``, complex128)
    or ``exp(-dt H_bond)`` (``'imag'``), by a blockwise eigendecomposition
    of ``H_bond`` (legs ``p0, p1, p0*, p1*``).  Returns an Array with the
    legs of ``H_bond``.  (``tenpy_tpu``'s ``E_offset``, which no caller
    passes, is not ported.)"""
    H = H_bond.combine_legs([['p0', 'p1'], ['p0*', 'p1*']], qconj=[+1, -1])
    W, V = npc.eigh(H)
    W = np.asarray(W)
    if type_evo == 'imag':
        diag = np.exp(-dt * W)
    elif type_evo == 'real':
        diag = np.exp(-1j * dt * W)
    else:
        raise ValueError(f"unknown type_evo {type_evo!r}")
    U = V.copy(deep=False)
    if np.iscomplexobj(diag):
        U = U.astype(torch.complex128)
    U = U.iscale_axis(diag, 1)
    U = npc.tensordot(U, V.conj().itranspose([1, 0]), axes=[[1], [0]])
    U.iset_leg_labels(['(p0.p1)', '(p0*.p1*)'])
    return U.split_legs()
