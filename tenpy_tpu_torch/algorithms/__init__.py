"""Algorithms of the PyTorch port (see the package docstring); importing
the package loads the DMRG engines, the time evolutions (TEBD, TDVP, MPO
evolution) and exact diagonalization, so that a simulation finds them by
name."""
from . import algorithm, mps_common, dmrg, exact_diag, tebd, tdvp, \
    mpo_evolution

__all__ = ['algorithm', 'mps_common', 'dmrg', 'exact_diag', 'tebd', 'tdvp',
           'mpo_evolution']
