"""Algorithms of the PyTorch port (see the package docstring); importing
the package loads the DMRG and VUMPS engines, the time evolutions (TEBD,
TDVP, MPO evolution), finite-temperature purification with its
disentanglers and exact diagonalization, so that a simulation finds them
by name."""
from . import algorithm, mps_common, dmrg, exact_diag, tebd, tdvp, \
    mpo_evolution, vumps, disentangler, purification

__all__ = ['algorithm', 'mps_common', 'dmrg', 'exact_diag', 'tebd', 'tdvp',
           'mpo_evolution', 'vumps', 'disentangler', 'purification']
