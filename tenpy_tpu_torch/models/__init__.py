"""Models of the PyTorch port (see the package docstring); importing the
package loads every model, so that a simulation finds them by name."""
from . import lattice, model
from . import (aklt, clock, fermions_spinless, haldane, hofstadter, hubbard,
               mixed_xk, molecular, pxp, spins, spins_nnn, tf_ising,
               tj_model, toric_code, xxz_chain)

__all__ = ['lattice', 'model', 'aklt', 'clock', 'fermions_spinless',
           'haldane', 'hofstadter', 'hubbard', 'mixed_xk', 'molecular', 'pxp',
           'spins', 'spins_nnn', 'tf_ising', 'tj_model', 'toric_code',
           'xxz_chain']
