"""Models of the PyTorch port (see the package docstring); importing the
package loads every model, so that a simulation finds them by name."""
from . import lattice, model
from . import hubbard, hofstadter, spins, tf_ising, xxz_chain

__all__ = ['lattice', 'model', 'hubbard', 'hofstadter', 'spins', 'tf_ising',
           'xxz_chain']
