"""networks of the PyTorch port (see the package docstring); importing the
package loads the MPS, its purification and the momentum MPS of the
plane-wave excitations, so that a simulation or a saved file finds them by
name."""
from . import mps, purification_mps, momentum_mps

__all__ = ['mps', 'purification_mps', 'momentum_mps']
