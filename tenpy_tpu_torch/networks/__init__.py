"""networks of the PyTorch port (see the package docstring); importing the
package loads the MPS and its purification, so that a simulation or a
saved file finds them by name."""
from . import mps, purification_mps

__all__ = ['mps', 'purification_mps']
