"""Access to a simulation's results for post-processing.

Port of ``DataLoader`` of ``tenpy_tpu/simulations/post_processing.py``:
the loader a simulation's post-processing functions receive.  The
post-processing functions themselves (``pp_spectral_function``,
``pp_plot_correlations_on_lattice``) and ``DataFiles`` are not ported
yet.
"""

from __future__ import annotations

import numpy as np

from ..tools import io as tio

__all__ = ['DataLoader']


class DataLoader:
    """One results file (or a results dict) with access to its
    measurements, parameters and lattice."""

    def __init__(self, filename=None, data=None):
        self.filename = filename
        self._data = data if data is not None else tio.load(filename)
        self._lat = None

    @property
    def measurements(self):
        return self._data.get('measurements', {})

    @property
    def sim_params(self):
        return self._data.get('simulation_parameters', {})

    def get_data_m(self, key):
        return np.asarray(self.measurements[key])

    def get_data(self, key, default=None):
        return self._data.get(key, default)

    def __getitem__(self, key):
        return self._data[key]

    def keys(self):
        return self._data.keys()

    @property
    def lat(self):
        """The simulation's lattice, rebuilt from the saved model
        parameters."""
        if self._lat is None:
            from ..models.model import Model
            from ..tools.misc import find_subclass
            cls = find_subclass(Model, self.sim_params['model_class'])
            self._lat = cls(dict(self.sim_params.get('model_params',
                                                     {}))).lat
        return self._lat

