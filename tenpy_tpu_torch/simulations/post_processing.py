"""Post-processing of a simulation's results.

Port of ``tenpy_tpu/simulations/post_processing.py``: ``DataLoader`` (the
loader a simulation's post-processing functions receive) and
``pp_spectral_function`` (the spectral function of a measured
time-dependent correlation).  ``DataFiles`` (no caller) and the plotting
function ``pp_plot_correlations_on_lattice`` are not ported.
"""

from __future__ import annotations

import numpy as np

from ..tools import io as tio
from ..tools.spectral_function_tools import spectral_function

__all__ = ['DataLoader', 'pp_spectral_function']


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


def pp_spectral_function(data_loader, *, correlation_key='correlation_t',
                         dt=None, **kwargs):
    """``S(k, w)`` of the measured correlation ``correlation_key`` (times
    by rows, sites by columns): a dict with ``spectral_function``, ``k``
    and ``w``; ``dt`` the time between measurements (default ``dt *
    N_steps`` of the algorithm's parameters); ``kwargs`` go to
    :func:`~tenpy_tpu_torch.tools.spectral_function_tools.
    spectral_function`."""
    C_t = data_loader.get_data_m(correlation_key)
    if dt is None:
        alg = data_loader.sim_params.get('algorithm_params', {})
        dt = alg.get('dt', 0.1) * alg.get('N_steps', 1)

    class _Lat1D:
        dim = 1
        Ls = (C_t.shape[1],)
    return spectral_function(C_t, _Lat1D(), dt, **kwargs)
