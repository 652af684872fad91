"""The spectral function S(k, w) from time-dependent correlations C(r, t).

Port of ``tenpy_tpu/tools/spectral_function_tools.py`` (numpy on the
host): :func:`spectral_function` (linear prediction, Gaussian window, the
Fourier transforms in space and time), :func:`fourier_transform_space`,
:func:`fourier_transform_time`, :func:`apply_gaussian_windowing` and
:func:`to_mps_geometry`.  The plotting helper
(``plot_correlations_on_lattice``) is not ported.
"""

from __future__ import annotations

import numpy as np

__all__ = ['spectral_function', 'fourier_transform_space',
           'fourier_transform_time', 'apply_gaussian_windowing',
           'to_mps_geometry']


def spectral_function(time_dep_corr, lat, dt, gaussian_window=False,
                      sigma=0.4, linear_predict=False, rel_prediction_time=1,
                      rel_num_points=0.3, truncation_mode='renormalize',
                      rel_split=0., axis_time=0, axis_space=1):
    """``S(k, w)`` of ``C(t, r)``: optional linear prediction in time,
    optional Gaussian window, the Fourier transforms in space and time.
    Returns a dict with ``spectral_function``, ``k`` and ``w``.

    ``linear_predict`` is TeNPy's name of the option, which the YAML files
    use (``tenpy_tpu`` calls it ``linear_prediction``)."""
    C = np.asarray(time_dep_corr)
    if linear_predict:
        from .prediction import linear_prediction as _lp
        C = _lp(C, rel_prediction_time=rel_prediction_time,
                rel_num_points=rel_num_points,
                truncation_mode=truncation_mode, rel_split=rel_split,
                axis=axis_time)
    if gaussian_window:
        C = apply_gaussian_windowing(C, sigma, axis=axis_time)
    C_k, k = fourier_transform_space(lat, C, axis=axis_space)
    S, w = fourier_transform_time(C_k, dt, axis=axis_time)
    return {'spectral_function': S, 'k': k, 'w': w}


def fourier_transform_space(lat, a, axis=1):
    """FT over the spatial axis, honoring the lattice geometry (1D/2D)."""
    a = np.asarray(a)
    dims = getattr(lat, 'dim', 1)
    if dims == 1:
        ft = np.fft.fftn(a, axes=(axis,))
        k = np.fft.fftfreq(a.shape[axis], d=1.0) * 2 * np.pi
        return np.fft.fftshift(ft, axes=axis), np.fft.fftshift(k)
    # 2D: reshape the MPS axis back into (Lx, Ly) then FT both
    Ls = tuple(lat.Ls)
    shape = a.shape[:axis] + Ls + a.shape[axis + 1:]
    a2 = a.reshape(shape)
    axes = (axis, axis + 1)
    ft = np.fft.fftn(a2, axes=axes)
    kx = np.fft.fftfreq(Ls[0]) * 2 * np.pi
    ky = np.fft.fftfreq(Ls[1]) * 2 * np.pi
    return np.fft.fftshift(ft, axes=axes), (np.fft.fftshift(kx), np.fft.fftshift(ky))


def fourier_transform_time(a, dt, axis=0):
    """FT t -> w with e^{+i w t} convention; returns (a_w, w)."""
    a = np.asarray(a)
    n = a.shape[axis]
    a_w = np.fft.ifft(a, axis=axis) * n * dt
    w = np.fft.fftfreq(n, d=dt) * 2 * np.pi
    idx = np.argsort(w)
    a_w = np.take(a_w, idx, axis=axis)
    return a_w, w[idx]


def apply_gaussian_windowing(a, sigma=0.4, axis=0):
    """Multiply by a half-gaussian window exp(-0.5 (n / (sigma N))^2) along `axis`."""
    a = np.asarray(a)
    n = a.shape[axis]
    window = np.exp(-0.5 * (np.arange(n) / (sigma * n)) ** 2)
    shape = [1] * a.ndim
    shape[axis] = n
    return a * window.reshape(shape)


def to_mps_geometry(lat, a):
    """Bring an array indexed in lattice order to MPS order (reference :181)."""
    mps_idx_flattened = np.ravel_multi_index(tuple(lat.order.T), lat.shape)
    dims_until_lat_dims = a.ndim - (lat.dim + 1)
    if lat.Lu == 1:
        dims_until_lat_dims += 1
    a = a.reshape(a.shape[:dims_until_lat_dims] + (-1,))
    return np.take(a, mps_idx_flattened, axis=-1)
