"""Linear prediction: a time series extended by a fit of decaying and
oscillating modes (for spectral functions).

Port of ``tenpy_tpu/tools/prediction.py`` (numpy on the host).
"""

from __future__ import annotations

import numpy as np

__all__ = ['linear_prediction', 'simple_linear_prediction_1d', 'get_lpc', 'get_alpha_and_c']


def linear_prediction(x, *args, axis=0, **kwargs):
    """Apply 1D linear prediction along `axis` of an ndarray."""
    x = np.asarray(x)
    if x.ndim == 1:
        return simple_linear_prediction_1d(x, *args, **kwargs)
    x_moved = np.moveaxis(x, axis, 0)
    flat = x_moved.reshape(x_moved.shape[0], -1)
    cols = [simple_linear_prediction_1d(flat[:, i], *args, **kwargs)
            for i in range(flat.shape[1])]
    out = np.stack(cols, axis=1).reshape((-1,) + x_moved.shape[1:])
    return np.moveaxis(out, 0, axis)


def simple_linear_prediction_1d(x, rel_prediction_time=1, rel_num_points=0.3,
                                truncation_mode='renormalize', rel_split=0.):
    """Extend a 1D series by `rel_prediction_time * len(x)` predicted points."""
    x = np.asarray(x)
    N = len(x)
    split_idx = int(rel_split * N)
    data = x[split_idx:]
    p = int(rel_num_points * len(data))
    if p < 1:
        raise ValueError("too few points for prediction")
    lpc = get_lpc(data, p)
    alpha, c = get_alpha_and_c(data, lpc, truncation_mode)
    n_pred = int(rel_prediction_time * N)
    preds = np.empty(n_pred, dtype=complex)
    for i in range(n_pred):
        preds[i] = np.sum(c * alpha ** (i + 1))
    return np.concatenate([x, preds if np.iscomplexobj(x) else preds.real])


def get_lpc(x, p):
    """Linear prediction coefficients minimizing the forward-prediction error."""
    x = np.asarray(x)
    N = len(x)
    # autocorrelations
    r = np.array([np.sum(np.conj(x[:N - d]) * x[d:]) for d in range(p + 1)])
    R = np.empty((p, p), dtype=complex)
    for i in range(p):
        for j in range(p):
            R[i, j] = r[abs(i - j)] if i >= j else np.conj(r[abs(i - j)])
    rhs = r[1:p + 1]
    try:
        lpc = np.linalg.solve(R, rhs)
    except np.linalg.LinAlgError:
        lpc = np.linalg.lstsq(R, rhs, rcond=None)[0]
    return lpc


def get_alpha_and_c(x, lpc, truncation_mode='renormalize', epsilon=1e-6):
    """Companion-matrix eigen-decomposition -> modes alpha and coefficients c.

    `truncation_mode`: 'cutoff' drops |alpha|>1 modes, 'renormalize' projects them onto
    the unit circle, 'conjugate' reflects them inside.
    """
    p = len(lpc)
    A = np.diag(np.ones(p - 1, dtype=complex), -1)
    A[0, :] = lpc
    alpha, ev = np.linalg.eig(A)
    if truncation_mode == 'cutoff':
        alpha = np.where(np.abs(alpha) > 1, 0., alpha)
    elif truncation_mode == 'renormalize':
        bad = np.abs(alpha) > 1
        alpha = np.where(bad, alpha / np.abs(alpha), alpha)
    elif truncation_mode == 'conjugate':
        bad = np.abs(alpha) > 1
        alpha = np.where(bad, 1. / np.conj(alpha), alpha)
    # fit c by least squares on the last points
    x = np.asarray(x)
    n_fit = min(len(x), 3 * p)
    t = np.arange(len(x) - n_fit, len(x))
    M = alpha[None, :] ** (t[:, None] - (len(x) - 1))
    c = np.linalg.lstsq(M, x[t], rcond=None)[0]
    return alpha, c
