"""Probability calibration (port of ``pd_fusion/models/calibrate.py``).

``IsotonicRegression`` is a numpy/scipy copy of scikit-learn's
``IsotonicRegression(out_of_bounds="clip")`` (increasing): the JAX
package calibrates with scikit-learn, and the port runs where
scikit-learn is not installed. It reproduces scikit-learn's steps — sort
by (X, y), average targets of X values closer than the dtype's
resolution, pool adjacent violators (``scipy.optimize.
isotonic_regression``, which scikit-learn itself calls), drop interior
points of flat runs, clip to the fitted X range and interpolate linearly
(``scipy.interpolate.interp1d``) — so calibrated probabilities match the
JAX package's (held against scikit-learn in the tests).

``CalibratedModel`` wraps a base model with isotonic calibration;
``__getattr__`` delegates to the base model. Platt scaling is not ported.
"""
import pickle

import numpy as np
from scipy import interpolate, optimize


def _make_unique(X, y, w):
    """Average targets for duplicate X (X sorted), in X's dtype; values
    closer than the dtype's resolution count as duplicates."""
    dtype = X.dtype.type
    eps = dtype(np.finfo(X.dtype).resolution)
    xs, ys, ws = [], [], []
    cur_x, cur_y, cur_w = X[0], dtype(0), dtype(0)
    for x, yy, ww in zip(X, y, w):
        if x - cur_x >= eps:
            xs.append(cur_x)
            ws.append(cur_w)
            ys.append(cur_y / cur_w)
            cur_x, cur_w, cur_y = x, ww, yy * ww
        else:
            cur_w = cur_w + ww
            cur_y = cur_y + yy * ww
    xs.append(cur_x)
    ws.append(cur_w)
    ys.append(cur_y / cur_w)
    return (np.asarray(xs, X.dtype), np.asarray(ys, X.dtype), np.asarray(ws, X.dtype))


class IsotonicRegression:
    """Increasing isotonic fit of y on 1-D X; ``transform`` clips to the
    fitted X range and interpolates linearly."""

    def fit(self, X, y):
        X = np.asarray(X)
        if X.dtype not in (np.float32, np.float64):
            X = X.astype(np.float64)
        X = X.reshape(-1)
        y = np.asarray(y, dtype=X.dtype).reshape(-1)
        if len(X) != len(y):
            raise ValueError(f"X and y lengths differ: {len(X)} vs {len(y)}")
        w = np.ones_like(X)
        order = np.lexsort((y, X))
        X, y, w = X[order], y[order], w[order]
        X, y, w = _make_unique(X, y, w)
        y = np.asarray(optimize.isotonic_regression(y=y, weights=w, increasing=True).x,
                       dtype=X.dtype)
        self.X_min_, self.X_max_ = np.min(X), np.max(X)
        # keep the first and last point of every flat run
        keep = np.ones((len(y),), dtype=bool)
        keep[1:-1] = np.logical_or(np.not_equal(y[1:-1], y[:-2]), np.not_equal(y[1:-1], y[2:]))
        self.X_thresholds_, self.y_thresholds_ = X[keep], y[keep]
        return self

    def transform(self, T):
        T = np.asarray(T, dtype=self.X_thresholds_.dtype).reshape(-1)
        T = np.clip(T, self.X_min_, self.X_max_)
        if len(self.y_thresholds_) == 1:
            res = self.y_thresholds_.repeat(T.shape)
        else:
            res = interpolate.interp1d(
                self.X_thresholds_, self.y_thresholds_, kind="linear", bounds_error=False
            )(T)
        return res.astype(T.dtype)

    predict = transform


class CalibratedModel:
    def __init__(self, base_model, method="isotonic"):
        if method != "isotonic":
            raise NotImplementedError(
                f"calibration method '{method}' is not ported to pd_fusion_torch (isotonic only)"
            )
        self.base_model = base_model
        self.method = method
        self.calibrator = None

    def fit(self, X_val, y_val, masks_val=None):
        if not hasattr(self.base_model, "predict_proba"):
            raise ValueError("Base model must have predict_proba")
        preds = np.asarray(self.base_model.predict_proba(X_val, masks_val)).ravel()
        self.calibrator = IsotonicRegression().fit(preds, y_val)

    def predict_proba(self, X, masks=None):
        preds = np.asarray(self.base_model.predict_proba(X, masks)).ravel()
        if self.calibrator is None:
            return preds
        return self.calibrator.transform(preds)

    def __getattr__(self, name):
        # delegate e.g. mask_dim to the wrapped model — but never dunders,
        # and never before __init__/__setstate__ populated __dict__
        # (pickle probes attributes on a bare instance; unconditional
        # delegation recurses forever through self.base_model).
        if name.startswith("__") or "base_model" not in self.__dict__:
            raise AttributeError(name)
        return getattr(self.base_model, name)

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @classmethod
    def load(cls, path):
        with open(path, "rb") as f:
            return pickle.load(f)
