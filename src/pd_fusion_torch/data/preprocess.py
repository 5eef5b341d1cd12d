"""Feature preprocessing (port of ``pd_fusion/data/preprocess.py``).

- ``NaNRobustScaler``: per-column median / IQR computed ignoring NaNs,
  zero IQR replaced with 1; ``transform`` scales and maps NaN to 0 (the
  JAX package's documented reading of the reference, which reproduces the
  reference's committed quickstart run).
- ``preprocess_features(df, feature_cols, imputer, scaler)``: select the
  columns in order (missing ones become NaN, then 0), fit the scaler if
  none is given; a modality with no column at all gives an all-zero block.

The fit and the transform stay numpy and are bit-identical to the JAX
package's: they run once per fold on matrices of hundreds x tens, where a
device round trip costs more than the arithmetic. ``_scale_transform`` is
the same transform as a torch function, for use inside device programs.
"""
from typing import List, Tuple

import numpy as np
import pandas as pd
import torch


def _scale_transform(X: torch.Tensor, medians: torch.Tensor, iqrs: torch.Tensor) -> torch.Tensor:
    scaled = (X - medians) / iqrs
    return torch.where(torch.isnan(scaled), 0.0, scaled)


def _nan_median_quartiles(X: np.ndarray):
    """``np.nanmedian`` + ``np.nanpercentile(X, [25, 75], axis=0)``, bit
    for bit, from one shared column sort (NaNs sort last).

    - quantiles use numpy's lerp with its branch: t<0.5 -> a+(b-a)*t,
      t>=0.5 -> b-(b-a)*(1-t); the upper sample is at ceil(pos), so an
      integral position returns the element exactly;
    - an even-count median is (a+b)/2, as ``np.mean`` of the two middle
      values; an odd-count median is the middle element;
    - empty (all-NaN) columns return NaN.
    """
    X = np.asarray(X, np.float64)
    if X.ndim != 2:
        raise ValueError("expected a 2-D matrix")
    Xs = np.sort(X, axis=0)  # NaNs sort to the end
    n = (~np.isnan(X)).sum(axis=0)
    cols = np.arange(X.shape[1])
    empty = n == 0
    nn = np.maximum(n, 1)  # keeps indices valid on empty columns

    def quantile(q: float):
        pos = q * (nn - 1)
        lo = np.floor(pos).astype(np.int64)
        hi = np.ceil(pos).astype(np.int64)
        t = pos - lo
        a = Xs[lo, cols]
        b = Xs[hi, cols]
        d = b - a
        r = np.where(t < 0.5, a + d * t, b - d * (1.0 - t))
        return np.where(empty, np.nan, r)

    lo_m = (nn - 1) // 2
    hi_m = nn // 2
    med = (Xs[lo_m, cols] + Xs[hi_m, cols]) / 2.0
    med = np.where(lo_m == hi_m, Xs[lo_m, cols], med)  # odd: exact element
    med = np.where(empty, np.nan, med)
    return med, quantile(0.25), quantile(0.75)


class NaNRobustScaler:
    """Median/IQR scaler that ignores NaNs when fitting and zero-fills
    NaNs on transform."""

    def __init__(self):
        self.medians = None
        self.iqrs = None

    def fit(self, X: np.ndarray):
        with np.errstate(all="ignore"):
            self.medians, q25, q75 = _nan_median_quartiles(X)
        # all-NaN columns: treat as median 0, IQR 1
        self.medians = np.where(np.isnan(self.medians), 0.0, self.medians)
        iqrs = q75 - q25
        iqrs = np.where(np.isnan(iqrs), 1.0, iqrs)
        iqrs[iqrs == 0] = 1.0
        self.iqrs = iqrs
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        if self.medians is None:
            raise ValueError("Scaler not fitted")
        out = (np.asarray(X, np.float32) - np.float32(self.medians)) / np.float32(self.iqrs)
        return np.where(np.isnan(out), np.float32(0.0), out)


def preprocess_features(
    df: pd.DataFrame,
    feature_cols: List[str],
    imputer=None,
    scaler=None,
    strategy: str = "robust",
) -> Tuple[np.ndarray, object, object]:
    """Select columns (missing ones become NaN -> scaled to 0), fit the
    scaler if not given, and return (X_scaled, None, scaler)."""
    existing = [c for c in feature_cols if c in df.columns]
    if not existing:
        # whole modality absent: all-zero block
        return np.zeros((len(df), len(feature_cols)), dtype=np.float32), imputer, scaler

    X = np.full((len(df), len(feature_cols)), np.nan, dtype=np.float64)
    present = [(j, c) for j, c in enumerate(feature_cols) if c in df.columns]
    # check dtypes, not df[c]: is_numeric_dtype(df[c]) builds a Series per column
    dtypes = df.dtypes
    if all(pd.api.types.is_numeric_dtype(dtypes[c]) for _, c in present):
        # numeric fast path: one block gather
        X[:, [j for j, _ in present]] = df[[c for _, c in present]].to_numpy(np.float64)
    else:
        for j, col in present:
            X[:, j] = pd.to_numeric(df[col], errors="coerce").to_numpy(dtype=np.float64)

    if scaler is None:
        scaler = NaNRobustScaler()
        scaler.fit(X)

    X_scaled = scaler.transform(X)
    return X_scaled, None, scaler
