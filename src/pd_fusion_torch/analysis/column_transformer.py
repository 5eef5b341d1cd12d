"""The tabular sweep's preprocessing as numpy (the card's machine has no
scikit-learn): the scikit-learn ``ColumnTransformer`` of
``scripts/ppmi_train_tabular.py:50-70``, value for value.

- numeric columns: ``SimpleImputer(strategy="median", add_indicator=True)``,
  then ``StandardScaler`` when scaling;
- categorical columns: ``SimpleImputer(strategy="most_frequent")``, then
  ``OneHotEncoder(handle_unknown="ignore")`` (dense);
- output: the numeric block, then the categorical block, float64.

Numeric columns are read as float64: a frame read from CSV has no float32
column (scikit-learn would keep an all-float32 block in float32).

scikit-learn's details that change the numbers, kept:

- a column with no observed value in train has no median and is dropped
  from the imputed block; its missing indicator stays. Indicators exist
  for the columns that had a NaN in train, in column order;
- the median is ``np.ma.median`` over the observed values;
- the most frequent value breaks ties by the smallest value (by
  ``(type name, str)`` where values do not compare); a categorical column
  with no observed value in train is dropped;
- one-hot categories are the sorted train values; an unseen value encodes
  to all zeros;
- the scaler's mean is the column sum over n, its variance the corrected
  two-pass sum of squares over n, both in the order numpy sums the array's
  layout (as scikit-learn's ``_incremental_mean_and_var`` does on a first
  fit); a column whose variance is within rounding of zero keeps scale 1.
"""
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import pandas as pd


def _numeric_matrix(frame: pd.DataFrame) -> np.ndarray:
    """A float64 copy in the layout scikit-learn's ``check_array`` gives a
    frame: pandas' column-major blocks are kept, because the scaler's
    column sums round by the layout its input has."""
    return np.array(np.asarray(frame, dtype=np.float64), copy=True)


def _safe_min(items):
    try:
        return min(items)
    except TypeError:
        return min(items, key=lambda x: (str(type(x)), str(x)))


def _most_frequent(values: np.ndarray):
    """The mode of an object column's observed values, ties to the
    smallest; NaN for an empty column."""
    if values.size == 0:
        return np.nan
    counter = Counter(values)
    top = counter.most_common(1)[0][1]
    return _safe_min([v for v, c in counter.items() if c == top])


class StandardScaling:
    """``StandardScaler`` fitted once on a dense float64 matrix."""

    def fit(self, X: np.ndarray) -> "StandardScaling":
        n = X.shape[0]
        new_sum = np.sum(X, axis=0)
        count = n - np.sum(np.isnan(X).astype(X.dtype), axis=0)
        self.mean_ = new_sum / count
        temp = X - new_sum / count
        correction = np.sum(temp, axis=0)
        temp **= 2
        unnormalized = np.sum(temp, axis=0)
        unnormalized -= correction ** 2 / count
        self.var_ = unnormalized / count
        eps = np.finfo(np.float64).eps
        constant = self.var_ <= n * eps * self.var_ + (n * self.mean_ * eps) ** 2
        scale = np.sqrt(self.var_)
        scale[constant] = 1.0
        self.scale_ = scale
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        X = np.array(X, dtype=np.float64, copy=True)
        X -= self.mean_
        X /= self.scale_
        return X


class NumericBlock:
    """Median impute with missing indicators (``add_indicator``), then
    optional scaling. Without indicators the imputed matrix keeps the
    frame's layout, as scikit-learn's imputer returns it."""

    def __init__(self, scale: bool, add_indicator: bool = True):
        self.scale = scale
        self.add_indicator = add_indicator
        self.scaler: Optional[StandardScaling] = None

    def _impute(self, X: np.ndarray) -> np.ndarray:
        mask = np.isnan(X)
        if not self.valid.all():
            X = X[:, np.flatnonzero(self.valid)]
            mask_valid = mask[:, np.flatnonzero(self.valid)]
        else:
            mask_valid = mask
        values = np.repeat(self.statistics[self.valid], np.sum(mask_valid, axis=0))
        X[np.where(mask_valid.transpose())[::-1]] = values
        if not self.add_indicator:
            return X
        # the indicator block as MissingIndicator makes it (the whole mask
        # when every column had a NaN, an empty block when none had), always
        # stacked on: the stacked array's layout is the scaler's input layout
        ind = mask if self.indicator.size == mask.shape[1] else mask[:, self.indicator]
        return np.hstack((X, ind))

    def fit_transform(self, frame: pd.DataFrame) -> np.ndarray:
        X = _numeric_matrix(frame)
        mask = np.isnan(X)
        median = np.ma.median(np.ma.masked_array(X, mask=mask), axis=0)
        self.statistics = np.ma.getdata(median).copy()
        self.statistics[np.ma.getmaskarray(median)] = np.nan
        self.valid = ~np.isnan(self.statistics)
        self.indicator = np.flatnonzero(mask.sum(axis=0))
        out = self._impute(X)
        if self.scale:
            self.scaler = StandardScaling().fit(out)
            out = self.scaler.transform(out)
        return out

    def transform(self, frame: pd.DataFrame) -> np.ndarray:
        out = self._impute(_numeric_matrix(frame))
        return self.scaler.transform(out) if self.scale else out


class CategoricalBlock:
    """Most-frequent impute, then one-hot with unseen values ignored."""

    def _impute(self, frame: pd.DataFrame) -> np.ndarray:
        X = np.asarray(frame, dtype=object).copy()
        mask = X != X  # NaN is the missing marker of an object column
        X = X[:, np.flatnonzero(self.valid)]
        mask = mask[:, np.flatnonzero(self.valid)]
        for j, value in enumerate(self.statistics[self.valid]):
            X[mask[:, j], j] = value
        return X

    def _encode(self, X: np.ndarray) -> np.ndarray:
        blocks = []
        for j, cats in enumerate(self.categories_):
            codes = {v: i for i, v in enumerate(cats)}
            block = np.zeros((X.shape[0], len(cats)), np.float64)
            for r, v in enumerate(X[:, j]):
                i = codes.get(v)
                if i is not None:
                    block[r, i] = 1.0
            blocks.append(block)
        return np.hstack(blocks) if blocks else np.zeros((X.shape[0], 0))

    def fit_transform(self, frame: pd.DataFrame) -> np.ndarray:
        X = np.asarray(frame, dtype=object)
        mask = X != X
        stats = np.empty(X.shape[1], dtype=object)
        for j in range(X.shape[1]):
            stats[j] = _most_frequent(X[~mask[:, j], j])
        self.statistics = stats
        self.valid = np.array([not (isinstance(v, float) and np.isnan(v)) for v in stats], bool)
        imputed = self._impute(frame)
        self.categories_ = [sorted(set(imputed[:, j])) for j in range(imputed.shape[1])]
        return self._encode(imputed)

    def transform(self, frame: pd.DataFrame) -> np.ndarray:
        return self._encode(self._impute(frame))


class SuiteColumnTransformer:
    """``build_preprocessor(scale, numeric_cols, cat_cols)`` of the JAX
    sweep script: ``fit_transform(df)`` on train, ``transform(df)`` on the
    other parts. An empty column list contributes no block."""

    def __init__(self, scale: bool, numeric_cols: Sequence[str], cat_cols: Sequence[str]):
        self.blocks = [(block, list(cols)) for block, cols in (
            (NumericBlock(scale), numeric_cols), (CategoricalBlock(), cat_cols)) if cols]

    def fit_transform(self, df: pd.DataFrame) -> np.ndarray:
        return np.hstack([block.fit_transform(df[cols]) for block, cols in self.blocks])

    def transform(self, df: pd.DataFrame) -> np.ndarray:
        return np.hstack([block.transform(df[cols]) for block, cols in self.blocks])
