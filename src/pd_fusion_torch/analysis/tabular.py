"""Shared tabular-analysis tier for the PPMI script suites (port of
``pd_fusion/analysis/tabular.py``).

Host helpers, copied: the logging bootstrap, numeric coercion, regex
feature selection, ``TabularPrep`` (train-fitted median impute +
missing-indicator append + population z-score), ``CovariateCodec``,
``residualize_features`` (one ``lstsq``), ``site_zscore``, the L/R
asymmetry helpers and ``paired_fold_ttest``.

Device programs, as torch ops on the port's device:

- ``rank_univariate_auc``: one batched tie-aware ROC-AUC over the rows of
  the [F, N] column matrix (``ops/metrics.py::roc_auc``), the JAX
  package's ``lax.map`` of ``roc_auc``;
- ``permutation_screen``: every repeat's linear probe trains at once on
  the stacked-model axis of ``nn/trainer.py::fullbatch_impl`` (dropout 0,
  weight decay 0: deterministic), and the held-out AUCs come out of the
  same batched AUC;
- ``boosted_tree``: ``nn/gbdt.py::DeviceHistGBDT`` with the suites'
  hyperparameters (300 trees, lr 0.05, 31 leaves, balanced classes) when
  ``resolve_gbdt_backend`` picks the device (the default on the card), else
  scikit-learn's ``HistGradientBoostingClassifier`` (the JAX package's
  stand-in where LightGBM is absent, which it is on both machines);
  ``fit_boosted_trees`` fits several device models as one fold-batched
  ``train_gbdt`` call;
- ``balanced_logreg``: ``nn/logreg.py::BalancedLogisticRegression``,
  scikit-learn's ``LogisticRegression(class_weight="balanced")`` solved to
  its optimum on the device.

The card's machine has no scikit-learn: only the host GBDT backend imports
it, at its call.

Behavioral deviations (the JAX package's, kept): a feature column that is
entirely NaN inside a train fold is imputed with 0.0 and kept (sklearn
silently drops it, desynchronizing the feature-name list the suites write).
"""
import logging
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from pd_fusion_torch.utils.device import get_device

__all__ = [
    "suite_logger",
    "coerce_numeric",
    "match_any",
    "grep_columns",
    "numeric_feature_columns",
    "rank_univariate_auc",
    "permutation_screen",
    "TabularPrep",
    "CovariateCodec",
    "residualize_features",
    "site_zscore",
    "asymmetry_pairs",
    "with_asymmetry",
    "boosted_tree",
    "fit_boosted_trees",
    "balanced_logreg",
    "paired_fold_ttest",
]


# ---------------------------------------------------------------------------
# logging / column selection
# ---------------------------------------------------------------------------


def suite_logger(name: str, out_dir: Path, filename: Optional[str] = None) -> logging.Logger:
    """Console + per-run-directory file logger. Asked again for the same
    file it is unchanged; asked for another file (a second run in one
    process) its handlers move there."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    return _file_and_console(name, out_dir / (filename or f"{name}.log"),
                             "%(asctime)s %(levelname)-7s %(message)s")


def _file_and_console(name: str, path: Path, fmt: str) -> logging.Logger:
    log = logging.getLogger(name)
    log.setLevel(logging.INFO)
    target = str(path.resolve())
    if any(getattr(h, "baseFilename", None) == target for h in log.handlers):
        return log
    for h in list(log.handlers):
        log.removeHandler(h)
        h.close()
    formatter = logging.Formatter(fmt)
    for h in (logging.StreamHandler(), logging.FileHandler(path)):
        h.setFormatter(formatter)
        log.addHandler(h)
    return log


def coerce_numeric(df: pd.DataFrame, cols: Sequence[str]) -> pd.DataFrame:
    """Columns as float frames; non-numeric cells become NaN."""
    if not cols:
        return pd.DataFrame(index=df.index)
    return df.loc[:, list(cols)].apply(pd.to_numeric, errors="coerce")


def match_any(text: str, patterns: Iterable[str]) -> bool:
    return any(re.search(p, text, re.IGNORECASE) for p in patterns)


def grep_columns(
    cols: Sequence[str],
    allow: Optional[Sequence[str]] = None,
    deny: Optional[Sequence[str]] = None,
) -> List[str]:
    """Regex allow/deny filter over column names (case-insensitive)."""
    out = list(cols)
    if allow:
        out = [c for c in out if match_any(c, allow)]
    if deny:
        out = [c for c in out if not match_any(c, deny)]
    return out


def numeric_feature_columns(
    df: pd.DataFrame,
    deny_patterns: Sequence[str],
    id_cols: Iterable[str],
    label_col: str = "label",
) -> List[str]:
    """Candidate feature set: numeric-coercible, at least one observed
    value, not an ID/label column, not matching a deny pattern."""
    skip = set(id_cols) | {label_col}
    pool = grep_columns([c for c in df.columns if c not in skip], deny=deny_patterns)
    values = coerce_numeric(df, pool)
    return [c for c in pool if values[c].notna().any()]


# ---------------------------------------------------------------------------
# device screening programs
# ---------------------------------------------------------------------------


def rank_univariate_auc(
    df: pd.DataFrame, y: np.ndarray, feature_cols: Sequence[str], top_k: int = 20
) -> List[Tuple[str, float]]:
    """Per-feature ROC-AUC of the raw column as a score, ranked by
    distance from chance: one batched tie-aware AUC over the rows of the
    [F, N] column matrix on the device."""
    from pd_fusion_torch.ops.metrics import roc_auc

    frame = coerce_numeric(df, feature_cols)
    mat = frame.fillna(frame.median()).to_numpy(np.float32)
    usable = [j for j in range(mat.shape[1]) if np.isfinite(mat[:, j]).all()]
    if not usable:
        return []
    dev = get_device()
    labels = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    cols = torch.as_tensor(np.ascontiguousarray(mat[:, usable].T), device=dev)
    aucs = roc_auc(labels, cols).cpu().numpy()
    ranked = sorted(
        ((feature_cols[j], float(a)) for j, a in zip(usable, aucs)),
        key=lambda pair: abs(pair[1] - 0.5),
        reverse=True,
    )
    return ranked[:top_k]


def permutation_inputs(df: pd.DataFrame, feature_cols: Sequence[str], repeats: int,
                       base_seed: int):
    """The permutation screen's host draws, as the JAX package makes them:
    per repeat a ``RandomState(base_seed + r)`` shuffles the labels, then
    the rows (the first 20% held out), and balanced weights for the train
    part. -> (X_tr, y_tr, w_tr, X_te, y_te), float32 [R, ...]."""
    raw = coerce_numeric(df, feature_cols).fillna(0.0).to_numpy(np.float32)
    # standardize for optimizer conditioning (affine => AUC-invariant)
    center = raw.mean(axis=0)
    spread = raw.std(axis=0)
    spread[spread == 0.0] = 1.0
    X = (raw - center) / spread
    y = np.asarray(df["label"].to_numpy(), np.float32)
    n, d = X.shape
    n_test = max(1, int(round(n * 0.2)))
    n_train = n - n_test

    y_tr = np.empty((repeats, n_train), np.float32)
    y_te = np.empty((repeats, n_test), np.float32)
    X_tr = np.empty((repeats, n_train, d), np.float32)
    X_te = np.empty((repeats, n_test, d), np.float32)
    w_tr = np.empty((repeats, n_train), np.float32)
    for r in range(repeats):
        rng = np.random.RandomState(base_seed + r)
        shuffled = rng.permutation(y)
        order = rng.permutation(n)
        tr, te = order[n_test:], order[:n_test]
        y_tr[r], y_te[r] = shuffled[tr], shuffled[te]
        X_tr[r], X_te[r] = X[tr], X[te]
        pos = max(y_tr[r].sum(), 1.0)
        neg = max(n_train - y_tr[r].sum(), 1.0)
        # torch/sklearn "balanced": weight_c = n / (2 * n_c)
        w_tr[r] = np.where(y_tr[r] > 0.5, n_train / (2.0 * pos), n_train / (2.0 * neg))
    return X_tr, y_tr, w_tr, X_te, y_te


def permutation_screen(
    df: pd.DataFrame,
    feature_cols: Sequence[str],
    repeats: int = 5,
    base_seed: int = 42,
    epochs: int = 80,
    lr: float = 0.05,
) -> List[Dict[str, float]]:
    """Label-permutation sanity check: with shuffled labels a linear
    probe must score ~chance AUC. Every repeat's probe (linear BCE model,
    full-batch Adam, balanced sample weights) trains at once, one model of
    a stack per repeat, and the held-out AUCs are one batched AUC."""
    from pd_fusion_torch.nn.trainer import fullbatch_impl
    from pd_fusion_torch.ops.metrics import roc_auc

    dev = get_device()
    X_tr, y_tr, w_tr, X_te, y_te = (
        torch.as_tensor(a, device=dev)
        for a in permutation_inputs(df, feature_cols, repeats, base_seed))
    d = X_tr.shape[-1]
    probe = [{"w": torch.zeros((repeats, d, 1), device=dev),
              "b": torch.zeros((repeats, 1), device=dev)}]
    fitted = fullbatch_impl(probe, X_tr, y_tr, w_tr, None, lr, epochs, 0.0, 0.0)
    scores = torch.bmm(X_te, fitted[0]["w"])[..., 0] + fitted[0]["b"]
    aucs = roc_auc(y_te, scores).cpu().numpy()
    return [{"repeat": r + 1, "roc_auc": float(a)} for r, a in enumerate(aucs)]


# ---------------------------------------------------------------------------
# fitted preprocessing (impute + indicators + z-score)
# ---------------------------------------------------------------------------


class TabularPrep:
    """Train-fitted median impute + missing-indicator append + optional
    population z-score over the full matrix (indicators included), the
    reference suites' SimpleImputer/StandardScaler stack as one object."""

    def __init__(self, scale: bool = True, add_indicators: bool = True):
        self.scale = scale
        self.add_indicators = add_indicators
        self.columns: List[str] = []
        self.medians: Optional[np.ndarray] = None
        self.indicator_idx: List[int] = []
        self.mu: Optional[np.ndarray] = None
        self.sigma: Optional[np.ndarray] = None

    def fit(self, df: pd.DataFrame, feature_cols: Sequence[str]) -> "TabularPrep":
        self.columns = list(feature_cols)
        raw = coerce_numeric(df, self.columns).to_numpy(np.float64)
        with np.errstate(all="ignore"):
            med = np.nanmedian(raw, axis=0)
        self.medians = np.where(np.isfinite(med), med, 0.0)
        self.indicator_idx = (
            np.flatnonzero(np.isnan(raw).any(axis=0)).tolist() if self.add_indicators else []
        )
        full = self._assemble(raw)
        if self.scale:
            self.mu = full.mean(axis=0)
            sig = full.std(axis=0)  # population std, like StandardScaler
            sig[sig == 0.0] = 1.0
            self.sigma = sig
        return self

    def _assemble(self, raw: np.ndarray) -> np.ndarray:
        filled = np.where(np.isnan(raw), self.medians, raw)
        if not self.indicator_idx:
            return filled
        flags = np.isnan(raw[:, self.indicator_idx]).astype(np.float64)
        return np.concatenate([filled, flags], axis=1)

    def transform(self, df: pd.DataFrame) -> np.ndarray:
        raw = coerce_numeric(df, self.columns).to_numpy(np.float64)
        full = self._assemble(raw)
        if self.scale:
            full = (full - self.mu) / self.sigma
        return full

    def fit_transform(self, df: pd.DataFrame, feature_cols: Sequence[str]) -> np.ndarray:
        return self.fit(df, feature_cols).transform(df)

    @property
    def feature_names(self) -> List[str]:
        return self.columns + [f"{self.columns[j]}_missing" for j in self.indicator_idx]


# ---------------------------------------------------------------------------
# covariate residualization + harmonization
# ---------------------------------------------------------------------------


class CovariateCodec:
    """Design matrix for nuisance covariates: numeric columns median-
    filled per encoded frame (the reference's behavior — each frame uses
    its own medians), categoricals one-hot against the level set frozen
    at fit (unseen levels encode to all-zero, like handle_unknown=
    'ignore')."""

    def __init__(self, numeric: Sequence[str], categorical: Sequence[str]):
        self.numeric = list(numeric)
        self.categorical = list(categorical)
        self.levels: Dict[str, List[str]] = {}

    def fit(self, df: pd.DataFrame) -> "CovariateCodec":
        for col in self.categorical:
            if col in df.columns:
                vals = df[col].astype(str).fillna("UNKNOWN")
                self.levels[col] = sorted(vals.unique())
        return self

    def transform(self, df: pd.DataFrame) -> np.ndarray:
        parts: List[np.ndarray] = []
        for col in self.numeric:
            if col not in df.columns:
                continue
            v = pd.to_numeric(df[col], errors="coerce")
            parts.append(v.fillna(v.median()).to_numpy(np.float64)[:, None])
        for col, levels in self.levels.items():
            if col not in df.columns:
                continue
            vals = df[col].astype(str).fillna("UNKNOWN").to_numpy()
            parts.append((vals[:, None] == np.asarray(levels)[None, :]).astype(np.float64))
        if not parts:
            return np.zeros((len(df), 0))
        return np.concatenate(parts, axis=1)

    @property
    def width(self) -> int:
        return len(self.numeric) + sum(len(v) for v in self.levels.values())


def residualize_features(
    train_df: pd.DataFrame,
    test_df: pd.DataFrame,
    feature_cols: Sequence[str],
    numeric_covs: Sequence[str],
    categorical_covs: Sequence[str],
) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """Regress the covariates out of every feature at once: OLS betas via
    a single lstsq on the TRAIN design matrix (intercept appended), then
    subtract the fit from train and test. Equivalent to the reference's
    per-suite LinearRegression (ppmi_imaging_upgrade.py:199-232) —
    multi-target least squares with train-only fitting."""
    cols = list(feature_cols)
    if not cols:
        return train_df, test_df
    codec = CovariateCodec(numeric_covs, categorical_covs).fit(train_df)
    C_tr, C_te = codec.transform(train_df), codec.transform(test_df)
    if C_tr.shape[1] == 0:
        return train_df, test_df

    F_tr = coerce_numeric(train_df, cols)
    F_te = coerce_numeric(test_df, cols)
    fill = F_tr.median()
    F_tr = F_tr.fillna(fill).to_numpy(np.float64)
    F_te = F_te.fillna(fill).to_numpy(np.float64)

    ones_tr = np.ones((len(C_tr), 1))
    ones_te = np.ones((len(C_te), 1))
    D_tr = np.concatenate([C_tr, ones_tr], axis=1)
    D_te = np.concatenate([C_te, ones_te], axis=1)
    beta, *_ = np.linalg.lstsq(D_tr, F_tr, rcond=None)

    out_tr, out_te = train_df.copy(), test_df.copy()
    out_tr[cols] = F_tr - D_tr @ beta
    out_te[cols] = F_te - D_te @ beta
    return out_tr, out_te


def site_zscore(
    train_df: pd.DataFrame,
    test_df: pd.DataFrame,
    feature_cols: Sequence[str],
    site_col: str,
) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """Per-site z-score re-expressed in the global train distribution:
    x -> (x - site_mean) / site_std * global_std + global_mean. Sites
    unseen at train fall back to the global stats."""
    if site_col not in train_df.columns:
        return train_df, test_df
    cols = list(feature_cols)
    F_tr = coerce_numeric(train_df, cols)
    F_te = coerce_numeric(test_df, cols)
    g_mu, g_sd = F_tr.mean(), F_tr.std().replace(0, 1.0)

    per_site: Dict[object, Tuple[pd.Series, pd.Series]] = {}
    for site, rows in train_df.groupby(site_col).groups.items():
        sub = F_tr.loc[rows]
        per_site[site] = (sub.mean(), sub.std().replace(0, 1.0))

    def remap(frame: pd.DataFrame, sites: pd.Series) -> pd.DataFrame:
        out = frame.copy()
        for site, rows in sites.groupby(sites).groups.items():
            mu, sd = per_site.get(site, (g_mu, g_sd))
            out.loc[rows] = (frame.loc[rows] - mu) / sd * g_sd + g_mu
        return out

    new_tr, new_te = train_df.copy(), test_df.copy()
    new_tr[cols] = remap(F_tr, train_df[site_col])
    if site_col in test_df.columns:
        new_te[cols] = remap(F_te, test_df[site_col])
    else:
        new_te[cols] = F_te
    return new_tr, new_te


# ---------------------------------------------------------------------------
# L/R asymmetry engineering
# ---------------------------------------------------------------------------

_SIDE_RE = re.compile(r"_(L|LEFT|R|RIGHT)(?=_|$)", re.IGNORECASE)


def asymmetry_pairs(cols: Sequence[str]) -> Dict[str, Dict[str, str]]:
    """Group columns into L/R pairs by stripping a side token (_L/_LEFT/
    _R/_RIGHT, mid-name or terminal). Returns base -> {'L': col, 'R': col}
    for bases where both sides exist."""
    sided: Dict[str, Dict[str, str]] = {}
    for col in cols:
        m = _SIDE_RE.search(col)
        if not m:
            continue
        side = "L" if m.group(1)[0].upper() == "L" else "R"
        sided.setdefault(_SIDE_RE.sub("", col), {})[side] = col
    return {base: pair for base, pair in sided.items() if len(pair) == 2}


def with_asymmetry(df: pd.DataFrame, cols: Sequence[str]) -> Tuple[pd.DataFrame, List[str]]:
    """Append (L-R)/(L+R+1e-6) asymmetry-index columns (reference
    formula, ppmi_imaging_upgrade.py:152-175) named ``<base>_ASYM``."""
    out = df.copy()
    added: List[str] = []
    for base, pair in asymmetry_pairs(cols).items():
        left = pd.to_numeric(out[pair["L"]], errors="coerce")
        right = pd.to_numeric(out[pair["R"]], errors="coerce")
        name = f"{base}_ASYM"
        out[name] = (left - right) / (left + right + 1e-6)
        added.append(name)
    return out, added


# ---------------------------------------------------------------------------
# model factories + stats
# ---------------------------------------------------------------------------


SUITE_GBDT = dict(n_estimators=300, learning_rate=0.05, num_leaves=31,
                  class_weight="balanced")


def boosted_tree(seed: int, num_threads: int = 2, logger: Optional[logging.Logger] = None):
    """Gradient-boosted classifier. ``nn/gbdt.py::resolve_gbdt_backend``
    picks the device trainer on the card (``DeviceHistGBDT`` with the
    suites' hyperparameters, whose gain importances fill the importance
    CSVs; subsample/colsample are not emulated: the device trainer is
    deterministic by design) and scikit-learn's HistGradientBoosting on
    the CPU, as the JAX package does where LightGBM is absent;
    ``PD_FUSION_GBDT_BACKEND`` forces either side."""
    from pd_fusion_torch.nn.gbdt import DeviceHistGBDT, resolve_gbdt_backend

    if resolve_gbdt_backend(None) == "device":
        return DeviceHistGBDT(random_state=seed, **SUITE_GBDT)
    if logger is not None:
        logger.warning("lightgbm unavailable - HistGradientBoosting stands in")
    from sklearn.ensemble import HistGradientBoostingClassifier

    return HistGradientBoostingClassifier(random_state=seed)


def fit_boosted_trees(models, Xs, ys):
    """Fit ``models[i]`` on ``(Xs[i], ys[i])``: the device models as one
    fold-batched ``train_gbdt`` call (``nn/gbdt.py::fit_gbdt_stack``; each
    ensemble equals its own fit), any other model on its own."""
    from pd_fusion_torch.nn.gbdt import DeviceHistGBDT, fit_gbdt_stack

    stacked = [i for i, m in enumerate(models) if isinstance(m, DeviceHistGBDT)]
    if stacked:
        fit_gbdt_stack([models[i] for i in stacked], [Xs[i] for i in stacked],
                       [ys[i] for i in stacked])
    for i, m in enumerate(models):
        if i not in stacked:
            m.fit(Xs[i], ys[i])
    return models


def balanced_logreg(max_iter: int = 2000):
    """``LogisticRegression(max_iter=max_iter, class_weight="balanced")``:
    ``nn/logreg.py`` on the device."""
    from pd_fusion_torch.nn.logreg import BalancedLogisticRegression

    return BalancedLogisticRegression(max_iter=max_iter)


def paired_fold_ttest(a: Sequence[float], b: Sequence[float]) -> Optional[float]:
    """Two-sided paired t-test p-value over matched fold metrics, or None
    when the pairing is broken/degenerate."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    if len(a) != len(b) or len(a) == 0:
        return None
    try:
        from scipy.stats import ttest_rel

        return float(ttest_rel(a, b).pvalue)
    except Exception:  # pragma: no cover - scipy is on both machines
        return None
