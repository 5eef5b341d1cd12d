"""PPMI imaging-upgrade audit suite (port of ``scripts/ppmi_imaging_upgrade.py``,
same flags, config keys and artifacts):

    python -m pd_fusion_torch.scripts.ppmi_imaging_upgrade --config C [--out-dir D]
        [--num-threads T] [--limit N] [--no-plot] [--no-shap]

Three endpoints (pd_vs_hc, HC->PD conversion within a horizon, UPDRS-delta
progression, with the ``visit_id`` month recovery), L/R asymmetry
features, covariate residualization and harmonization (none / ComBat,
which falls back to the site z-score where neuroCombat is missing, as it
is on both machines / site z-score) fitted on train only, the
imaging-available cohort filter, five audit files, per-fold CV over
seeds x settings x models, the univariate and permutation screens, the
paired t-test between settings, ROC and calibration plots and a mean-|SHAP|
table for the best (setting, model). The regex group tables below are the
JAX script's.

No scikit-learn: the folds are ``data/splits.py::_stratified_kfold``, the
logistic fits ``nn/logreg.py`` and the boosted trees
``analysis/tabular.py::boosted_tree`` (a seed's folds of every setting as
one fold-batched GBDT fit on the card); fold metrics are
``utils/metrics.py::compute_metrics``; the plots' curves are
``evaluation/plots.py``'s numpy ``roc_curve`` and ``calibration_curve``,
and the PNGs are skipped with a warning where matplotlib is missing. The
SHAP leg of a device-GBDT winner is ``DeviceHistGBDT.shap_values``
(``ops/treeshap.py``); a logistic or host-tree winner needs the ``shap``
package, which neither machine has, and is skipped with a warning.
``LAST_TIMINGS`` holds the last run's wall seconds per stage and
``LAST_SHAP`` the SHAP leg's (rows, features, trees, chunks, seconds).
"""
import argparse
import datetime
import json
import os
import time
from pathlib import Path
from typing import Dict

import numpy as np
import pandas as pd
import yaml

from pd_fusion_torch.analysis.tabular import (
    TabularPrep,
    balanced_logreg,
    boosted_tree,
    coerce_numeric,
    fit_boosted_trees,
    grep_columns,
    numeric_feature_columns,
    paired_fold_ttest,
    permutation_screen,
    rank_univariate_auc,
    residualize_features,
    site_zscore,
    suite_logger,
    with_asymmetry,
)

ID_COLS = {"subject_id", "visit_id", "visit_month", "date"}
DEFAULT_GLOBAL_EXCLUDE = [
    r"^.*date.*$", r"^.*time.*$", r"^.*event.*$", r"^.*protocol.*$", r"^.*dose.*$",
    r"^.*site.*$", r"^.*center.*$", r"^.*scanner.*$", r"^.*acq.*$", r"^.*acquisition.*$",
    r"^.*series.*$", r"^.*version.*$", r"^.*reason.*$", r"^.*not_analyzed.*$",
    r"^.*notanalyzed.*$",
]
DEFAULT_NONMOTOR = [
    r"moca", r"cognition", r"sleep", r"epworth", r"rbd", r"rem", r"depress", r"gds",
    r"bdi", r"anxiety", r"stai", r"mood", r"upsit", r"smell", r"autonomic",
]
DEFAULT_DATSBR = [r"datscan", r"sbr", r"putamen", r"caudate", r"striat", r"asym"]
DEFAULT_MRI = [
    r"mri_derived__", r"thickness", r"cortical", r"volume", r"area", r"aseg", r"hippo",
    r"entorhinal", r"amygdala", r"caudate", r"putamen", r"pallid", r"thalam", r"accumbens",
]

BASELINE_VISIT_TOKENS = {"BL", "BASELINE", "SCR", "SCREEN", "SC", "ENRL"}


# ---------------------------------------------------------------------------
# endpoints
# ---------------------------------------------------------------------------


def _ensure_visit_month(visits: pd.DataFrame, logger) -> pd.DataFrame:
    """Longitudinal endpoints need a numeric month axis; if the table has
    none, recover it from visit_id codes (V04 -> 4, baseline tokens -> 0)."""
    if "visit_month" not in visits.columns:
        raise ValueError("visit_month required for longitudinal endpoints")
    if not visits["visit_month"].isna().all():
        return visits
    if "visit_id" not in visits.columns:
        raise ValueError("visit_month missing and visit_id not available")
    codes = visits["visit_id"].astype(str).str.upper()
    months = pd.to_numeric(codes.str.extract(r"(\d+)", expand=False), errors="coerce")
    months = months.mask(codes.isin(BASELINE_VISIT_TOKENS), 0)
    out = visits.copy()
    out["visit_month"] = months
    logger.info("visit_month reconstructed from visit_id codes")
    return out


def _conversion_labels(baseline: pd.DataFrame, visits: pd.DataFrame, horizon, logger):
    """HC-at-baseline cohort; positive iff any PD label appears within
    the horizon. Subjects with no qualifying visit stay negative."""
    hc_ids = baseline.loc[baseline["label"] == 0, "subject_id"]
    eligible = visits[
        visits["subject_id"].isin(hc_ids)
        & visits["visit_month"].notna()
        & (visits["visit_month"] <= horizon)
    ]
    converted = eligible.groupby("subject_id")["label"].max()
    relabeled = pd.DataFrame({"subject_id": hc_ids})
    relabeled["label"] = (
        relabeled["subject_id"].map(converted).fillna(0).astype(int)
    )
    logger.info("conversion endpoint cohort: %d subjects", len(relabeled))
    return baseline.drop(columns=["label"], errors="ignore").merge(
        relabeled, on="subject_id", how="right"
    )


def _progression_labels(baseline: pd.DataFrame, visits: pd.DataFrame, spec, logger):
    """Positive iff the progression feature rises by >= threshold between
    baseline and the follow-up visit closest to the horizon (last visit
    at/before it; optionally the first visit beyond it for subjects with
    no in-horizon follow-up)."""
    feature = spec.get("progression_feature", "mds_updrs__NP3TOT")
    threshold = spec.get("progression_threshold", 5.0)
    horizon = spec.get("horizon_months", 24)
    beyond_ok = bool(spec.get("progression_allow_beyond_horizon", True))
    ceiling = spec.get("progression_max_months")

    usable = visits[visits[feature].notna()].copy()
    usable["visit_month"] = pd.to_numeric(usable["visit_month"], errors="coerce")
    usable = usable[usable["visit_month"].notna()]
    if ceiling is not None:
        usable = usable[usable["visit_month"] <= ceiling]
    usable = usable.sort_values("visit_month")

    followup = usable[usable["visit_month"] <= horizon].groupby("subject_id").last()
    if beyond_ok:
        later = usable[usable["visit_month"] > horizon].groupby("subject_id").first()
        only_later = later.index.difference(followup.index)
        if len(only_later):
            followup = pd.concat([followup, later.loc[only_later]])
            logger.info(
                "progression: %d subjects matched beyond the %s-month horizon",
                len(only_later), horizon,
            )
    if followup.empty:
        raise ValueError(
            f"No progression targets found for feature {feature} (horizon={horizon})."
        )

    deltas = baseline[["subject_id", feature]].merge(
        followup.reset_index()[["subject_id", feature]],
        on="subject_id", suffixes=("_base", "_target"),
    )
    deltas["label"] = (
        deltas[f"{feature}_target"] - deltas[f"{feature}_base"] >= threshold
    ).astype(int)
    out = baseline.drop(columns=["label"], errors="ignore").merge(
        deltas[["subject_id", "label"]], on="subject_id", how="inner"
    )
    logger.info("progression endpoint cohort: %d subjects", len(out))
    return out


def build_endpoint_labels(baseline_df, visit_df, endpoint_cfg, logger):
    kind = endpoint_cfg.get("type", "pd_vs_hc")
    if kind == "pd_vs_hc":
        return baseline_df
    visits = _ensure_visit_month(visit_df.dropna(subset=["label"]).copy(), logger)
    if kind.startswith("conversion"):
        return _conversion_labels(
            baseline_df, visits, endpoint_cfg.get("horizon_months", 24), logger
        )
    if kind.startswith("progression"):
        return _progression_labels(baseline_df, visits, endpoint_cfg, logger)
    raise ValueError(f"Unknown endpoint: {kind}")


# ---------------------------------------------------------------------------
# harmonization dispatch
# ---------------------------------------------------------------------------


def apply_harmonization(train_df, test_df, feature_cols, method, site_cols, logger):
    if method == "none" or not feature_cols:
        return train_df, test_df
    site_col = next((c for c in site_cols if c in train_df.columns), None)
    if method == "combat":
        harmonized = _try_neurocombat(train_df, feature_cols, site_col, logger)
        if harmonized is not None:
            return harmonized, test_df.copy()
        method = "site_zscore"  # documented fallback chain
    if method == "site_zscore":
        if site_col is None:
            return train_df, test_df
        return site_zscore(train_df, test_df, feature_cols, site_col)
    return train_df, test_df


def _try_neurocombat(train_df, feature_cols, site_col, logger):
    """ComBat train-side harmonization when neuroCombat is importable;
    None signals the caller to fall back to the site z-score."""
    if site_col is None:
        return train_df
    try:
        from neuroCombat import neuroCombat
    except ImportError as exc:  # neuroCombat is installed on neither machine
        logger.warning("neuroCombat unavailable (%s); harmonizing by site z-score", exc)
        return None
    dat = coerce_numeric(train_df, feature_cols).fillna(0).T
    batch = pd.DataFrame({"batch": train_df[site_col].astype(str)})
    result = neuroCombat(dat=dat, covars=batch, batch_col="batch")
    out = train_df.copy()
    out[feature_cols] = result["data"].T
    return out


# ---------------------------------------------------------------------------
# cohort + audits
# ---------------------------------------------------------------------------


def imaging_availability(df, dat_cols, mri_cols) -> Dict[str, np.ndarray]:
    def observed(cols):
        if not cols:
            return np.zeros(len(df), bool)
        return coerce_numeric(df, cols).notna().any(axis=1).to_numpy()

    dat, mri = observed(dat_cols), observed(mri_cols)
    return {"dat": dat, "mri": mri, "any": dat | mri}


def cohort_mask(avail: Dict[str, np.ndarray], cohort_cfg, n: int) -> np.ndarray:
    want_dat = cohort_cfg.get("require_dat", False)
    want_mri = cohort_cfg.get("require_mri", False)
    if want_dat and want_mri:
        return avail["dat"] & avail["mri"]
    if want_dat:
        return avail["dat"]
    if want_mri:
        return avail["mri"]
    if cohort_cfg.get("require_any", True):
        return avail["any"]
    return np.ones(n, bool)


def write_audits(df, out_dir: Path, settings, dat_cols, mri_cols, imaging_cols, avail):
    all_feats = sorted({c for cols in settings.values() for c in cols})
    (out_dir / "kept_dropped_columns.json").write_text(json.dumps(
        {
            name: {"kept": cols, "dropped": [c for c in all_feats if c not in cols]}
            for name, cols in settings.items()
        },
        indent=2,
    ))
    (out_dir / "imaging_columns.json").write_text(
        json.dumps({"datsbr": dat_cols, "mri": mri_cols}, indent=2)
    )
    n = len(df)
    (out_dir / "imaging_availability_summary.json").write_text(json.dumps(
        {
            "total_subjects": n,
            "dat_available": int(avail["dat"].sum()),
            "mri_available": int(avail["mri"].sum()),
            "any_imaging_available": int(avail["any"].sum()),
            "dat_available_rate": float(avail["dat"].mean()) if n else 0.0,
            "mri_available_rate": float(avail["mri"].mean()) if n else 0.0,
            "any_imaging_available_rate": float(avail["any"].mean()) if n else 0.0,
        },
        indent=2,
    ))
    observed = coerce_numeric(df, imaging_cols)
    per_feature = observed.isna().mean().rename("missing_rate").rename_axis("feature")
    per_feature.reset_index().sort_values("missing_rate", ascending=False).to_csv(
        out_dir / "imaging_missingness_per_feature.csv", index=False
    )
    pd.DataFrame({
        "subject_id": df["subject_id"].astype(str),
        "missing_rate": observed.isna().mean(axis=1),
    }).to_csv(out_dir / "imaging_missingness_per_subject.csv", index=False)


# ---------------------------------------------------------------------------
# CV core
# ---------------------------------------------------------------------------

LAST_TIMINGS: Dict[str, float] = {}
LAST_SHAP: Dict[str, float] = {}


def prepare_setting_fold(train_df, test_df, feature_cols, imaging_in_setting, cov_spec,
                         harm_spec, logger):
    """Adjust -> harmonize -> prep one fold of one setting: (train_df,
    test_df, scaled prep, unscaled prep)."""
    if imaging_in_setting:
        train_df, test_df = residualize_features(
            train_df, test_df, imaging_in_setting, cov_spec["numeric"], cov_spec["categorical"]
        )
        train_df, test_df = apply_harmonization(
            train_df, test_df, imaging_in_setting, harm_spec["method"],
            harm_spec["site_cols"], logger,
        )
    scaled = TabularPrep(scale=True, add_indicators=True).fit(train_df, feature_cols)
    unscaled = TabularPrep(scale=False, add_indicators=True).fit(train_df, feature_cols)
    return train_df, test_df, scaled, unscaled


def fit_seed_trees(parts_by_setting, seed, num_threads, logger):
    """The boosted trees of every fold of every setting of one seed, fitted
    as one fold-batched call (each equal to its own fit; fold ``i`` seeded
    ``seed + i``, as the JAX script seeds its per-fold fits). -> one list
    of fold trees per setting."""
    trees = [[boosted_tree(seed + fold, num_threads, logger) for fold in range(1, len(p) + 1)]
             for p in parts_by_setting]
    flat = [t for ts in trees for t in ts]
    parts = [p for ps in parts_by_setting for p in ps]
    fit_boosted_trees(flat, [p[3].transform(p[0]) for p in parts],
                      [p[0]["label"].values for p in parts])
    return trees


def run_setting_fold(part, models, tree, clock):
    """Each model of one prepared fold -> (model name, metrics, probs,
    importances, feature names); ``tree`` is the fold's fitted boosted tree."""
    from pd_fusion_torch.utils.metrics import compute_metrics

    train_df, test_df, scaled, unscaled = part
    for model_name in models:
        t0 = time.perf_counter()
        prep = scaled if model_name == "logreg" else unscaled
        if model_name == "logreg":
            clf = balanced_logreg().fit(prep.transform(train_df), train_df["label"].values)
        else:
            clf = tree
        X_test = prep.transform(test_df)
        probs = (
            clf.predict_proba(X_test)[:, 1]
            if hasattr(clf, "predict_proba") else clf.predict(X_test)
        )
        clock["logreg_s" if model_name == "logreg" else "lgbm_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        # sorted: the JAX script's jitted metrics come back so
        metrics = dict(sorted(compute_metrics(test_df["label"].values, probs).items()))
        clock["metrics_s"] += time.perf_counter() - t0
        if model_name == "logreg" and hasattr(clf, "coef_"):
            importances = np.abs(np.ravel(clf.coef_))
        elif hasattr(clf, "feature_importances_"):
            importances = np.asarray(clf.feature_importances_, float)
        else:
            importances = None
        yield model_name, metrics, probs, importances, prep.feature_names


def run_imaging_upgrade(cfg, out_dir: Path, num_threads=2, limit=None, no_plot=False,
                        no_shap=False, logger=None):
    from pd_fusion_torch.data.splits import _stratified_kfold

    out_dir = Path(out_dir)
    logger = logger or suite_logger("ppmi_imaging", out_dir, "ppmi_imaging_upgrade.log")
    clock = {k: 0.0 for k in ("cohort_s", "screens_s", "prep_s", "logreg_s", "lgbm_s",
                              "metrics_s", "plots_s", "shap_s")}
    t_run = time.perf_counter()
    cv_cfg = cfg.get("cv", {})
    seeds = cv_cfg.get("seeds", [42])
    folds = int(cv_cfg.get("folds", 5))

    baseline_df = pd.read_csv(cfg["baseline_csv"], low_memory=False)
    visit_path = Path(cfg["visit_csv"])
    if not visit_path.exists():
        raise ValueError("visit_csv not found")
    visit_df = pd.read_csv(visit_path, low_memory=False)
    for frame in (baseline_df, visit_df):
        if "subject_id" in frame.columns:
            frame["subject_id"] = frame["subject_id"].astype(str)

    df = build_endpoint_labels(baseline_df, visit_df, cfg.get("endpoint", {}), logger)
    df = df.dropna(subset=["label"]).copy()
    if limit:
        df = df.sample(n=min(limit, len(df)), random_state=seeds[0])

    groups = cfg.get("feature_groups", {})
    candidates = numeric_feature_columns(
        df, groups.get("global_exclude_patterns", DEFAULT_GLOBAL_EXCLUDE), ID_COLS
    )
    dat_cols = grep_columns(candidates, allow=groups.get("datsbr_patterns", DEFAULT_DATSBR))
    mri_cols = grep_columns(candidates, allow=groups.get("mri_patterns", DEFAULT_MRI))
    nonmotor_cols = grep_columns(
        candidates, allow=groups.get("non_motor_patterns", DEFAULT_NONMOTOR)
    )

    df, asym_cols = with_asymmetry(df, dat_cols)
    dat_cols = dat_cols + asym_cols
    imaging_cols = sorted(set(dat_cols + mri_cols))
    settings = {
        "non_motor_only": nonmotor_cols,
        "datsbr_only": dat_cols,
        "freesurfer_only": mri_cols,
        "fusion_nonmotor_imaging": sorted(set(nonmotor_cols + imaging_cols)),
    }

    avail = imaging_availability(df, dat_cols, mri_cols)
    write_audits(df, out_dir, settings, dat_cols, mri_cols, imaging_cols, avail)

    cohort_cfg = cfg.get("cohort", {})
    if cohort_cfg.get("imaging_available_only", False):
        df = df.loc[cohort_mask(avail, cohort_cfg, len(df))].copy()
        logger.info("imaging-available cohort: %d subjects retained", len(df))

    cov_cfg = cfg.get("covariates", {})
    cov_spec = {"numeric": cov_cfg.get("numeric", []),
                "categorical": cov_cfg.get("categorical", [])}
    (out_dir / "covariates_used.json").write_text(json.dumps(cov_spec, indent=2))
    harm_cfg = cfg.get("harmonization", {})
    harm_spec = {"method": harm_cfg.get("method", "none"),
                 "site_cols": harm_cfg.get("site_cols", [])}
    models = cfg.get("models", ["logreg", "lgbm"])
    clock["cohort_s"] += time.perf_counter() - t_run

    fold_rows, importance_rows, screening_rows, pred_rows = [], [], [], []
    for seed in seeds:
        splits = list(_stratified_kfold(df["label"].values, folds, seed))
        prepared = []
        for setting, feature_cols in settings.items():
            if not feature_cols:
                logger.warning("setting %s resolved to zero features", setting)
                continue
            t0 = time.perf_counter()
            screening_rows.extend(
                {"setting": setting, "feature": feat, "auc": auc, "seed": seed}
                for feat, auc in rank_univariate_auc(df, df["label"].values, feature_cols)
            )
            clock["screens_s"] += time.perf_counter() - t0
            imaging_in_setting = [c for c in feature_cols if c in imaging_cols]

            t0 = time.perf_counter()
            prepared.append((setting, [
                prepare_setting_fold(df.iloc[tr].copy(), df.iloc[te].copy(), feature_cols,
                                     imaging_in_setting, cov_spec, harm_spec, logger)
                for tr, te in splits]))
            clock["prep_s"] += time.perf_counter() - t0
        trees = [[None] * len(parts) for _, parts in prepared]
        if prepared and any(m != "logreg" for m in models):
            t0 = time.perf_counter()
            trees = fit_seed_trees([parts for _, parts in prepared], seed, num_threads, logger)
            clock["lgbm_s"] += time.perf_counter() - t0

        for (setting, parts), setting_trees in zip(prepared, trees):
            for fold, (part, tree) in enumerate(zip(parts, setting_trees), start=1):
                test_df = part[1]
                for model_name, metrics, probs, importances, feat_names in run_setting_fold(
                        part, models, tree, clock):
                    fold_rows.append({
                        "seed": seed, "fold": fold, "setting": setting,
                        "model": model_name, **metrics,
                    })
                    pred_rows.extend(
                        {"index": int(i), "subject_id": test_df.loc[i, "subject_id"],
                         "setting": setting, "model": model_name, "fold": fold,
                         "seed": seed, "y_true": int(test_df.loc[i, "label"]),
                         "y_prob": float(p)}
                        for i, p in zip(test_df.index, probs)
                    )
                    if importances is not None:
                        importance_rows.extend(
                            {"setting": setting, "model": model_name, "fold": fold,
                             "seed": seed, "feature": nm, "importance": float(v)}
                            for nm, v in zip(feat_names, importances)
                        )

    per_fold_df = pd.DataFrame(fold_rows)
    per_fold_df.to_csv(out_dir / "per_fold_metrics.csv", index=False)
    pred_df = pd.DataFrame(pred_rows)
    pred_df.to_csv(out_dir / "predictions.csv", index=False)

    summary = per_fold_df.groupby(["setting", "model"]).agg(["mean", "std"]).reset_index()
    summary.columns = [
        "_".join(filter(None, c)) if isinstance(c, tuple) else c for c in summary.columns
    ]
    summary.to_csv(out_dir / "summary_mean.csv", index=False)

    imp_df = pd.DataFrame(importance_rows)
    if not imp_df.empty:
        (
            imp_df.groupby(["setting", "model", "feature"])["importance"].mean()
            .reset_index()
            .sort_values(["setting", "model", "importance"], ascending=[True, True, False])
            .groupby(["setting", "model"]).head(20)
        ).to_csv(out_dir / "feature_importance.csv", index=False)

    pd.DataFrame(screening_rows).to_csv(out_dir / "univariate_top.csv", index=False)

    t0 = time.perf_counter()
    perm_rows = [
        {**row, "setting": setting}
        for setting in ("non_motor_only", "fusion_nonmotor_imaging")
        if settings.get(setting)
        for row in permutation_screen(df, settings[setting], repeats=5)
    ]
    clock["screens_s"] += time.perf_counter() - t0
    pd.DataFrame(perm_rows).to_csv(out_dir / "permutation_test.csv", index=False)

    contrast = ("non_motor_only", "fusion_nonmotor_imaging")
    by_key = per_fold_df[per_fold_df["model"] == "lgbm"]
    pval = paired_fold_ttest(
        by_key[by_key["setting"] == contrast[0]]["roc_auc"],
        by_key[by_key["setting"] == contrast[1]]["roc_auc"],
    )
    (out_dir / "paired_tests.json").write_text(json.dumps(
        {"setting_a": contrast[0], "setting_b": contrast[1], "p_value": pval}, indent=2
    ))

    t0 = time.perf_counter()
    if not no_plot:
        _render_plots(summary, pred_df, out_dir, logger)
    clock["plots_s"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    LAST_SHAP.clear()
    if not no_shap:
        _shap_summary(df, settings, summary, imaging_cols, cov_spec, harm_spec,
                      seeds, num_threads, out_dir, logger)
    clock["shap_s"] += time.perf_counter() - t0

    LAST_TIMINGS.clear()
    LAST_TIMINGS.update(clock, total_s=time.perf_counter() - t_run)
    logger.info("stage wall seconds: %s", {k: round(v, 3) for k, v in LAST_TIMINGS.items()})
    logger.info("summary written: %s", out_dir / "summary_mean.csv")
    return per_fold_df


# ---------------------------------------------------------------------------
# plots + SHAP
# ---------------------------------------------------------------------------

_PLOT_SETTINGS = ["non_motor_only", "fusion_nonmotor_imaging"]


def _render_plots(summary, pred_df, out_dir, logger):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as exc:  # matplotlib is absent on the card's machine
        logger.warning("plot rendering skipped: %s", exc)
        return
    from pd_fusion_torch.evaluation.plots import calibration_curve, roc_curve

    best = (
        summary.sort_values("roc_auc_mean", ascending=False)
        .groupby("setting", as_index=False).first()
    )
    fig, ax = plt.subplots(figsize=(10, 5))
    ax.bar(best["setting"], best["roc_auc_mean"], yerr=best["roc_auc_std"], capsize=4)
    ax.set(ylabel="ROC-AUC", title="PPMI Imaging Upgrade: ROC-AUC", ylim=(0, 1.0))
    plt.xticks(rotation=25, ha="right")
    fig.tight_layout()
    fig.savefig(out_dir / "roc_auc_bar.png", dpi=200)
    plt.close(fig)

    def lgbm_subset(setting):
        return pred_df[(pred_df["setting"] == setting) & (pred_df["model"] == "lgbm")]

    fig, ax = plt.subplots(figsize=(8, 6))
    for setting in _PLOT_SETTINGS:
        sub = lgbm_subset(setting)
        if sub.empty:
            continue
        fpr, tpr, _ = roc_curve(sub["y_true"], sub["y_prob"])
        auc = float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))
        ax.plot(fpr, tpr, label=f"{setting} (AUC={auc:.3f})")
    ax.plot([0, 1], [0, 1], "--", color="gray")
    ax.set(title="ROC Curves (LGBM)", xlabel="False Positive Rate",
           ylabel="True Positive Rate")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_dir / "roc_curves.png", dpi=200)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(6, 5))
    for setting in _PLOT_SETTINGS:
        sub = lgbm_subset(setting)
        if sub.empty:
            continue
        frac_pos, mean_pred = calibration_curve(sub["y_true"], sub["y_prob"], n_bins=10)
        ax.plot(mean_pred, frac_pos, marker="o", label=setting)
    ax.plot([0, 1], [0, 1], "--", color="gray")
    ax.set(title="Calibration Curves (LGBM)", xlabel="Mean predicted",
           ylabel="Fraction positive")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_dir / "calibration_curves.png", dpi=200)
    plt.close(fig)


def _shap_summary(df, settings, summary, imaging_cols, cov_spec, harm_spec, seeds,
                  num_threads, out_dir, logger):
    """Mean-|SHAP| table for the best (setting, model) pair, trained on
    the full cohort. A device-GBDT winner goes through its exact
    path-dependent TreeSHAP (the quantity of shap's ``TreeExplainer`` in
    ``tree_path_dependent`` mode); any other winner needs the shap
    package and is skipped with a warning where it is missing."""
    winner = summary.sort_values("roc_auc_mean", ascending=False).iloc[0]
    setting, model = winner["setting"], winner["model"]
    feature_cols = settings.get(setting, [])
    if not feature_cols:
        return
    frame = df.copy()
    imaging_in_setting = [c for c in feature_cols if c in imaging_cols]
    if imaging_in_setting:
        frame, _ = residualize_features(
            frame, frame, imaging_in_setting, cov_spec["numeric"], cov_spec["categorical"]
        )
        frame, _ = apply_harmonization(
            frame, frame, imaging_in_setting, harm_spec["method"],
            harm_spec["site_cols"], logger,
        )
    prep = TabularPrep(scale=(model == "logreg"), add_indicators=True)
    X = prep.fit_transform(frame, feature_cols)
    clf = (
        balanced_logreg() if model == "logreg"
        else boosted_tree(seeds[0], num_threads, logger)
    )
    clf.fit(X, frame["label"].values)
    sample = np.random.default_rng(seeds[0]).choice(
        len(frame), size=min(500, len(frame)), replace=False
    )
    X_sample = X[sample]
    t0 = time.perf_counter()
    try:
        if hasattr(clf, "shap_values"):  # device GBDT: exact TreeSHAP on the card
            values = clf.shap_values(X_sample)
        elif model != "logreg" and hasattr(clf, "predict_proba"):
            import shap

            values = shap.TreeExplainer(clf).shap_values(X_sample)
            if isinstance(values, list):
                values = values[1]
        else:
            import shap

            values = shap.LinearExplainer(clf, X_sample).shap_values(X_sample)
    except ImportError as exc:  # the shap package is installed on neither machine
        logger.warning("SHAP summary skipped: %s", exc)
        return
    if hasattr(clf, "shap_values"):
        from pd_fusion_torch.ops.treeshap import _CHUNK

        LAST_SHAP.update(rows=len(X_sample), features=X.shape[1], trees=clf.n_estimators,
                         depth=clf.max_depth, chunks=-(-len(X_sample) // _CHUNK),
                         seconds=time.perf_counter() - t0, setting=setting)
    pd.DataFrame({
        "feature": prep.feature_names,
        "mean_abs_shap": np.mean(np.abs(values), axis=0),
    }).sort_values("mean_abs_shap", ascending=False).to_csv(
        out_dir / "shap_summary.csv", index=False
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description="PPMI imaging upgrade suite")
    parser.add_argument("--config", required=True)
    parser.add_argument("--out-dir", default=None)
    parser.add_argument("--num-threads", type=int, default=2)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--no-plot", action="store_true")
    parser.add_argument("--no-shap", action="store_true")
    args = parser.parse_args(argv)

    cfg = yaml.safe_load(Path(args.config).read_text())
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    out_dir = Path(args.out_dir or f"runs/ppmi_imaging_upgrade_{stamp}")
    logger = suite_logger("ppmi_imaging", out_dir, "ppmi_imaging_upgrade.log")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
        os.environ[var] = str(args.num_threads)
    mpl_cache = out_dir / "mpl_cache"
    mpl_cache.mkdir(parents=True, exist_ok=True)
    os.environ["MPLCONFIGDIR"] = str(mpl_cache)

    return run_imaging_upgrade(
        cfg, out_dir, num_threads=args.num_threads, limit=args.limit,
        no_plot=args.no_plot, no_shap=args.no_shap, logger=logger,
    )


if __name__ == "__main__":
    main()
