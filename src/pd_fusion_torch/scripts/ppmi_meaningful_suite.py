"""PPMI "meaningful baselines" suite (port of
``scripts/ppmi_meaningful_suite.py``, same flags and artifacts):

    python -m pd_fusion_torch.scripts.ppmi_meaningful_suite
        [--input-csv data/processed/ppmi/ppmi_subject_baseline.csv] [--output-dir D]
        [--seed 42] [--num-threads T] [--limit N] [--no-plot] [--no-missing-indicators]

Six regex-defined feature settings (full_clinical / no_motor_exam /
non_motor_only / datsbr_only / freesurfer_only / their fusion) x {logreg,
lgbm} x 5-fold stratified CV, writing ``kept_dropped_columns.json``,
``per_fold_metrics.csv``, ``summary_mean.csv``, the top-20
``feature_importance.csv``, ``univariate_top.csv``, ``permutation_test.csv``
and ``roc_auc_bar.png`` (skipped, with a warning, where matplotlib is
absent). The regex tables below are the JAX script's.

The folds are ``StratifiedKFold(5, shuffle=True, random_state=seed)`` as
numpy (``data/splits.py``); the screens, the logistic fits and the GBDT
run on the card through ``analysis/tabular.py`` (the five folds' GBDTs of
a setting as one fold-batched fit); fold metrics are
``utils/metrics.py::compute_metrics``. ``LAST_TIMINGS`` holds the last
run's wall seconds per stage.
"""
import argparse
import datetime
import json
import os
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import pandas as pd

from pd_fusion_torch.analysis.tabular import (
    TabularPrep,
    balanced_logreg,
    boosted_tree,
    fit_boosted_trees,
    grep_columns,
    numeric_feature_columns,
    permutation_screen,
    rank_univariate_auc,
    suite_logger,
)

ID_COLS = {"subject_id", "visit_id", "visit_month", "date"}
GLOBAL_EXCLUDE_REGEX = [
    r"^.*date.*$", r"^.*time.*$", r"^.*event.*$", r"^.*protocol.*$", r"^.*dose.*$",
    r"^.*site.*$", r"^.*center.*$", r"^.*scanner.*$", r"^.*acq.*$", r"^.*acquisition.*$",
    r"^.*series.*$", r"^.*version.*$",
]

SETTINGS = {
    "full_clinical": {"type": "all_numeric"},
    "no_motor_exam": {
        "type": "drop_regex",
        "drop_regex": [r"^mds_updrs__.*", r".*NHY.*", r".*TRMR.*", r".*RIG.*", r".*BRADY.*"],
    },
    "non_motor_only": {
        "type": "allow_regex",
        "allow_regex": [
            r"moca", r"cognition", r"sleep", r"epworth", r"rbd", r"rem", r"depress",
            r"gds", r"bdi", r"anxiety", r"stai", r"mood", r"upsit", r"smell", r"autonomic",
        ],
    },
    "datsbr_only": {
        "type": "allow_regex",
        "allow_regex": [r"datscan", r"sbr", r"putamen", r"caudate", r"striat"],
    },
    "freesurfer_only": {
        "type": "allow_regex",
        "allow_regex": [
            r"mri_derived__", r"thickness", r"cortical", r"volume", r"area", r"aseg",
            r"hippo", r"entorhinal", r"amygdala",
        ],
    },
    "fusion_nonmotor_imaging": {
        "type": "union",
        "sources": ["non_motor_only", "datsbr_only", "freesurfer_only"],
    },
}

MODELS = ["logreg", "lgbm"]
LAST_TIMINGS: Dict[str, float] = {}


def resolve_settings(df: pd.DataFrame) -> Dict[str, List[str]]:
    """Every setting's column list in one pass; a union draws from the
    settings before it."""
    base = numeric_feature_columns(df, GLOBAL_EXCLUDE_REGEX, ID_COLS)
    resolved: Dict[str, List[str]] = {}
    for name, spec in SETTINGS.items():
        kind = spec["type"]
        if kind == "all_numeric":
            resolved[name] = base
        elif kind == "drop_regex":
            resolved[name] = grep_columns(base, deny=spec["drop_regex"])
        elif kind == "allow_regex":
            resolved[name] = grep_columns(base, allow=spec["allow_regex"])
        elif kind == "union":
            merged = {c for src in spec["sources"] for c in resolved[src]}
            resolved[name] = sorted(merged)
        else:
            resolved[name] = []
    return resolved


def extract_importance(clf, model_name: str):
    """|coef| for linear probes, native importances for trees."""
    if model_name == "logreg" and hasattr(clf, "coef_"):
        return np.abs(np.ravel(clf.coef_))
    if hasattr(clf, "feature_importances_"):
        return np.asarray(clf.feature_importances_, float)
    return None


def summarize_folds(per_fold_df: pd.DataFrame) -> pd.DataFrame:
    """Mean/std per (setting, model) with flattened column names plus a
    fold_count column."""
    agg = per_fold_df.groupby(["setting", "model"]).agg(["mean", "std"]).reset_index()
    agg.columns = [
        "_".join(filter(None, c)) if isinstance(c, tuple) else c for c in agg.columns
    ]
    sizes = per_fold_df.groupby(["setting", "model"]).size().reset_index(name="fold_count")
    return agg.merge(sizes, on=["setting", "model"], how="left")


def bar_plot(summary: pd.DataFrame, out_path: Path, title: str, logger) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        best = (
            summary.sort_values("roc_auc_mean", ascending=False)
            .groupby("setting", as_index=False)
            .first()
        )
        fig, ax = plt.subplots(figsize=(10, 5))
        ax.bar(best["setting"], best["roc_auc_mean"], yerr=best["roc_auc_std"], capsize=4)
        ax.set(ylabel="ROC-AUC", title=title, ylim=(0, 1.0))
        plt.xticks(rotation=30, ha="right")
        fig.tight_layout()
        fig.savefig(out_path, dpi=200)
        plt.close(fig)
    except Exception as exc:  # matplotlib is absent on the card's machine
        logger.warning("plot skipped: %s", exc)


def run_suite(df, out_dir: Path, seed=42, num_threads=2, limit=None,
              no_plot=False, no_missing_indicators=False, logger=None):
    from pd_fusion_torch.data.splits import _stratified_kfold
    from pd_fusion_torch.utils.metrics import compute_metrics

    out_dir = Path(out_dir)
    logger = logger or suite_logger("ppmi_suite", out_dir, "ppmi_meaningful_suite.log")
    clock = {k: 0.0 for k in ("screens_s", "prep_s", "logreg_s", "lgbm_s", "metrics_s")}
    t_run = time.perf_counter()
    df = df.dropna(subset=["label"]).copy()
    logger.info("Label prevalence (positive class=1): %.4f", float(df["label"].mean()))
    if limit:
        df = df.sample(n=min(limit, len(df)), random_state=seed)
    labels = df["label"].values

    columns_by_setting = resolve_settings(df)
    full_set = columns_by_setting["full_clinical"]
    (out_dir / "kept_dropped_columns.json").write_text(json.dumps(
        {
            name: {
                "kept": cols,
                "dropped": [] if name == "full_clinical"
                else [c for c in full_set if c not in cols],
            }
            for name, cols in columns_by_setting.items()
        },
        indent=2,
    ))

    folds = list(_stratified_kfold(labels, 5, seed))
    fold_rows: List[dict] = []
    importance_rows: List[dict] = []
    screening_rows: List[dict] = []

    for setting, feature_cols in columns_by_setting.items():
        if not feature_cols:
            logger.warning("setting %s resolved to zero features", setting)
            continue

        t0 = time.perf_counter()
        screening_rows.extend(
            {"setting": setting, "feature": feat, "auc": auc}
            for feat, auc in rank_univariate_auc(df, labels, feature_cols)
        )
        clock["screens_s"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        parts = []
        for tr, te in folds:
            train_df, test_df = df.iloc[tr], df.iloc[te]
            prep = TabularPrep(scale=True, add_indicators=not no_missing_indicators)
            X_train = prep.fit_transform(train_df, feature_cols)
            parts.append((prep, X_train, train_df["label"].values, prep.transform(test_df),
                          test_df["label"].values))
        clock["prep_s"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        trees = [boosted_tree(seed + fold, num_threads, logger)
                 for fold in range(1, len(folds) + 1)]
        fit_boosted_trees(trees, [p[1] for p in parts], [p[2] for p in parts])
        clock["lgbm_s"] += time.perf_counter() - t0

        for fold, ((prep, X_train, y_train, X_test, y_test), tree) in enumerate(
                zip(parts, trees), start=1):
            for model_name in MODELS:
                t0 = time.perf_counter()
                if model_name == "logreg":
                    clf = balanced_logreg().fit(X_train, y_train)
                else:
                    clf = tree
                prob = (
                    clf.predict_proba(X_test)[:, 1]
                    if hasattr(clf, "predict_proba") else clf.predict(X_test)
                )
                clock[f"{model_name}_s"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                fold_rows.append({
                    "setting": setting, "model": model_name, "fold": fold,
                    "prevalence": float(np.mean(y_test)),
                    # sorted: the JAX script's jitted metrics come back so
                    **dict(sorted(compute_metrics(y_test, prob).items())),
                })
                clock["metrics_s"] += time.perf_counter() - t0
                imp = extract_importance(clf, model_name)
                if imp is not None:
                    importance_rows.extend(
                        {"setting": setting, "model": model_name, "fold": fold,
                         "feature": nm, "importance": float(v)}
                        for nm, v in zip(prep.feature_names, imp)
                    )

    per_fold_df = pd.DataFrame(fold_rows)
    per_fold_df.to_csv(out_dir / "per_fold_metrics.csv", index=False)
    summary = summarize_folds(per_fold_df)
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
        for setting in ("full_clinical", "fusion_nonmotor_imaging")
        if columns_by_setting.get(setting)
        for row in permutation_screen(df, columns_by_setting[setting], repeats=5)
    ]
    clock["screens_s"] += time.perf_counter() - t0
    pd.DataFrame(perm_rows).to_csv(out_dir / "permutation_test.csv", index=False)

    if not no_plot:
        bar_plot(summary, out_dir / "roc_auc_bar.png", "PPMI meaningful baselines", logger)

    LAST_TIMINGS.clear()
    LAST_TIMINGS.update(clock, total_s=time.perf_counter() - t_run)
    logger.info("stage wall seconds: %s", {k: round(v, 3) for k, v in LAST_TIMINGS.items()})
    logger.info("summary written: %s", out_dir / "summary_mean.csv")
    return per_fold_df


def main(argv=None):
    parser = argparse.ArgumentParser(description="PPMI meaningful baseline suite")
    parser.add_argument("--input-csv", default="data/processed/ppmi/ppmi_subject_baseline.csv")
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--num-threads", type=int, default=2)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--no-plot", action="store_true")
    parser.add_argument("--no-missing-indicators", action="store_true")
    args = parser.parse_args(argv)

    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    out_dir = Path(args.output_dir or f"runs/ppmi_meaningful_suite_{stamp}")
    logger = suite_logger("ppmi_suite", out_dir, "ppmi_meaningful_suite.log")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
        os.environ[var] = str(args.num_threads)
    mpl_cache = out_dir / "mpl_cache"
    mpl_cache.mkdir(parents=True, exist_ok=True)
    os.environ["MPLCONFIGDIR"] = str(mpl_cache)

    df = pd.read_csv(args.input_csv, low_memory=False)
    if "subject_id" in df.columns:
        df["subject_id"] = df["subject_id"].astype(str)
    return run_suite(
        df, out_dir, seed=args.seed, num_threads=args.num_threads, limit=args.limit,
        no_plot=args.no_plot, no_missing_indicators=args.no_missing_indicators, logger=logger,
    )


if __name__ == "__main__":
    main()
