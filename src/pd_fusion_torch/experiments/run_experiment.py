"""Experiment orchestration: single-run and K-fold CV pipelines (port of
``pd_fusion/experiments/run_experiment.py``).

- ``run_full_pipeline``: load -> stratified split -> train -> save
  model+prep -> provenance -> scenario eval -> results.yaml ->
  ROC/PR/calibration/degradation plots -> risk-coverage.
- ``run_cv_pipeline``: (group-)k-fold with fold_assignments.csv, optional
  nested calibration split, per-fold results_fold_i.yaml and
  full-observation prediction CSVs, fold-1 example plots, mean/std
  aggregation into results_aggregated.yaml + summary_table.{csv,tex},
  optional session-shift retrains.

- ``evaluate_run``: re-evaluate a finished run's saved model on its
  dataset (the ``evaluate`` subcommand) into ``results_eval.yaml``.

Artifact names and YAML structure match the JAX package's. Provenance
records torch's version and the device instead of JAX's. Datasets, as in
the JAX package: ``ppmi`` (synthetic or the processed parquet),
``openneuro_ds001907`` (the prebuilt manifest and its feature modes),
``uci_parkinsons``, ``uci_telemonitoring``, and ``openneuro_<accession>``,
``ds004471`` or ``ds004392`` (a BIDS participants table; the dev loaders
read local files under ``paths.dev_data_dir()``).

Under ``torchrun`` (``parallel/distributed.py``) every rank runs the
pipeline; rank 0 makes the run id and broadcasts it, and only rank 0
creates the run directory and writes into it (artifacts, YAML, CSVs,
plots). The other ranks' ``run_dir`` is ``None``. The CV engine shards
what it shards (``parallel/cv_engine.py``) and hands every rank the same
results.
"""
import datetime
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd

from pd_fusion_torch.data.schema import TARGET_COL
from pd_fusion_torch.data.splits import (
    get_group_kfold_splits,
    get_kfold_splits,
    get_subset_masks,
    split_train_calibration,
    stratified_split,
)
from pd_fusion_torch.evaluation.evaluate import (
    compute_risk_coverage,
    evaluate_model,
    predict_for_masks,
    predict_proba_for_scenario,
)
from pd_fusion_torch.parallel import distributed
from pd_fusion_torch.evaluation.plots import (
    plot_calibration_curve_func,
    plot_degradation_curve,
    plot_pr_curve,
    plot_risk_coverage,
    plot_roc_curve,
)
from pd_fusion_torch.paths import ROOT_DIR, get_run_dir
from pd_fusion_torch.training.train import train_pipeline
from pd_fusion_torch.utils.io import load_yaml, save_pickle, save_yaml
from pd_fusion_torch.utils.profiling import maybe_profile, phase_timer
from pd_fusion_torch.utils.seed import set_seed


def _resolve_config_path(path_str) -> Path:
    p = Path(path_str)
    return p if p.exists() else ROOT_DIR / p


def load_dataset(config, data_config, synthetic):
    """Dataset dispatch shared by both pipelines."""
    dataset_name = config.get("dataset", "ppmi")
    logging.getLogger("pd_fusion").info(f"Loading dataset: {dataset_name}")
    if dataset_name == "uci_parkinsons":
        from pd_fusion_torch.data.dev_datasets.uci_parkinsons import load_uci_parkinsons

        return dataset_name, *load_uci_parkinsons()
    if dataset_name == "uci_telemonitoring":
        from pd_fusion_torch.data.dev_datasets.uci_telemonitoring import load_uci_telemonitoring

        return dataset_name, *load_uci_telemonitoring()
    if dataset_name == "openneuro_ds001907":
        from pd_fusion_torch.data.openneuro_ds001907 import load_openneuro_ds001907

        return dataset_name, *load_openneuro_ds001907(data_config)
    if dataset_name.startswith("openneuro_") or dataset_name in ("ds004471", "ds004392",
                                                                 "ds001907"):
        from pd_fusion_torch.data.dev_datasets.openneuro import load_openneuro_dataset

        return dataset_name, *load_openneuro_dataset(dataset_name.replace("openneuro_", ""))
    if dataset_name == "ppmi":
        from pd_fusion_torch.data.ppmi_loader import load_ppmi_data

        return dataset_name, *load_ppmi_data(data_config, synthetic=synthetic)
    raise ValueError(f"Unknown dataset: {dataset_name}")


def _env_info():
    import torch

    from pd_fusion_torch.utils.device import get_device

    dev = get_device()
    return {
        "python": f"{sys.version_info.major}.{sys.version_info.minor}.{sys.version_info.micro}",
        "torch": str(torch.__version__),
        "cuda": str(torch.version.cuda),
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "device_count": torch.cuda.device_count() if dev.type == "cuda" else 0,
        "world_size": distributed.world_size(),
        "dist_backend": distributed.backend() or "none",
    }


def _save_run_provenance(run_dir, config, eval_config, dataset_name, synthetic, overrides):
    def _git_commit():
        try:
            return (
                subprocess.check_output(
                    ["git", "rev-parse", "HEAD"], cwd=ROOT_DIR, stderr=subprocess.DEVNULL
                )
                .decode()
                .strip()
            )
        except Exception:
            return "unknown"

    provenance = {
        "timestamp": datetime.datetime.now().isoformat(),
        "git_commit": _git_commit(),
        "command": os.environ.get("PD_FUSION_COMMAND", "unknown"),
        "seed": config.get("seed", None),
        "dataset": dataset_name,
        "synthetic": synthetic,
        "overrides": overrides or {},
        "scenarios": eval_config.get("scenarios", []),
        "env": _env_info(),
    }
    save_yaml(config, run_dir / "resolved_config.yaml")
    save_yaml(eval_config, run_dir / "eval_config.yaml")
    save_yaml(provenance, run_dir / "provenance.yaml")


def _load_configs(config_path, overrides):
    config = load_yaml(_resolve_config_path(config_path))
    if overrides:
        config.update(overrides)
    data_config = load_yaml(_resolve_config_path(config.get("data_config", "configs/data_ppmi.yaml")))
    eval_config = load_yaml(
        _resolve_config_path(config.get("eval_config", "configs/eval_missingness.yaml"))
    )
    if config.get("group_col"):
        eval_config["group_col"] = config.get("group_col")
    return config, data_config, eval_config


def _run_id(overrides, prefix):
    """The configured output directory, else a timestamped id made by rank 0
    and broadcast to the other ranks."""
    if overrides and "output_dir" in overrides:
        return overrides["output_dir"]
    return distributed.broadcast_object(
        f"{prefix}_{datetime.datetime.now().strftime('%Y%m%d_%H%M%S')}")


def _run_dir(run_id):
    """The run directory, created, on rank 0; ``None`` on the other ranks,
    which write nothing."""
    return get_run_dir(run_id) if distributed.is_primary() else None


def _example_plots(run_dir, config, suffix, results, y_true, y_prob, masks):
    plot_degradation_curve(results, run_dir / f"degradation{suffix}.png")
    plot_roc_curve(y_true, y_prob, run_dir / f"roc_curve{suffix}.png")
    plot_pr_curve(y_true, y_prob, run_dir / f"pr_curve{suffix}.png")
    plot_calibration_curve_func(
        y_true, y_prob, run_dir / f"calibration{suffix}.png", config["model_type"]
    )
    if config.get("risk_coverage", True):
        rc = compute_risk_coverage(y_true, y_prob, masks)
        plot_risk_coverage(rc, run_dir / f"risk_coverage{suffix}.png")


def run_full_pipeline(config_path: str, synthetic: bool = False, overrides: dict = None):
    logger = logging.getLogger("pd_fusion")
    config, data_config, eval_config = _load_configs(config_path, overrides)
    set_seed(config.get("seed", 42))

    run_id = _run_id(overrides, "run")
    run_dir = _run_dir(run_id)
    logger.info(f"Starting experiment: {run_id}")
    logger.info(f"Config: {config_path}")
    if overrides:
        logger.info(f"Overrides: {overrides}")

    with phase_timer("load_data"):
        dataset_name, df, masks = load_dataset(config, data_config, synthetic)

    train_df, val_df, test_df = stratified_split(df, seed=config.get("seed", 42))
    train_masks = get_subset_masks(masks, train_df.index)
    val_masks = get_subset_masks(masks, val_df.index)
    test_masks = get_subset_masks(masks, test_df.index)

    with phase_timer("train"), maybe_profile("train"):
        model, prep_info = train_pipeline(config, train_df, val_df, train_masks, val_masks)

    if run_dir is not None:
        model.save(run_dir / "model.pt")
        save_pickle(prep_info, run_dir / "preprocess.pkl")
        _save_run_provenance(run_dir, config, eval_config, dataset_name, synthetic, overrides)

    with phase_timer("evaluate"), maybe_profile("evaluate"):
        results = evaluate_model(model, test_df, test_masks, prep_info, eval_config)
    if run_dir is not None:
        save_yaml(results, run_dir / "results.yaml")

    logger.info("Generating plots...")
    y_test = test_df[TARGET_COL].values
    y_prob = predict_for_masks(model, test_df, test_masks, prep_info)
    if run_dir is not None:
        _example_plots(run_dir, config, "", results, y_test, y_prob, test_masks)
        if config.get("conformal", False):
            _fit_conformal(model, prep_info, val_df, val_masks, run_dir, logger)

    logger.info(f"Experiment finished. Results saved in {run_dir}")
    return results


def _fit_conformal(model, prep_info, val_df, val_masks, run_dir, logger):
    """Mask-conditioned conformal thresholds on the val split ->
    ``conformal_model.pkl``; a failure is logged and skipped, as in the
    JAX package."""
    from pd_fusion_torch.data.preprocess import preprocess_features
    from pd_fusion_torch.evaluation.evaluate import is_mil_prep, is_moe_prep
    from pd_fusion_torch.models.conformal import MaskConformalWrapper

    cp_model = MaskConformalWrapper(model, alpha=0.1)
    try:
        if is_moe_prep(prep_info):
            val_inputs = {mod: preprocess_features(val_df, fs, imp, scl)[0]
                          for mod, (imp, scl, fs) in prep_info.items()}
        elif is_mil_prep(prep_info):
            val_inputs = val_df[prep_info[1]].tolist()
        else:
            imp, scl, fs = prep_info
            val_inputs, _, _ = preprocess_features(val_df, fs, imp, scl)
        cp_model.fit(val_inputs, val_df[TARGET_COL].values, val_masks)
        cp_model.save(run_dir / "conformal_model.pkl")
    except Exception as e:
        logger.warning(f"Conformal calibration skipped due to error: {e}")


def evaluate_run(config_path: str, run_dir: str):
    """Re-evaluate a finished run's saved model (the ``evaluate`` subcommand).

    Loads model.pt + preprocess.pkl from the run directory, reloads the
    dataset named by the run's resolved config (same seed -> same
    stratified test split), re-runs the scenario evaluation with the eval
    config from ``config_path`` (or the run's own eval_config), and writes
    ``results_eval.yaml``.
    """
    from pd_fusion_torch.models.serialization import load_model
    from pd_fusion_torch.utils.io import load_pickle

    logger = logging.getLogger("pd_fusion")
    run_path = Path(run_dir)
    resolved = load_yaml(run_path / "resolved_config.yaml")
    prov = load_yaml(run_path / "provenance.yaml") if (run_path / "provenance.yaml").exists() else {}

    eval_config = load_yaml(_resolve_config_path(config_path)) if config_path else None
    if not eval_config or "scenarios" not in eval_config:
        eval_config = load_yaml(run_path / "eval_config.yaml")
    if resolved.get("group_col"):
        eval_config["group_col"] = resolved["group_col"]

    data_config = load_yaml(
        _resolve_config_path(resolved.get("data_config", "configs/data_ppmi.yaml"))
    )
    set_seed(resolved.get("seed", 42))
    _, df, masks = load_dataset(resolved, data_config, bool(prov.get("synthetic", False)))

    _, _, test_df = stratified_split(df, seed=resolved.get("seed", 42))
    test_masks = get_subset_masks(masks, test_df.index)

    model = load_model(run_path / "model.pt")
    prep_info = load_pickle(run_path / "preprocess.pkl")

    results = evaluate_model(model, test_df, test_masks, prep_info, eval_config)
    if distributed.is_primary():
        save_yaml(results, run_path / "results_eval.yaml")
    logger.info(f"Re-evaluation saved to {run_path / 'results_eval.yaml'}")
    return results


def run_cv_pipeline(config_path: str, k: int = 5, synthetic: bool = False, overrides: dict = None):
    logger = logging.getLogger("pd_fusion")
    config, data_config, eval_config = _load_configs(config_path, overrides)
    set_seed(config.get("seed", 42))

    dataset_name, df, masks = load_dataset(config, data_config, synthetic)

    run_id = _run_id(overrides, "cv")
    run_dir = _run_dir(run_id)
    logger.info(f"Starting {k}-Fold CV: {run_id}")
    if run_dir is not None:
        _save_run_provenance(run_dir, config, eval_config, dataset_name, synthetic, overrides)

    group_col = config.get("group_col") or config.get("cv_group_col")
    seed = config.get("seed", 42)
    if group_col:
        folds = list(get_group_kfold_splits(df, n_splits=k, seed=seed, group_col=group_col))
    else:
        folds = list(get_kfold_splits(df, n_splits=k, seed=seed))

    # fold-assignment CSV (validation fold index per sample)
    fold_assign = pd.Series([-1] * len(df), index=df.index, name="fold")
    for i, (_, val_df_tmp) in enumerate(folds):
        fold_assign.loc[val_df_tmp.index] = i + 1
    fold_df = df.copy()
    fold_df["fold"] = fold_assign.values
    if group_col and group_col in fold_df.columns:
        keep = [group_col, "fold", TARGET_COL] + [c for c in ["session"] if c in fold_df.columns]
        fold_df = fold_df[keep]
    if run_dir is not None:
        fold_df.to_csv(run_dir / "fold_assignments.csv", index=False)

    from pd_fusion_torch.parallel.cv_engine import run_parallel_cv, supports_parallel_cv
    from pd_fusion_torch.training.train import _resolve_params

    def _save_fold_preds(i, val_df, y_true, y_prob):
        if run_dir is None:
            return
        pred_df = pd.DataFrame({"y_true": y_true.astype(int), "y_prob": y_prob, "fold": i + 1})
        if group_col and group_col in val_df.columns:
            pred_df[group_col] = val_df[group_col].values
        if "session" in val_df.columns:
            pred_df["session"] = val_df["session"].values
        pred_df.to_csv(run_dir / f"preds_fold_{i + 1}_full_observation.csv", index=False)

    metrics_all = []
    if supports_parallel_cv(config):
        logger.info(f"Running parallel CV over {k} folds")
        _resolve_params(config, config["model_type"])
        with phase_timer("parallel_cv"), maybe_profile("parallel_cv"):
            metrics_all, fold_preds = run_parallel_cv(config, df, masks, folds, eval_config)
        for i, res in enumerate(metrics_all):
            res["fold"] = i + 1
            if run_dir is not None:
                save_yaml(res, run_dir / f"results_fold_{i + 1}.yaml")
            _save_fold_preds(i, folds[i][1], *fold_preds[i])
        if config.get("cv_plot_example", False) and run_dir is not None:
            fold1 = {kk: v for kk, v in metrics_all[0].items() if kk != "fold"}
            _example_plots(run_dir, config, "_fold1", fold1, *fold_preds[0], None)
        folds_iter = []
    else:
        folds_iter = list(enumerate(folds))

    for i, (train_df, val_df) in folds_iter:
        logger.info(f"--- Fold {i + 1}/{k} ---")
        train_masks = get_subset_masks(masks, train_df.index)
        val_masks = get_subset_masks(masks, val_df.index)

        use_nested = bool(config.get("nested_calibration", False)) and bool(
            config.get("calibrate", False)
        )
        calib_df = calib_masks = None
        if use_nested:
            train_df, calib_df = split_train_calibration(
                train_df,
                calib_size=float(config.get("calibration_split", 0.2)),
                seed=seed,
                group_col=group_col,
            )
            train_masks = get_subset_masks(masks, train_df.index)
            calib_masks = get_subset_masks(masks, calib_df.index)

        model, prep_info = train_pipeline(
            config,
            train_df,
            calib_df if use_nested else val_df,
            train_masks,
            calib_masks if use_nested else val_masks,
        )

        results = evaluate_model(model, val_df, val_masks, prep_info, eval_config)
        results["fold"] = i + 1
        metrics_all.append(results)
        if run_dir is not None:
            save_yaml(results, run_dir / f"results_fold_{i + 1}.yaml")

        scenario = {"name": "full_observation", "drop_modalities": []}
        y_true, y_prob = predict_proba_for_scenario(model, val_df, val_masks, prep_info, scenario)
        _save_fold_preds(i, val_df, y_true, y_prob)

        if config.get("cv_plot_example", False) and i == 0 and run_dir is not None:
            fold_results = {kk: v for kk, v in results.items() if kk != "fold"}
            y_true = val_df[TARGET_COL].values
            y_prob = predict_for_masks(model, val_df, val_masks, prep_info)
            _example_plots(run_dir, config, "_fold1", fold_results, y_true, y_prob, val_masks)

    logger.info("Aggregating results...")
    aggregated, summary_rows = {}, []
    if metrics_all:
        scenario_names = [kk for kk in metrics_all[0].keys() if kk != "fold"]
        for scen in scenario_names:
            aggregated[scen] = {}
            for m in metrics_all[0][scen].keys():
                values = [fold_res[scen][m] for fold_res in metrics_all]
                mean_val, std_val = float(np.mean(values)), float(np.std(values))
                aggregated[scen][m] = {"mean": mean_val, "std": std_val}
                summary_rows.append(
                    {"scenario": scen, "metric": m, "mean": mean_val, "std": std_val}
                )

    if run_dir is not None:
        save_yaml(aggregated, run_dir / "results_aggregated.yaml")
        summary_df = pd.DataFrame(summary_rows)
        summary_df.to_csv(run_dir / "summary_table.csv", index=False)
        try:
            summary_df.to_latex(run_dir / "summary_table.tex", index=False, float_format="%.4f")
        except Exception as e:  # pragma: no cover
            logger.warning(f"LaTeX table generation failed: {e}")

    logger.info(f"CV Finished. Summary saved to {run_dir}")

    if config.get("session_shift", False):
        session_col = config.get("session_col", "session")
        if session_col in df.columns:
            logger.info("Running session-shift evaluation...")
            for train_ses, test_ses in [(1, 2), (2, 1)]:
                tr = df[df[session_col] == train_ses]
                va = df[df[session_col] == test_ses]
                tr_masks = get_subset_masks(masks, tr.index)
                va_masks = get_subset_masks(masks, va.index)
                model, prep_info = train_pipeline(config, tr, va, tr_masks, va_masks)
                results = evaluate_model(model, va, va_masks, prep_info, eval_config)
                if run_dir is not None:
                    save_yaml(results,
                              run_dir / f"session_shift_ses{train_ses}_to_{test_ses}.yaml")
        else:
            logger.warning(
                f"session_shift requested but session_col '{session_col}' not found."
            )
    return aggregated
