"""PPMI tabular baseline sweep: schema-group ablations x models x seeds over
the saved splits (port of ``scripts/ppmi_train_tabular.py``, same flags,
config keys and artifacts):

    python -m pd_fusion_torch.scripts.ppmi_train_tabular --config configs/ppmi_studydata.yaml
        [--seed S] [--out_dir D] [--num-threads T] [--limit N]

Writes ``config_resolved.yaml``, ``pred_{model}_{ablation}_seed{seed}.csv``
per fit, ``results_all.csv``, ``summary_sweep_mean.csv`` and
``ppmi_train_tabular.log`` into the output directory.

Preprocessing is the JAX script's scikit-learn ``ColumnTransformer`` as
numpy (``analysis/column_transformer.py``, value for value). The models:

- ``logreg``: ``nn/logreg.py`` (balanced, C=1, to its optimum) on the card,
  for ``LogisticRegression(max_iter=1000, class_weight="balanced")``;
- ``lgbm``: the JAX script tries LightGBM, then XGBoost, then scikit-learn's
  HistGradientBoosting; none of the first two is on either machine. The port
  resolves ``analysis/tabular.py::boosted_tree``: on the card the device
  GBDT with LightGBM's settings (300 trees, lr 0.05, 31 leaves, balanced
  classes; no subsampling), on the CPU HistGradientBoosting as the JAX
  script ends up using. The seeds of one ablation fit as one fold-batched
  ``train_gbdt`` call (each ensemble equals its own fit);
- ``mlp``: ``nn/mlp.py`` init and ``nn/trainer.py::train_fullbatch_earlystop``
  (pos-weighted BCE, best-val-AUC restore, patience), the weights drawn
  from a CPU generator seeded with the seed and the dropout keeps from a
  generator on the card seeded with the seed + 1 (``mlp_generators``).

Metrics are ``utils/metrics.py::compute_metrics`` on the card. Runs on the
card unless ``PD_FUSION_TORCH_DEVICE`` names another device. ``LAST_TIMINGS``
holds the last run's wall seconds per stage.
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
import torch
import yaml

from pd_fusion_torch.analysis.column_transformer import SuiteColumnTransformer
from pd_fusion_torch.analysis.tabular import boosted_tree, fit_boosted_trees, suite_logger
from pd_fusion_torch.nn.logreg import BalancedLogisticRegression
from pd_fusion_torch.nn.mlp import mlp_init
from pd_fusion_torch.nn.trainer import predict_proba, train_fullbatch_earlystop
from pd_fusion_torch.ops.metrics import METRIC_NAMES
from pd_fusion_torch.utils.device import get_device

DEFAULT_MODELS = ["logreg", "lgbm", "mlp"]
DEFAULT_ABLATIONS = [
    {"name": "clinical_only", "groups": ["clinical"]},
    {"name": "mri_only", "groups": ["mri_derived"]},
    {"name": "datsbr_only", "groups": ["datsbr"]},
    {"name": "clinical_mri", "groups": ["clinical", "mri_derived"]},
    {"name": "clinical_datsbr", "groups": ["clinical", "datsbr"]},
    {"name": "full_fusion", "groups": ["clinical", "mri_derived", "datsbr", "nonmotor"]},
]
LAST_TIMINGS: Dict[str, float] = {}


def mlp_generators(seed: int, device):
    """(init generator on the CPU, dropout generator on ``device``)."""
    return (torch.Generator().manual_seed(seed),
            torch.Generator(device=device).manual_seed(seed + 1))


def train_mlp(X_train, y_train, X_val, y_val, seed: int, cfg: Dict):
    """Pos-weighted MLP with the best-val-AUC restore; -> predict(X)."""
    dev = get_device()
    hidden = cfg.get("hidden_dims", [128, 64])
    init_gen, draw_gen = mlp_generators(seed, dev)
    params = mlp_init(init_gen, [X_train.shape[1], *hidden, 1], device=dev)
    pos = float(y_train.sum())
    pos_weight = (len(y_train) - pos) / max(pos, 1.0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    best = train_fullbatch_earlystop(
        params, t(X_train), t(y_train), t(X_val), t(y_val), draw_gen,
        float(cfg.get("lr", 1e-3)), np.float32(pos_weight), int(cfg.get("max_epochs", 100)),
        float(cfg.get("dropout", 0.3)), patience=int(cfg.get("patience", 10)),
    )
    return lambda X: predict_proba(best, t(X)).cpu().numpy()


def _metrics(y_test, y_prob, logger, what) -> Dict[str, float]:
    """The fit's metrics, keyed in the JAX script's column order (its
    jitted metrics come back as a dict with sorted keys)."""
    from pd_fusion_torch.utils.metrics import compute_metrics

    try:
        return dict(sorted(compute_metrics(y_test, y_prob).items()))
    except ValueError as exc:
        logger.warning("Metric computation failed for %s/%s/%s: %s", *what, exc)
        return {k: float("nan") for k in METRIC_NAMES}


def run_suite(cfg: Dict, out_dir: Path, seeds=None, limit=None, num_threads: int = 2):
    from pd_fusion_torch.data.ppmi_studydata import create_splits

    out_dir = Path(out_dir)
    logger = suite_logger("ppmi_train", out_dir, "ppmi_train_tabular.log")
    (out_dir / "config_resolved.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
        os.environ[var] = str(num_threads)
    clock = {k: 0.0 for k in ("prep_s", "logreg_s", "lgbm_s", "mlp_s", "metrics_s")}
    t_run = time.perf_counter()

    processed_dir = Path(cfg["processed_ppmi_dir"])
    level = cfg.get("modeling_level", "baseline")
    dataset_path = processed_dir / (
        "ppmi_visit_level.csv" if level == "visit" else "ppmi_subject_baseline.csv"
    )
    df = pd.read_csv(dataset_path, low_memory=False)
    if "subject_id" in df.columns:
        df["subject_id"] = df["subject_id"].astype(str)
    schema = json.loads((processed_dir / "ppmi_feature_schema.json").read_text())
    if limit:
        df = df.sample(n=min(limit, len(df)), random_state=42)

    ablations = cfg.get("ablations", []) or DEFAULT_ABLATIONS
    models = cfg.get("models", DEFAULT_MODELS)
    split_cfg = cfg.get("splits", {})
    if seeds is None:
        seeds = split_cfg.get("seeds", [42, 43, 44, 45, 46])

    results = []  # one row per fit, in the JAX script's order
    trees = {}  # ablation -> the lgbm fits, made together after the loop

    def finish(slot, seed, ablation, model_name, test_df, y_prob):
        t0 = time.perf_counter()
        y_test = test_df["label"].to_numpy()
        metrics = _metrics(y_test, y_prob, logger, (model_name, ablation, seed))
        results[slot] = {"seed": seed, "ablation": ablation, "model": model_name, **metrics}
        pd.DataFrame(
            {"subject_id": test_df["subject_id"].values, "y_true": y_test, "y_prob": y_prob}
        ).to_csv(out_dir / f"pred_{model_name}_{ablation}_seed{seed}.csv", index=False)
        clock["metrics_s"] += time.perf_counter() - t0

    for seed in seeds:
        split_path = processed_dir / f"ppmi_splits_seed{seed}.json"
        if split_path.exists():
            split_ids = {
                k: [str(v) for v in ids]
                for k, ids in json.loads(split_path.read_text()).items()
            }
        else:
            labels = df.set_index("subject_id")["label"]
            split_ids = create_splits(labels, [seed], split_cfg)[seed]

        parts = {
            name: df[df["subject_id"].isin(split_ids[name])].copy()
            for name in ("train", "val", "test")
        }
        if any(p.empty for p in parts.values()):
            logger.warning("Empty split for seed %s; check subject_id types.", seed)
            continue
        train_df, val_df, test_df = parts["train"], parts["val"], parts["test"]

        for ablation in ablations:
            feat_cols = []
            for group in ablation["groups"]:
                feat_cols.extend(schema["groups"].get(group, {}).get("features", []))
            feat_cols = [c for c in feat_cols if c in df.columns]
            if not feat_cols:
                logger.warning("No features found for ablation %s", ablation["name"])
                continue

            y_train = train_df["label"].to_numpy()
            y_val = val_df["label"].to_numpy()
            numeric_cols = [c for c in feat_cols if pd.api.types.is_numeric_dtype(df[c])]
            cat_cols = [c for c in feat_cols if c not in numeric_cols]

            for model_name in models:
                if model_name not in ("logreg", "lgbm", "mlp"):
                    logger.warning("Unknown model %s", model_name)
                    continue
                t0 = time.perf_counter()
                pre = SuiteColumnTransformer(model_name in ("logreg", "mlp"), numeric_cols,
                                             cat_cols)
                X_tr = pre.fit_transform(train_df[feat_cols])
                X_va = pre.transform(val_df[feat_cols])
                X_te = pre.transform(test_df[feat_cols])
                clock["prep_s"] += time.perf_counter() - t0
                results.append(None)
                slot = len(results) - 1
                t0 = time.perf_counter()
                if model_name == "logreg":
                    clf = BalancedLogisticRegression(max_iter=1000).fit(X_tr, y_train)
                    y_prob = clf.predict_proba(X_te)[:, 1]
                    clock["logreg_s"] += time.perf_counter() - t0
                elif model_name == "lgbm":
                    trees.setdefault(ablation["name"], []).append(
                        (slot, seed, boosted_tree(seed, num_threads, logger), X_tr, y_train,
                         X_te, test_df))
                    clock["lgbm_s"] += time.perf_counter() - t0
                    continue
                else:
                    predict = train_mlp(X_tr, y_train, X_va, y_val, seed, cfg.get("mlp", {}))
                    y_prob = predict(X_te)
                    clock["mlp_s"] += time.perf_counter() - t0
                finish(slot, seed, ablation["name"], model_name, test_df, y_prob)

    for ablation, fits in trees.items():
        t0 = time.perf_counter()
        fit_boosted_trees([f[2] for f in fits], [f[3] for f in fits], [f[4] for f in fits])
        probs = [clf.predict_proba(X_te)[:, 1] if hasattr(clf, "predict_proba")
                 else clf.predict(X_te) for _, _, clf, _, _, X_te, _ in fits]
        clock["lgbm_s"] += time.perf_counter() - t0
        for (slot, seed, *_, test_df), y_prob in zip(fits, probs):
            finish(slot, seed, ablation, "lgbm", test_df, y_prob)

    results_df = pd.DataFrame([r for r in results if r is not None])
    results_df.to_csv(out_dir / "results_all.csv", index=False)
    summary = results_df.groupby(["model", "ablation"]).agg(["mean", "std"]).reset_index()
    summary.columns = [
        "_".join([c for c in col if c]) if isinstance(col, tuple) else col
        for col in summary.columns
    ]
    summary.to_csv(out_dir / "summary_sweep_mean.csv", index=False)
    LAST_TIMINGS.clear()
    LAST_TIMINGS.update(clock, total_s=time.perf_counter() - t_run)
    logger.info("stage wall seconds: %s", {k: round(v, 3) for k, v in LAST_TIMINGS.items()})
    logger.info("Saved results to %s", out_dir / "results_all.csv")
    return results_df


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train PPMI tabular baselines")
    parser.add_argument("--config", required=True)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--out_dir", default=None)
    parser.add_argument("--num-threads", type=int, default=2)
    parser.add_argument("--limit", type=int, default=None, help="Optional limit for smoke tests")
    args = parser.parse_args(argv)

    cfg = yaml.safe_load(Path(args.config).read_text())
    timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    out_dir = Path(args.out_dir or f"runs/ppmi_tabular_{timestamp}")
    seeds = [args.seed] if args.seed is not None else None
    return run_suite(cfg, out_dir, seeds=seeds, limit=args.limit, num_threads=args.num_threads)


if __name__ == "__main__":
    main()
