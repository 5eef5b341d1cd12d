"""Bootstrap confidence intervals over pooled fold predictions (port of
``pd_fusion/analysis/bootstrap_ci.py``):

    python -m pd_fusion_torch.analysis.bootstrap_ci --sweep-dir D [--n 1000] [--group-col C]

Per model, ``preds_fold_*_full_observation.csv`` of every run directory are
concatenated (optionally collapsed to group means), resampled ``n`` times
with replacement, and the 2.5/97.5 percentiles of each metric's resample
distribution go to ``summary_bootstrap_ci.csv``.

The resample indices are numpy's (``default_rng(seed).choice``), as in the
JAX package, so both packages see the same resamples. All resamples'
metrics are one batched device program: ``ops/metrics.py::binary_metrics``
over the leading resample axis of [n, N] gathered labels and
probabilities (the JAX package maps the metric program over the
resamples). The percentiles are numpy on the host.
"""
import argparse
from pathlib import Path

import numpy as np
import pandas as pd
import torch
import yaml

from pd_fusion_torch.ops.metrics import binary_metrics
from pd_fusion_torch.utils.device import get_device


def _model_name(run_dir: Path) -> str:
    cfg = run_dir / "resolved_config.yaml"
    if cfg.exists():
        conf = yaml.safe_load(open(cfg))
        model_type = conf.get("model_type")
        modality = conf.get("modality")
        if model_type == "unimodal_gbdt" and modality:
            return f"unimodal_{modality}"
        return model_type or run_dir.name
    parts = run_dir.name.split("_s")
    return parts[0] if len(parts) == 2 else run_dir.name


def resample_indices(n_rows: int, n: int = 1000, seed: int = 42) -> np.ndarray:
    """[n, n_rows] row indices, drawn as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.arange(n_rows), size=(n, n_rows), replace=True)


def bootstrap_metrics(y_true, y_prob, n: int = 1000, seed: int = 42):
    """Device bootstrap -> {metric: [n] numpy array}."""
    idx = resample_indices(len(y_true), n, seed)
    dev = get_device()
    y_r = torch.as_tensor(np.asarray(y_true, np.float32)[idx], device=dev)
    p_r = torch.as_tensor(np.asarray(y_prob, np.float32)[idx], device=dev)
    with torch.no_grad():  # [n, N] -> {metric: [n]}, one batched reduction
        out = binary_metrics(y_r, p_r)
    return {k: v.cpu().numpy() for k, v in out.items()}


def run_bootstrap(sweep_dir: Path, n: int = 1000, group_col: str = ""):
    model_preds = {}
    for run_dir in sweep_dir.iterdir():
        if not run_dir.is_dir():
            continue
        pred_files = list(run_dir.glob("preds_fold_*_full_observation.csv"))
        if not pred_files:
            continue
        df_preds = pd.concat([pd.read_csv(f) for f in pred_files], ignore_index=True)
        model_preds.setdefault(_model_name(run_dir), []).append(df_preds)

    rows = []
    for model, dfs in model_preds.items():
        df = pd.concat(dfs, ignore_index=True)
        y_true, y_prob = df["y_true"].values, df["y_prob"].values
        if group_col and group_col in df.columns:
            g = df.groupby(group_col).agg({"y_true": "first", "y_prob": "mean"}).reset_index()
            y_true, y_prob = g["y_true"].values, g["y_prob"].values

        boot = bootstrap_metrics(y_true, y_prob, n=n)
        for metric, vals in boot.items():
            lo, hi = np.percentile(vals, [2.5, 97.5])
            rows.append(
                {"Model": model, "Metric": metric, "CI_low": float(lo), "CI_high": float(hi)}
            )

    out_path = sweep_dir / "summary_bootstrap_ci.csv"
    pd.DataFrame(rows).to_csv(out_path, index=False)
    print(f"Saved bootstrap CIs to {out_path}")
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser(description="Bootstrap CIs from per-fold predictions")
    parser.add_argument("--sweep-dir", type=str, required=True)
    parser.add_argument("--n", type=int, default=1000)
    parser.add_argument("--group-col", type=str, default="")
    args = parser.parse_args(argv)
    return run_bootstrap(Path(args.sweep_dir), n=args.n, group_col=args.group_col)


if __name__ == "__main__":
    main()
