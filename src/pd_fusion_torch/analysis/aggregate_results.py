"""Sweep aggregation CLI (a copy of ``pd_fusion/analysis/aggregate_results.py``,
which is pandas on the host):

    python -m pd_fusion_torch.analysis.aggregate_results --sweep-dir D [--output summary.csv]

Walks run directories, reads provenance/resolved_config and results.yaml
(single runs) or results_aggregated.yaml (CV runs), builds a long-form
summary CSV plus summary_table.{csv,tex}, and prints the top
full_observation ROC-AUC rows.
"""
import argparse
from pathlib import Path
from typing import Dict, List

import pandas as pd
import yaml


def _load_yaml(path: Path):
    with open(path, "r") as f:
        return yaml.load(f, Loader=yaml.UnsafeLoader)


def _model_and_seed(run_dir: Path):
    model_name, seed = None, "unknown"
    prov = run_dir / "provenance.yaml"
    if prov.exists():
        seed = _load_yaml(prov).get("seed", seed)
    cfg_file = run_dir / "resolved_config.yaml"
    if cfg_file.exists():
        conf = _load_yaml(cfg_file)
        model_type = conf.get("model_type")
        modality = conf.get("modality")
        if model_type == "unimodal_gbdt" and modality:
            model_name = f"unimodal_{modality}"
        else:
            model_name = model_type
    if model_name is None:
        parts = run_dir.name.split("_s")
        if len(parts) == 2:
            model_name, seed = parts[0], parts[1]
        else:
            model_name = run_dir.name
    return model_name, seed


def load_results(sweep_dir: Path) -> List[Dict]:
    rows: List[Dict] = []
    for run_dir in sweep_dir.iterdir():
        if not run_dir.is_dir():
            continue
        res_file = run_dir / "results.yaml"
        agg_file = run_dir / "results_aggregated.yaml"
        if not (res_file.exists() or agg_file.exists()):
            continue
        try:
            model_name, seed = _model_and_seed(run_dir)
            if res_file.exists():
                for scenario, values in _load_yaml(res_file).items():
                    rows.append(
                        {"Model": model_name, "Seed": seed, "Scenario": scenario,
                         "_from_cv": False, **values}
                    )
            else:
                for scenario, values in _load_yaml(agg_file).items():
                    row = {"Model": model_name, "Seed": seed, "Scenario": scenario,
                           "_from_cv": True}
                    for metric, stats in values.items():
                        row[f"{metric}_mean"] = stats.get("mean")
                        row[f"{metric}_std"] = stats.get("std")
                    rows.append(row)
        except Exception as e:  # a run directory that does not parse is reported and skipped
            print(f"Error reading {run_dir}: {e}")
    return rows


def aggregate(sweep_dir: Path, output: Path):
    data = load_results(sweep_dir)
    if not data:
        print("No results found.")
        return None
    df = pd.DataFrame(data)
    df.to_csv(output, index=False)
    print(f"Saved raw results to {output}")

    if df["_from_cv"].any():
        summary = df.drop(columns=["_from_cv"])
        summary.to_csv(output.with_name("summary_table.csv"), index=False)
        summary.to_latex(output.with_name("summary_table.tex"), index=False, float_format="%.4f")
    else:
        numeric = [c for c in df.select_dtypes("number").columns if c != "Seed"]
        agg_df = df.groupby(["Model", "Scenario"])[numeric].agg(["mean", "std"])
        agg_df.columns = ["_".join(col).strip() for col in agg_df.columns.values]
        agg_df.to_csv(output.with_name("summary_aggregated.csv"))
        summary = agg_df.reset_index()
        summary.to_csv(output.with_name("summary_table.csv"), index=False)
        summary.to_latex(output.with_name("summary_table.tex"), index=False, float_format="%.4f")

    print("\n--- Summary (Full Observation ROC-AUC) ---")
    try:
        if df["_from_cv"].any():
            sub = df[df["Scenario"] == "full_observation"]
            cols = ["Model", "Seed"] + [
                c for c in df.columns if c.endswith("roc_auc_mean") or c.endswith("roc_auc_std")
            ]
            key = [c for c in sub.columns if "roc_auc_mean" in c][0]
            print(sub[cols].sort_values(key, ascending=False).head(10))
        else:
            subset = agg_df.xs("full_observation", level="Scenario")
            print(subset[["roc_auc_mean", "roc_auc_std"]].sort_values("roc_auc_mean", ascending=False))
    except Exception:
        print("Could not extract full_observation summary.")
    return df


def main(argv=None):
    parser = argparse.ArgumentParser(description="Aggregate sweep results")
    parser.add_argument("--sweep-dir", type=str, required=True)
    parser.add_argument("--output", type=str, default="summary.csv")
    args = parser.parse_args(argv)
    print(f"Aggregating results from {args.sweep_dir}")
    return aggregate(Path(args.sweep_dir), Path(args.output))


if __name__ == "__main__":
    main()
