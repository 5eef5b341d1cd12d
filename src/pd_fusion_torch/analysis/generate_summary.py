"""Cross-run summary tables and the robustness bar plot (a copy of
``pd_fusion/analysis/generate_summary.py``, which is pandas on the host):

    python -m pd_fusion_torch.analysis.generate_summary --runs R1 R2 ... [--output D]

Pivots ``results_aggregated.yaml`` across runs into ``final_benchmark_summary.csv``
and a "mean ± std" LaTeX table, and draws the full-vs-degraded comparison
``robustness_comparison.png``. Where matplotlib is not installed the PNG is
skipped with the warning ``evaluation/plots.py::_draw`` gives; the CSV and
the ``.tex`` are always written. seaborn is optional (bar styling only).
"""
import argparse
import logging
from pathlib import Path

import pandas as pd
import yaml


def load_results(run_dir):
    path = Path(run_dir) / "results_aggregated.yaml"
    if not path.exists():
        logging.warning(f"No results found in {run_dir}")
        return None
    with open(path, "r") as f:
        return yaml.safe_load(f)


def _robustness_plot(subset: pd.DataFrame, metric: str, out_file: Path):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logging.getLogger("pd_fusion").warning(
            f"matplotlib is not installed; skipping {out_file.name}")
        return
    try:
        import seaborn as sns
    except ImportError:
        sns = None
    plt.figure(figsize=(10, 6))
    if sns is not None:
        sns.barplot(data=subset, x="Model", y="Mean", hue="Scenario", capsize=0.1)
    else:
        for scen, g in subset.groupby("Scenario"):
            plt.bar(g["Model"], g["Mean"], label=scen, alpha=0.6)
        plt.legend()
    plt.title(f"Model Robustness: {metric}")
    plt.ylabel(metric)
    plt.tight_layout()
    plt.savefig(out_file)
    plt.close()
    logging.info(f"Saved plot to {out_file}")


def generate_summary(run_dirs, output_dir, metric="roc_auc", scenario="random_1_drop"):
    records = []
    for rd in run_dirs:
        data = load_results(rd)
        if not data:
            continue
        model_name = Path(rd).name.replace("cv_", "").replace("run_", "")
        for scen, metrics in data.items():
            for met, stats in metrics.items():
                records.append(
                    {"Model": model_name, "Scenario": scen, "Metric": met,
                     "Mean": stats["mean"], "Std": stats["std"]}
                )

    df = pd.DataFrame(records)
    out_path = Path(output_dir)
    out_path.mkdir(parents=True, exist_ok=True)
    df.to_csv(out_path / "final_benchmark_summary.csv", index=False)

    df["Formatted"] = df.apply(lambda r: f"{r['Mean']:.3f} ± {r['Std']:.3f}", axis=1)
    pivot_df = df.pivot(index="Model", columns=["Metric", "Scenario"], values="Formatted")

    cols_to_keep = [
        (m, s)
        for m in ("roc_auc", "balanced_accuracy")
        for s in ("full_observation", "random_1_drop", "clinical_only")
        if (m, s) in pivot_df.columns
    ]
    if cols_to_keep:
        pivot_df = pivot_df[cols_to_keep]
    pivot_df.to_latex(out_path / "summary_table.tex")
    logging.info(f"Saved summary table to {out_path / 'summary_table.tex'}")

    subset = df[(df["Metric"] == metric) & (df["Scenario"].isin(["full_observation", scenario]))]
    _robustness_plot(subset, metric, out_path / "robustness_comparison.png")
    return df


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--runs", nargs="+", required=True, help="List of run directories")
    parser.add_argument("--output", default="final_results", help="Output directory")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s")
    return generate_summary(args.runs, args.output)


if __name__ == "__main__":
    main()
