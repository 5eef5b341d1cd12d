"""PPMI tabular sweep report (port of ``scripts/ppmi_eval_report.py``,
same flags and artifacts):

    python -m pd_fusion_torch.scripts.ppmi_eval_report --config <yaml> --out_dir <run dir>
        [--seed S]

Reads a run directory's ``results_all.csv``, optionally keeps one seed,
aggregates mean/std per (model, ablation) into ``summary_sweep_mean.csv``
and writes the same table sorted by mean ROC-AUC as ``ranking_table.csv``;
progress goes to stdout and ``ppmi_eval_report.log``. Host code only.
"""
import argparse
from pathlib import Path

import pandas as pd
import yaml

from pd_fusion_torch.scripts._cli_common import file_logger

GROUP_KEYS = ["model", "ablation"]
RANK_METRIC = "roc_auc_mean"


def build_report(results: pd.DataFrame):
    """(summary, ranking): per-group mean/std with flattened column names."""
    agg = results.groupby(GROUP_KEYS).agg(["mean", "std"]).reset_index()
    agg.columns = ["_".join(part for part in col if part) if isinstance(col, tuple) else col
                   for col in agg.columns]
    return agg, agg.sort_values(RANK_METRIC, ascending=False)


def main(argv=None):
    cli = argparse.ArgumentParser(description="Generate PPMI tabular report")
    cli.add_argument("--config", required=True)
    cli.add_argument("--seed", type=int, default=None)
    cli.add_argument("--out_dir", required=True, help="Run directory with results_all.csv")
    args = cli.parse_args(argv)

    # the config is parsed only to validate it; the report comes from the
    # run's results_all.csv
    yaml.safe_load(Path(args.config).read_text())

    out_dir = Path(args.out_dir)
    logger = file_logger("ppmi_report", out_dir, "ppmi_eval_report.log")
    source = out_dir / "results_all.csv"
    if not source.exists():
        raise FileNotFoundError(f"Missing {source}")
    results = pd.read_csv(source)
    if args.seed is not None:
        results = results[results["seed"] == args.seed]

    summary, ranking = build_report(results)
    for frame, fname in ((summary, "summary_sweep_mean.csv"),
                         (ranking, "ranking_table.csv")):
        frame.to_csv(out_dir / fname, index=False)
        logger.info("Saved %s to %s", fname.split("_")[0], out_dir / fname)
    return summary, ranking


if __name__ == "__main__":
    main()
