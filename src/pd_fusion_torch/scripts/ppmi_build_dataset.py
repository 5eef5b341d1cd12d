"""Build the processed PPMI study-data tables (port of
``scripts/ppmi_build_dataset.py``, same flags and artifacts):

    python -m pd_fusion_torch.scripts.ppmi_build_dataset --config configs/ppmi_studydata.yaml
        [--seed S] [--out_dir D]

Loads the study-data YAML config, applies the optional ``--out_dir`` /
``--seed`` overrides (a seed override pins the split-seed list to that one
seed), runs ``data/ppmi_studydata.py::build_ppmi_datasets`` and logs each
artifact path to stdout and ``ppmi_build_dataset.log``. Host code only.
"""
import argparse
from pathlib import Path

import yaml

from pd_fusion_torch.data.ppmi_studydata import build_ppmi_datasets
from pd_fusion_torch.scripts._cli_common import file_logger


def main(argv=None) -> dict:
    cli = argparse.ArgumentParser(description="Build PPMI study-data datasets")
    cli.add_argument("--config", required=True, help="Path to ppmi_studydata.yaml")
    cli.add_argument("--seed", type=int, default=None, help="Optional seed override")
    cli.add_argument("--out_dir", default=None, help="Override processed_ppmi_dir")
    args = cli.parse_args(argv)

    cfg = yaml.safe_load(Path(args.config).read_text())
    if args.out_dir:
        cfg["processed_ppmi_dir"] = args.out_dir
    if args.seed is not None:
        cfg.setdefault("splits", {})["seeds"] = [args.seed]

    logger = file_logger(
        "ppmi_build", Path(cfg["processed_ppmi_dir"]), "ppmi_build_dataset.log"
    )
    logger.info("Building PPMI datasets with config: %s", args.config)
    paths = build_ppmi_datasets(cfg, logger)
    for key, path in paths.items():
        logger.info("Saved %s -> %s", key, path)
    return paths


if __name__ == "__main__":
    main()
