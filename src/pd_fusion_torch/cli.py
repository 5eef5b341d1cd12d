"""CLI of the port (port of ``pd_fusion/cli.py``).

    python -m pd_fusion_torch.cli run --config <abs path> [--synthetic]
        [--model M] [--k-fold K] [--seed S] [--output-dir D] [--dataset N]
    python -m pd_fusion_torch.cli train --config <abs path> [--synthetic]
    python -m pd_fusion_torch.cli evaluate --config <eval config> --run-dir <run>
    python -m pd_fusion_torch.cli validate-data --config <data config> [--columns C]
    python -m pd_fusion_torch.cli prepare-dev
    python -m pd_fusion_torch.cli download-dev [--dataset all|uci|openneuro|manual]
        [--out D] [--openneuro-metadata-only]

``run`` has the JAX package's flags and semantics: ``--k-fold`` or a
``cv_folds``/``k_folds`` key in the config selects the CV pipeline, else
the single-split pipeline runs. As in the JAX package, the config key is
read from ``Path(--config)`` as given, with no repo-root fallback: a
relative path from another directory skips CV, so pass an absolute path.
``--model`` expands as in the JAX CLI (``unimodal_<mod>[_mlp|_gbdt]``
picks a backbone and loads the sibling model config's params). ``train``
runs the single-split pipeline; ``evaluate`` re-evaluates a finished run
into ``results_eval.yaml``. ``validate-data`` maps and merges the raw PPMI
CSVs a data config names into the processed parquet; ``prepare-dev`` loads
each UCI dev dataset under ``paths.dev_data_dir()`` and prints its shape or
why it is unavailable. ``download-dev`` fetches the UCI files and the
OpenNeuro accessions that are not on disk yet (``data/download/*``; the
OpenNeuro part only where its CLI is installed) and prints how to obtain
the access-controlled datasets. The invocation string is exported as
PD_FUSION_COMMAND for provenance.

Under ``torchrun`` (one process per card)::

    torchrun --standalone --nproc-per-node N -m pd_fusion_torch.cli run ...

``main`` sets up the process group at entry (``parallel/distributed.py``:
NCCL with a card per rank, ``PD_FUSION_TORCH_DIST_BACKEND=gloo`` for
ranks that share a card or run on the CPU), builds the native libraries
once on the first local rank, and tears the group down at exit. Rank 0
logs at INFO and writes the run; the other ranks log at ERROR. Without a
launcher nothing of this happens.
"""
import argparse
import os
import sys
from pathlib import Path

from pd_fusion_torch.experiments.registry import MODEL_REGISTRY
from pd_fusion_torch.parallel import distributed
from pd_fusion_torch.utils.io import load_yaml
from pd_fusion_torch.utils.logging import setup_logging


def _resolve_path(path_str: str) -> Path:
    p = Path(path_str)
    if p.exists():
        return p
    from pd_fusion_torch.paths import ROOT_DIR

    return ROOT_DIR / p


def _load_params(path_str: str):
    try:
        return load_yaml(_resolve_path(path_str)).get("params", {})
    except Exception:
        return {}


def _get_unimodal_backbone(config_path: str) -> str:
    try:
        cfg = load_yaml(_resolve_path(config_path))
        return str(cfg.get("unimodal_backbone", "gbdt")).lower()
    except Exception:
        return "gbdt"


def _build_model_overrides(args) -> dict:
    """Expand --model into model_type/modality/params overrides."""
    overrides = {}
    model = args.model
    if model.startswith("unimodal_") and model != "unimodal_gbdt":
        raw_modality = model.replace("unimodal_", "")
        if raw_modality.endswith("_mlp"):
            backbone, raw_modality = "mlp", raw_modality[: -len("_mlp")]
        elif raw_modality.endswith("_gbdt"):
            backbone, raw_modality = "gbdt", raw_modality[: -len("_gbdt")]
        else:
            backbone = _get_unimodal_backbone(args.config)
        overrides["modality"] = raw_modality
        if backbone == "mlp":
            overrides["model_type"] = "unimodal_mlp"
            overrides["params"] = _load_params("configs/model_fusion.yaml")
        else:
            overrides["model_type"] = "unimodal_gbdt"
            overrides["params"] = _load_params("configs/model_unimodal.yaml")
    elif model in ("fusion_late", "fusion_masked", "fusion_moddrop"):
        overrides["model_type"] = model
        overrides["params"] = _load_params("configs/model_fusion.yaml")
    elif model == "moe":
        overrides["model_type"] = model
        overrides["params"] = _load_params("configs/model_moe.yaml")
    else:
        if model not in MODEL_REGISTRY:
            raise SystemExit(
                f"unknown --model '{model}'; valid: {', '.join(sorted(MODEL_REGISTRY))} "
                "or a unimodal_<modality>[_mlp|_gbdt] spec"
            )
        overrides["model_type"] = model
    return overrides


def prepare_dev() -> dict:
    """Load each UCI dev dataset and print its shape and clinical count, or
    why it is unavailable. -> name -> (rows, columns) or None."""
    from pd_fusion_torch.data.dev_datasets.uci_parkinsons import load_uci_parkinsons
    from pd_fusion_torch.data.dev_datasets.uci_telemonitoring import load_uci_telemonitoring

    shapes = {}
    for name, loader in (("uci_parkinsons", load_uci_parkinsons),
                         ("uci_telemonitoring", load_uci_telemonitoring)):
        try:
            df, masks = loader()
        except (OSError, ValueError, KeyError) as e:
            print(f"{name}: UNAVAILABLE ({e})")
            shapes[name] = None
            continue
        print(f"{name}: OK shape={df.shape} clinical={masks['clinical'].sum()}/{len(df)}")
        shapes[name] = df.shape
    return shapes


def main(argv=None):
    parser = argparse.ArgumentParser(description="PPMI Multimodal Fusion CLI (PyTorch/CUDA port)")
    subparsers = parser.add_subparsers(dest="command")

    validate_parser = subparsers.add_parser("validate-data")
    validate_parser.add_argument("--config", type=str, required=True, help="Data config (sources)")
    validate_parser.add_argument(
        "--columns", type=str, default="configs/ppmi_columns.yaml", help="Column mapping config"
    )

    subparsers.add_parser("prepare-dev")

    train_parser = subparsers.add_parser("train")
    train_parser.add_argument("--config", type=str, required=True)
    train_parser.add_argument("--data-config", type=str, default="configs/data_ppmi.yaml")
    train_parser.add_argument("--synthetic", action="store_true")

    eval_parser = subparsers.add_parser("evaluate")
    eval_parser.add_argument("--config", type=str, required=True)
    eval_parser.add_argument("--run-dir", type=str, required=True)

    full_parser = subparsers.add_parser("run")
    full_parser.add_argument("--config", type=str, required=True)
    full_parser.add_argument("--synthetic", action="store_true")
    full_parser.add_argument("--model", type=str, help="Override model type")
    full_parser.add_argument("--seed", type=int, help="Override random seed")
    full_parser.add_argument("--output-dir", type=str, help="Override output directory name")
    full_parser.add_argument("--k-fold", type=int, help="Run K-Fold CV (e.g. 5)")
    full_parser.add_argument(
        "--dataset", type=str, help="Override dataset name (e.g. openneuro_ds001907)"
    )

    download_parser = subparsers.add_parser("download-dev")
    download_parser.add_argument("--dataset", type=str, default="all")
    download_parser.add_argument("--out", type=str, default="data/raw_dev")
    download_parser.add_argument("--openneuro-metadata-only", action="store_true")

    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return None
    with distributed.process_group(kernels=True, host=True):
        return _run(args, argv)


def _run(args, argv):
    setup_logging()
    if not distributed.is_primary():
        import logging

        logging.getLogger("pd_fusion").setLevel(logging.ERROR)
    os.environ["PD_FUSION_COMMAND"] = "python -m pd_fusion_torch.cli " + " ".join(
        sys.argv[1:] if argv is None else argv
    )

    if args.command == "validate-data":
        from pd_fusion_torch.data.ppmi_loader import process_and_merge_data

        return process_and_merge_data(load_yaml(Path(args.config)), load_yaml(Path(args.columns)))
    if args.command == "prepare-dev":
        return prepare_dev()
    if args.command == "download-dev":
        from pd_fusion_torch.data.download.download_manager import download_dev

        return download_dev(args.out, args.dataset, args.openneuro_metadata_only)
    if args.command == "train":
        # the single-split pipeline, as the JAX CLI's train subcommand
        from pd_fusion_torch.experiments.run_experiment import run_full_pipeline

        return run_full_pipeline(args.config, args.synthetic, overrides={})
    if args.command == "evaluate":
        from pd_fusion_torch.experiments.run_experiment import evaluate_run

        return evaluate_run(args.config, args.run_dir)

    overrides = {}
    if args.model:
        overrides.update(_build_model_overrides(args))
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.output_dir:
        overrides["output_dir"] = args.output_dir
    if args.dataset:
        overrides["dataset"] = args.dataset

    config_k = None
    if args.k_fold is None:
        try:
            conf = load_yaml(Path(args.config))
            config_k = conf.get("cv_folds") or conf.get("k_folds")
        except Exception:
            config_k = None

    if args.k_fold is not None or config_k is not None:
        from pd_fusion_torch.experiments.run_experiment import run_cv_pipeline

        k = args.k_fold if args.k_fold is not None else int(config_k)
        return run_cv_pipeline(args.config, k=k, synthetic=args.synthetic, overrides=overrides)
    from pd_fusion_torch.experiments.run_experiment import run_full_pipeline

    return run_full_pipeline(args.config, args.synthetic, overrides=overrides)


if __name__ == "__main__":
    main()
