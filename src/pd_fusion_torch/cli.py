"""CLI of the port (port of ``pd_fusion/cli.py``).

``python -m pd_fusion_torch.cli run --config … [--k-fold K] [--seed S]
[--output-dir D]`` with the JAX package's flags and semantics: ``--k-fold``
or a ``cv_folds``/``k_folds`` key in the config selects the CV pipeline,
else the single-split pipeline runs. As in the JAX package, the config
key is read from ``Path(--config)`` as given, with no repo-root fallback:
a relative path from another directory skips CV, so pass an absolute
path. The invocation string is exported as PD_FUSION_COMMAND for
provenance. The other subcommands of the JAX CLI raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
import argparse
import os
import sys
from pathlib import Path

from pd_fusion_torch.utils.io import load_yaml
from pd_fusion_torch.utils.logging import setup_logging

# subcommands of the JAX CLI that the port does not run yet
_NOT_PORTED = {
    "validate-data": "ROADMAP Queue 1 item 14 (PPMI suites)",
    "train": "ROADMAP Queue 1 item 5 (single-split main path)",
    "evaluate": "ROADMAP Queue 1 item 5 (single-split main path)",
    "download-dev": "ROADMAP Queue 1 item 14",
    "prepare-dev": "ROADMAP Queue 1 item 14",
}
_PORTED_MODELS = ("mil_attention",)


def main(argv=None):
    parser = argparse.ArgumentParser(description="PPMI Multimodal Fusion CLI (PyTorch/CUDA port)")
    subparsers = parser.add_subparsers(dest="command")

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
    for name in _NOT_PORTED:
        subparsers.add_parser(name, add_help=False)

    args, extra = parser.parse_known_args(argv)
    if args.command in _NOT_PORTED:
        raise NotImplementedError(
            f"'{args.command}' is not ported to pd_fusion_torch yet ({_NOT_PORTED[args.command]})"
        )
    if args.command is None:
        parser.print_help()
        return None
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    setup_logging()
    os.environ["PD_FUSION_COMMAND"] = "python -m pd_fusion_torch.cli " + " ".join(
        sys.argv[1:] if argv is None else argv
    )

    overrides = {}
    if args.model:
        if args.model not in _PORTED_MODELS:
            raise NotImplementedError(
                f"--model '{args.model}' is not ported to pd_fusion_torch yet; ported: "
                f"{', '.join(_PORTED_MODELS)} (ROADMAP Queue 1)"
            )
        overrides["model_type"] = args.model
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
