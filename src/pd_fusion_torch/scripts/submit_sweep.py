"""Model x seed sweep (port of ``scripts/submit_sweep.py``, same flags):

    python -m pd_fusion_torch.scripts.submit_sweep [--dry-run] [--local [--fused]]
        [--partition gpu] [--base-config C] [--synthetic] [--dataset D]
        [--k-fold K] [--models m1,m2]

The grid is the reference's: 7 model families x seeds 42, 43, 44, under
``runs/sweep_<timestamp>/``. Three modes:

- by default one SLURM script per (model, seed) under ``scripts/``, each
  running ``python -m pd_fusion_torch.cli run``, submitted with
  ``sbatch`` (``--dry-run`` writes them and submits nothing). The port
  runs on a CUDA device, so the default partition is ``gpu`` and every
  job asks for one card (``#SBATCH --gres=gpu:1``);
- ``--local``: the same grid as sequential in-process runs
  (``run_cv_pipeline`` with ``--k-fold``, else ``run_full_pipeline``);
- ``--local --fused --k-fold K``: one ``parallel/seed_sweep.py::
  run_multi_seed_cv`` per model, every seed's K folds in one stacked CV;
  families the CV engine cannot stack are skipped with a note.

Config paths resolve from the working directory, then from the repo root.
"""
import argparse
import datetime
import subprocess
from pathlib import Path
from types import SimpleNamespace

SEEDS = [42, 43, 44]
MODELS = [
    "unimodal_clinical",
    "unimodal_datspect",
    "unimodal_mri",
    "fusion_late",
    "fusion_masked",
    "fusion_moddrop",
    "moe",
]

SLURM_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={job_name}
#SBATCH --output={log_dir}/{job_name}.out
#SBATCH --error={log_dir}/{job_name}.err
#SBATCH --partition={partition}
#SBATCH --gres=gpu:1
#SBATCH --time=04:00:00
#SBATCH --mem=32G
#SBATCH --cpus-per-task=4

source ~/.bashrc

echo "Starting job {job_name} (model={model}, seed={seed})"
export PYTHONPATH=$PYTHONPATH:$(pwd)/src

{command}

echo "Job finished"
"""


def build_command(args, model, seed, output_dir):
    parts = ["python -m pd_fusion_torch.cli run", f"--config {args.base_config}"]
    if args.synthetic:
        parts.append("--synthetic")
    if args.dataset:
        parts.append(f"--dataset {args.dataset}")
    if args.k_fold:
        parts.append(f"--k-fold {args.k_fold}")
    parts += [f"--model {model}", f"--seed {seed}", f"--output-dir {output_dir}"]
    return " \\\n    ".join(parts)


def _model_overrides(model, base_config):
    from pd_fusion_torch.cli import _build_model_overrides

    return _build_model_overrides(SimpleNamespace(model=model, config=base_config))


def run_fused(args, models, sweep_dir: Path):
    """One stacked multi-seed CV per model."""
    from pd_fusion_torch.cli import _resolve_path
    from pd_fusion_torch.parallel.cv_engine import supports_parallel_cv
    from pd_fusion_torch.parallel.seed_sweep import run_multi_seed_cv
    from pd_fusion_torch.utils.io import load_yaml

    for model in models:
        config = load_yaml(_resolve_path(args.base_config))
        config.update(_model_overrides(model, args.base_config))
        if args.dataset:
            config["dataset"] = args.dataset
        if not supports_parallel_cv(config):
            print(f"[fused] {model}: not parallel-CV-capable; skipping "
                  "(rerun without --fused for the sequential path)")
            continue
        data_config = load_yaml(_resolve_path(config.get("data_config", "configs/data_ppmi.yaml")))
        eval_config = load_yaml(
            _resolve_path(config.get("eval_config", "configs/eval_missingness.yaml")))
        print(f"[fused] {model}: {len(SEEDS)} seeds x {args.k_fold} folds in one program")
        run_multi_seed_cv(
            config, data_config, eval_config, seeds=SEEDS, k=args.k_fold,
            synthetic=args.synthetic, sweep_dir=sweep_dir / model,
        )
    print(f"Fused local sweep complete. Results in {sweep_dir}")


def run_local(args, models, timestamp: str, sweep_dir: Path):
    """The grid as sequential in-process runs."""
    from pd_fusion_torch.experiments.run_experiment import run_cv_pipeline, run_full_pipeline

    for model in models:
        for seed in SEEDS:
            job_name = f"{model}_s{seed}"
            print(f"[local] {job_name}")
            overrides = _model_overrides(model, args.base_config)
            overrides["seed"] = seed
            overrides["output_dir"] = f"sweep_{timestamp}/{job_name}"
            if args.dataset:
                overrides["dataset"] = args.dataset
            if args.k_fold:
                run_cv_pipeline(args.base_config, k=args.k_fold,
                                synthetic=args.synthetic, overrides=overrides)
            else:
                run_full_pipeline(args.base_config, args.synthetic, overrides=overrides)
    print(f"Local sweep complete. Results in {sweep_dir}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Submit model/seed sweep (SLURM or local)")
    parser.add_argument("--dry-run", action="store_true", help="Generate scripts but do not submit")
    parser.add_argument("--local", action="store_true", help="Run the grid sequentially in-process")
    parser.add_argument(
        "--fused", action="store_true",
        help="With --local: train every seed's CV folds in ONE stacked device "
             "program per model (parallel-CV families only)",
    )
    parser.add_argument("--partition", type=str, default="gpu", help="SLURM partition")
    parser.add_argument("--base-config", type=str, default="configs/dev_benchmark_suite.yaml")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--dataset", type=str, default="")
    parser.add_argument("--k-fold", type=int, default=None)
    parser.add_argument("--models", type=str, default="", help="Comma-separated model subset")
    args = parser.parse_args(argv)

    timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    sweep_dir = Path("runs") / f"sweep_{timestamp}"
    logs_dir = sweep_dir / "logs"
    scripts_dir = sweep_dir / "scripts"
    for d in (sweep_dir, logs_dir, scripts_dir):
        d.mkdir(parents=True, exist_ok=True)
    print(f"Generating sweep in {sweep_dir}")

    models = [m for m in args.models.split(",") if m] or MODELS

    if args.local:
        from pd_fusion_torch.utils.logging import setup_logging

        setup_logging()
        if args.fused and args.k_fold:
            run_fused(args, models, sweep_dir)
        else:
            run_local(args, models, timestamp, sweep_dir)
        return sweep_dir

    for model in models:
        for seed in SEEDS:
            job_name = f"{model}_s{seed}"
            command = build_command(args, model, seed, f"sweep_{timestamp}/{job_name}")
            script_path = scripts_dir / f"{job_name}.sh"
            script_path.write_text(
                SLURM_TEMPLATE.format(
                    job_name=job_name, log_dir=logs_dir.absolute(),
                    partition=args.partition, model=model, seed=seed, command=command,
                )
            )
            if args.dry_run:
                print(f"[DRY RUN] Generated {script_path}")
            else:
                print(f"Submitting {job_name}...")
                subprocess.run(["sbatch", str(script_path)])

    print("\nPro-tip: Monitor jobs with 'squeue -u $USER'")
    print(f"Results will be in {sweep_dir}")
    return sweep_dir


if __name__ == "__main__":
    main()
