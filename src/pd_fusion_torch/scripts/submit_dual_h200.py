"""Two-job sweep submitter (a copy of ``scripts/submit_dual_h200.py``, same
flags; its jobs run the port's CLI):

    python -m pd_fusion_torch.scripts.submit_dual_h200 --dataset D [--dry-run]
        [--partition P] [--gres gpu:1] [--models m1,m2] [--k-fold K] ...

Takes the model x seed grid (7 families x seeds 42/43/44 by default),
splits it into two halves, and writes one sbatch script per half under
``runs/dual_sweep_<ts>/scripts/``, each running its chunk sequentially
through ``python -m pd_fusion_torch.cli run``. Supports a module/conda
bootstrap, a PD_FUSION_DEV_DATA_DIR export, and ``--dry-run`` (write the
scripts, skip sbatch). Each job asks for one card (``--gres``).
"""
import argparse
import datetime
import os
import subprocess
from pathlib import Path

MODELS = [
    "unimodal_clinical",
    "unimodal_datspect",
    "unimodal_mri",
    "fusion_late",
    "fusion_masked",
    "fusion_moddrop",
    "moe",
]
SEEDS = (42, 43, 44)
N_JOBS = 2


def run_command(args, model: int, seed: int, out_dir: str) -> str:
    """One `pd_fusion_torch.cli run` invocation, line-continued for readability."""
    flags = [f"--config {args.base_config}"]
    if args.synthetic:
        flags.append("--synthetic")
    if args.dataset:
        flags.append(f"--dataset {args.dataset}")
    if args.k_fold:
        flags.append(f"--k-fold {args.k_fold}")
    flags += [f"--model {model}", f"--seed {seed}", f"--output-dir {out_dir}"]
    return " \\\n    ".join(["python -m pd_fusion_torch.cli run", *flags])


def env_prelude(args) -> list:
    """module/conda/PYTHONPATH bootstrap lines for the job body."""
    lines = ["set -e"]
    if args.module:
        lines.append(f"module load {args.module}")
    lines.append("source ~/.bashrc")

    conda_base = args.conda_base
    if not conda_base and os.environ.get("CONDA_EXE"):
        try:
            conda_base = str(Path(os.environ["CONDA_EXE"]).resolve().parent.parent)
        except Exception:
            conda_base = ""
    if not conda_base:
        conda_base = os.environ.get("CONDA_PREFIX", "")

    if conda_base:
        lines.append(f'source "{conda_base}/etc/profile.d/conda.sh"')
    else:
        lines.append("if command -v conda >/dev/null 2>&1; then :; else echo 'conda not found'; fi")
    if args.conda_env and args.conda_env.lower() not in ("none", ""):
        lines.append(f"conda activate {args.conda_env} || source activate {args.conda_env}")

    lines.append("export PYTHONPATH=$PYTHONPATH:$(pwd)/src")
    if args.dev_data_dir:
        lines.append(f"export PD_FUSION_DEV_DATA_DIR={args.dev_data_dir}")
    return lines


def render_job(args, job_name: str, log_dir: Path, commands: list) -> str:
    directives = {
        "job-name": job_name,
        "output": f"{log_dir.absolute()}/{job_name}.out",
        "error": f"{log_dir.absolute()}/{job_name}.err",
        "partition": args.partition,
        "gres": args.gres,
        "time": args.time,
        "mem": args.mem,
        "cpus-per-task": args.cpus,
    }
    header = ["#!/bin/bash"] + [f"#SBATCH --{k}={v}" for k, v in directives.items()]
    body = env_prelude(args) + ["", f'echo "Starting job {job_name}"', ""]
    for cmd in commands:
        body += [cmd, ""]
    body.append('echo "Job finished"')
    return "\n".join(header + [""] + body) + "\n"


def main(argv=None):
    cli = argparse.ArgumentParser(description="Submit two jobs with sequential model runs")
    cli.add_argument("--partition", default="mit_normal_gpu")
    cli.add_argument("--time", default="05:00:00")
    cli.add_argument("--mem", default="64G")
    cli.add_argument("--cpus", type=int, default=8)
    cli.add_argument("--gres", default="gpu:1")
    cli.add_argument("--conda-env", default="base")
    cli.add_argument("--conda-base", default="")
    cli.add_argument("--module", default="")
    cli.add_argument("--base-config", default="configs/dev_benchmark_suite.yaml")
    cli.add_argument("--dataset", required=True)
    cli.add_argument("--models", default="")
    cli.add_argument("--synthetic", action="store_true")
    cli.add_argument("--k-fold", type=int, default=None)
    cli.add_argument("--dev-data-dir", default="")
    cli.add_argument("--dry-run", action="store_true")
    args = cli.parse_args(argv)

    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    sweep_root = Path("runs") / f"dual_sweep_{stamp}"
    log_dir = sweep_root / "logs"
    script_dir = sweep_root / "scripts"
    for d in (log_dir, script_dir):
        d.mkdir(parents=True, exist_ok=True)

    families = [m for m in (s.strip() for s in args.models.split(",")) if m] or MODELS
    grid = [(m, s) for m in families for s in SEEDS]
    half = (len(grid) + 1) // 2

    for job_idx in range(N_JOBS):
        chunk = grid[job_idx * half : (job_idx + 1) * half]
        job_name = f"dual_node_{job_idx + 1}"
        commands = [
            run_command(args, model, seed, f"dual_sweep_{stamp}/{model}_s{seed}")
            for model, seed in chunk
        ]
        path = script_dir / f"{job_name}.sh"
        path.write_text(render_job(args, job_name, log_dir, commands))
        if args.dry_run:
            print(f"[DRY RUN] Generated {path}")
        else:
            print(f"Submitting {job_name}...")
            subprocess.run(["sbatch", str(path)], check=False)

    print(f"Results will be in {sweep_root}")
    return sweep_root


if __name__ == "__main__":
    main()
