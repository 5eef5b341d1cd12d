#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. It loads and warms up the program (``pd_fusion_torch``), measures for
``--seconds`` seconds, checks what the timed path produced against the
plain reference (``benchmark/reference``), and prints one JSON object as
the last line of standard output; the numbers compared, each beside its
limit, are the last lines of standard error. With ``--trace 1`` the window
runs under ``torch.profiler`` and the cell's per-layer metrics are
reported in place of its end-to-end ones. Without a CUDA card, or with
fewer than the cell needs, it prints no result and exits with 2.
"""
import os
import sys
import time


def _process_start() -> float:
    """The process's start on the wall clock (``setup_s`` counts from it)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T0 = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "bench_cache")
# every kernel and build cache at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
# one process with a fixed few threads on fixed cores, so that the host's
# share of a run (the program's draws, copies and launches) varies less
THREADS = 4
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = str(THREADS)
if hasattr(os, "sched_setaffinity"):
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:THREADS])

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(THREADS)
    from benchmark.harness import runner, spec

    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    print(f"power limit: {power_limit()}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
