#!/usr/bin/env python3
"""The readings that a cell's limits are set from: the program against the
reference on many seeds (the lower readings), and, on a few seeds, the
control (the reference in TF32, put in the program's place) and the
faults (half of each batch left out, in the reference put in the
program's place) against the same reference (the upper readings).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--out <file>.jsonl]

Each cell's drive takes its readings (``calibrate(control)`` in
``drives/<drive>.py``): a training cell makes one call after its set-up
and reads both calls that a run checks; a predict cell makes as many
calls after its set-up as a run compares, at the cell's own load, and
checks them. One JSON line a reading. The benchmark's own runs never run
this.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import time  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import spec

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in seeds:
        t = time.perf_counter()
        drive = cell.drive(cell, seed, "cuda")
        drive.setup()
        for side, nums in drive.calibrate(seed in controls).items():
            emit({"cell": cell.name, "seed": seed, "side": side,
                  **{k: (v if not isinstance(v, float) or math.isfinite(v) else str(v))
                     for k, v in nums.items()},
                  **({"phases": drive.phases} if side.startswith("program") else {})})
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
        del drive
    return 0


if __name__ == "__main__":
    sys.exit(main())
