"""One run of one cell: set-up, the measured window, the per-layer
metrics of a traced run, then the check against the reference.

Order matters: the device's memory peak is read when the window closes,
then the program's state is freed, and only then does the reference run
(its own peak never counts).
"""
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from benchmark.harness import compare, guard, spec, trace

PEAKS = json.loads((Path(__file__).resolve().parent.parent / "peaks.json").read_text())


class ForbiddenModules(RuntimeError):
    pass


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device, chips: int) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device="cuda",
        t0: Optional[float] = None,
        log: Callable = lambda s: print(s, file=sys.stderr)) -> Dict:
    """-> the result line's object. ``t0``: the process's start on the wall
    clock (``setup_s`` runs from it)."""
    t0 = time.time() if t0 is None else t0
    device = torch.device(device)
    drive = cell.drive(cell, seed, device)
    t_drive = time.time()
    drive.setup()
    _sync(device)
    setup_s = time.time() - t0
    log("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                              {"start": t_drive - t0, **drive.phases}.items()))

    prof = None
    with contextlib.ExitStack() as stack:
        if traced:
            stack.enter_context(trace.spans())
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = stack.enter_context(torch.profiler.profile(activities=acts))
            stack.enter_context(torch.autograd.profiler.record_function(trace.WINDOW))
        calls = 0
        start = time.perf_counter()
        while True:
            drive.call()
            calls += 1
            if time.perf_counter() - start >= seconds:
                break
        _sync(device)
        elapsed = time.perf_counter() - start
    dev = device_info(device, cell.chips)
    found = guard.forbidden_loaded()
    if found:
        raise ForbiddenModules(f"modules of JAX or of the JAX package were loaded: {found}")

    metrics, breakdown = {}, None
    if not traced:
        values = {"setup_s": setup_s, drive.rate: calls * drive.work_per_call / elapsed}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        red = trace.reduce(prof)
        dev.update(busy_s=red["busy_s"], window_s=red["window_s"])
        breakdown = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
        ctx = {"cell": cell, "drive": drive, "device": device, "window_s": red["window_s"],
               "busy_s": red["busy_s"], "calls": calls, "flops": calls * drive.flops_per_call,
               "peak": PEAKS.get(dev["kind"])}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        log(f"trace: {red['kernels']} device operations in a window of {red['window_s']} s")

    attempted, failed = drive.attempted(calls), drive.failed()
    drive.release()
    numbers = drive.check()
    ok, checks = compare.judge(numbers, cell.limits)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}", file=sys.stderr)
    out = {"correct": bool(ok and failed == 0), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
