"""Lightweight tracing / profiling (port of ``pd_fusion/utils/profiling.py``).

- ``phase_timer(name)``: context manager logging a phase's wall-clock and
  adding it to a process-local registry (``get_phase_times``,
  ``reset_phase_times``);
- ``maybe_profile(name)``: when ``PD_FUSION_PROFILE=<dir>`` is set, the
  block runs under ``torch.profiler`` (host and, where there is one, CUDA
  activity) and a Chrome trace is written under ``<dir>/<name>/``, the
  directory the JAX package's ``jax.profiler.trace`` writes to; unset, it
  does nothing;
- ``throughput(n, seconds)``: items a second.
"""
import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict

PROFILE_ENV = "PD_FUSION_PROFILE"

_phase_times: Dict[str, float] = defaultdict(float)
logger = logging.getLogger("pd_fusion")


@contextlib.contextmanager
def phase_timer(name: str, log: bool = True):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _phase_times[name] += dt
        if log:
            logger.info(f"[timing] {name}: {dt:.3f}s")


def get_phase_times() -> Dict[str, float]:
    return dict(_phase_times)


def reset_phase_times():
    _phase_times.clear()


@contextlib.contextmanager
def maybe_profile(name: str = "trace"):
    """``torch.profiler`` trace of the block when ``PD_FUSION_PROFILE`` is set:
    ``<dir>/<name>/trace_<pid>_<n>.json`` (Chrome trace format)."""
    trace_dir = os.environ.get(PROFILE_ENV)
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = os.path.join(trace_dir, name)
    os.makedirs(out, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    n = len([f for f in os.listdir(out) if f.startswith(f"trace_{os.getpid()}_")])
    path = os.path.join(out, f"trace_{os.getpid()}_{n}.json")
    prof.export_chrome_trace(path)
    logger.info(f"[profile] {name}: {path}")


def throughput(n_items: int, seconds: float) -> float:
    return n_items / seconds if seconds > 0 else float("inf")
