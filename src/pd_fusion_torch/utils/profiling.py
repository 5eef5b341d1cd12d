"""Lightweight tracing / profiling (port of ``pd_fusion/utils/profiling.py``).

One process-wide registry of spans and counters:

- ``span(name, trace=True)``: context manager; while tracing is on it times
  the block (``time.perf_counter_ns``) and adds to the span's ``count``,
  ``seconds``, ``self_seconds`` (its time minus its child spans') and
  ``parent`` (the span around its first call; a thread-local stack). With
  ``trace`` it also opens a ``record_function`` range of the same name, so
  the span is in the profiler's trace too. It never synchronises the
  device; while tracing is off it costs one check;
- ``count(name, n=1)``: adds to a named counter while tracing is on;
- tracing is on while a ``torch.profiler`` profile runs, or inside a
  ``tracing()`` block;
- ``snapshot()`` -> ``{"spans": {...}, "counters": {...}}``; ``reset()``
  clears both;
- ``phase_timer(name)``: a span without a range that is timed whether
  tracing is on or not, and logged; ``get_phase_times`` and
  ``reset_phase_times`` read and clear the phases alone;
- ``maybe_profile(name)``: when ``PD_FUSION_PROFILE=<dir>`` is set, the
  block runs under ``torch.profiler`` (host and, where there is one, CUDA
  activity); a Chrome trace ``trace_<pid>_<n>.json`` is written under
  ``<dir>/<name>/``, the directory the JAX package's ``jax.profiler.trace``
  writes to, with ``spans_<pid>_<n>.json`` beside it: the spans and
  counters the block recorded. Unset, it does nothing.

The fine-tune's host loop (``models/mil_attention_finetune.py``) records
the spans ``trainer:_aug_params`` (the augmentation draws, on the
preparation thread: numpy's small draws and the noise, drawn on the
device), ``trainer:_t`` (every host-to-device copy), ``step:ft_step`` (the
host's enqueue of a step), ``trainer:_predict_chunk`` (of a predict pass),
``trainer:readback`` (the read-back of a pass, no range) and
``trainer:prep_wait`` (the wait for the next prepared step or pass, no
range), and the counters ``trainer:h2d_bytes``, ``trainer:steps``,
``trainer:passes`` and ``trainer:prep_ready`` (steps and passes that were
prepared when asked for); ``ops/normal_draw.py`` counts
``trainer:noise_on_card`` (noise draws made by kernel K3) and
``trainer:noise_raw`` (the generator's outputs those draws consumed, about
1.022 a value). The backbones record, with no range: Swin's and MaxViT's
block attention ``backbone:window_attention`` (counter
``backbone:windows``), MaxViT's grid attention ``backbone:grid_attention``
(counter ``backbone:grid_windows``) and MBConvs ``backbone:mbconv``
(counter ``backbone:recomputed``, the MBConvs run again in a backward);
the fused BN counts ``backbone:bn_kernel`` / ``backbone:bn_plain``. The
embed build (``imaging/pipeline.py``) records, with no range,
``embed:prep_wait`` (its consume loop blocked on the prefetch threads'
host preparation) and ``embed:staging`` (the copies into pinned memory and
the issue of each flush's copy to the card). Spans
of two threads overlap in time, so their
shares of a window can sum past 1. ``torch.profiler`` sees the ranges of
the thread that started it alone: the preparation thread's spans are in
the registry and not in the trace. A span with a range that encloses
device work is named as the benchmark's own range around the same function
(``<layer>:<function>``), which the benchmark's trace reduction leaves out
of the device's busy time; any other span that encloses device work takes
``trace=False``.
"""
import contextlib
import json
import logging
import os
import threading
import time
from typing import Dict

import torch.autograd.profiler as _autograd_profiler

PROFILE_ENV = "PD_FUSION_PROFILE"

logger = logging.getLogger("pd_fusion")

_spans: Dict[str, Dict] = {}
_counters: Dict[str, int] = {}
_phases = set()
_lock = threading.Lock()
_stack = threading.local()
_forced = 0  # open tracing() blocks


def tracing_on() -> bool:
    return _forced > 0 or _autograd_profiler._is_profiler_enabled


class _Span:
    def __init__(self, name: str, trace: bool):
        self.name, self.range = name, None
        if trace and _autograd_profiler._is_profiler_enabled:
            self.range = _autograd_profiler.record_function(name)

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        frames = getattr(_stack, "frames", None)
        if frames is None:
            frames = _stack.frames = []
        self.parent = frames[-1] if frames else None
        self.children_ns = 0
        frames.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        self.seconds = dt / 1e9
        _stack.frames.pop()
        if self.parent is not None:
            self.parent.children_ns += dt
        with _lock:
            s = _spans.get(self.name)
            if s is None:
                s = _spans[self.name] = {"count": 0, "seconds": 0.0, "self_seconds": 0.0,
                                         "parent": self.parent and self.parent.name}
            s["count"] += 1
            s["seconds"] += self.seconds
            s["self_seconds"] += (dt - self.children_ns) / 1e9
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, *, trace: bool = True):
    """Time the block as span ``name`` while tracing is on (see the module)."""
    return _Span(name, trace) if tracing_on() else _OFF


def count(name: str, n: int = 1) -> None:
    if tracing_on():
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def tracing():
    """Record spans and counters inside the block, with no profiler."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def snapshot() -> Dict:
    with _lock:
        return {"spans": {k: dict(v) for k, v in _spans.items()}, "counters": dict(_counters)}


def reset() -> None:
    with _lock:
        _spans.clear()
        _counters.clear()
        _phases.clear()


@contextlib.contextmanager
def phase_timer(name: str, log: bool = True):
    with _lock:
        _phases.add(name)
    s = _Span(name, trace=False)
    try:
        with s:
            yield
    finally:
        if log:
            logger.info(f"[timing] {name}: {s.seconds:.3f}s")


def get_phase_times() -> Dict[str, float]:
    with _lock:
        return {k: _spans[k]["seconds"] for k in _phases if k in _spans}


def reset_phase_times():
    with _lock:
        for k in _phases:
            _spans.pop(k, None)
        _phases.clear()


def _since(before: Dict, after: Dict) -> Dict:
    """What ``after`` recorded beyond ``before`` (two snapshots)."""
    spans = {}
    for k, s in after["spans"].items():
        b = before["spans"].get(k)
        if b is None:
            spans[k] = s
        elif s["count"] > b["count"]:
            spans[k] = dict(s, count=s["count"] - b["count"],
                            seconds=s["seconds"] - b["seconds"],
                            self_seconds=s["self_seconds"] - b["self_seconds"])
    counters = {k: v - before["counters"].get(k, 0) for k, v in after["counters"].items()
                if v != before["counters"].get(k, 0)}
    return {"spans": spans, "counters": counters}


@contextlib.contextmanager
def maybe_profile(name: str = "trace"):
    """``torch.profiler`` trace of the block when ``PD_FUSION_PROFILE`` is set:
    ``<dir>/<name>/trace_<pid>_<n>.json`` (Chrome trace format) and the
    block's spans and counters in ``spans_<pid>_<n>.json``."""
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
    before = snapshot()
    with profile(activities=activities) as prof:
        yield
    n = len([f for f in os.listdir(out) if f.startswith(f"trace_{os.getpid()}_")])
    path = os.path.join(out, f"trace_{os.getpid()}_{n}.json")
    prof.export_chrome_trace(path)
    with open(os.path.join(out, f"spans_{os.getpid()}_{n}.json"), "w") as f:
        json.dump(_since(before, snapshot()), f, indent=1, sort_keys=True)
    logger.info(f"[profile] {name}: {path}")
