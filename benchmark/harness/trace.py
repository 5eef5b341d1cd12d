"""The traced window: ``torch.profiler`` over the window, spans at the
program's layer boundaries, and the reduction of the trace to the device's
busy time, its longest operations and its idle gaps.

Spans are the benchmark's own: in a traced run, the program's functions at
each layer boundary are wrapped in ``record_function`` ranges named
``<layer>:<function>`` (``SPANS``), and restored afterwards. A function
that a later version of the program no longer has is skipped. The raw
events are read from ``kineto_results`` (no ``FunctionEvent`` tree is
built, which would take minutes for a window of some hundred thousand
launches).
"""
import bisect
import contextlib
import importlib
from typing import Dict, List, Tuple

import torch

WINDOW = "bench:window"
# (module, attribute or Class.method, layer)
SPANS = (
    ("pd_fusion_torch.models.mil_attention_finetune", "MilAttentionFineTuneModel._pad_batch",
     "trainer"),
    ("pd_fusion_torch.models.mil_attention_finetune", "MilAttentionFineTuneModel._aug_params",
     "trainer"),
    ("pd_fusion_torch.models.mil_attention_finetune", "MilAttentionFineTuneModel._t", "trainer"),
    ("pd_fusion_torch.models.mil_attention_finetune", "MilAttentionFineTuneModel._predict_chunk",
     "trainer"),
    ("pd_fusion_torch.models.mil_attention_finetune", "ft_step", "step"),
    ("pd_fusion_torch.models.mil_attention_finetune", "ft_grads", "step"),
    ("pd_fusion_torch.models.mil_attention_finetune", "augment", "image ops"),
    ("pd_fusion_torch.models.mil_attention_finetune", "slices_to_imagenet_batch", "image ops"),
    ("pd_fusion_torch.models.mil_attention_finetune", "resnet_apply_train", "backbone"),
    ("pd_fusion_torch.models.mil_attention_finetune", "resnet_apply", "backbone"),
    ("pd_fusion_torch.models.mil_attention_finetune", "mil_apply", "head"),
    ("pd_fusion_torch.nn.ft_optim", "ft_update", "optimizer"),
)
LAYERS = {layer for _, _, layer in SPANS} | {"bench"}
# the ranges' own copies on the device's timeline, which are not device work
RANGES = {WINDOW} | {f"{layer}:{attr.split('.')[-1]}" for _, attr, layer in SPANS}


def _wrap(fn, name):
    def wrapped(*args, **kwargs):
        with torch.autograd.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def spans():
    """Wrap every function of ``SPANS`` that exists in a named range."""
    undo = []
    for mod_name, attr, layer in SPANS:
        owner = importlib.import_module(mod_name)
        *path, leaf = attr.split(".")
        for p in path:
            owner = getattr(owner, p, None)
        fn = getattr(owner, leaf, None) if owner is not None else None
        if fn is None:
            continue
        setattr(owner, leaf, _wrap(fn, f"{layer}:{leaf}"))
        undo.append((owner, leaf, fn))
    try:
        yield
    finally:
        for owner, leaf, fn in reversed(undo):
            setattr(owner, leaf, fn)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(prof, top: int = 10) -> Dict:
    """The window's numbers from a finished profiler: ``window_s`` (the
    ``bench:window`` range), ``busy_s`` (the union of the device's
    kernels, copies and sets inside it), ``device_ops`` (the operations
    with the most device time, summed by name) and ``idle_gaps`` (the
    longest stretches with nothing on the device, each named by the
    innermost span and host operation around its middle)."""
    events = prof.profiler.kineto_results.events()
    cpu, dev, win = [], [], None
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.name() not in RANGES:
                dev.append((s, s + d, e.name()))
        else:
            name = e.name()
            if name == WINDOW:
                win = (s, s + d)
            cpu.append((s, s + d, name))
    if win is None:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = win
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in inside])
    by_name: Dict[str, int] = {}
    for s, e, n in inside:
        by_name[n] = by_name.get(n, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    gaps, prev = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    gaps = sorted(gaps, reverse=True)[:top]
    cpu.sort()
    starts = [c[0] for c in cpu]
    named = []
    for length, a, b in gaps:
        named.append([_host_at(cpu, starts, (a + b) // 2), length / 1e9])
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "kernels": len(inside),
        "device_ops": [[n[:160], ns / 1e9] for n, ns in ops],
        "idle_gaps": named,
    }


def _host_at(cpu, starts, t, reach: int = 20000) -> str:
    """``<innermost span> / <innermost host event>`` covering time ``t``."""
    i = bisect.bisect_right(starts, t)
    span, op, span_start, op_start = None, None, -1, -1
    for s, e, n in reversed(cpu[max(0, i - reach):i]):
        if e < t:
            continue
        if ":" in n and n.split(":", 1)[0] in LAYERS and s > span_start:
            span, span_start = n, s
        elif ":" not in n.split("::")[-1] and s > op_start and n != WINDOW:
            op, op_start = n, s
    return f"{span or 'bench'} / {op or 'none'}"

