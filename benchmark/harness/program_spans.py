"""The program's own spans and counters (``pd_fusion_torch.utils.profiling``),
read after a traced run's window.

A benchmark process runs the profiler over that window alone, and the
program records its spans and counters only while a profiler runs, so the
registry holds the window's work. Each reader returns ``None`` in a cell of
another rate, and where the program has no such registry, span or counter.
"""
from typing import Dict, Optional


def _snapshot() -> Optional[Dict]:
    from pd_fusion_torch.utils import profiling

    snapshot = getattr(profiling, "snapshot", None)
    return snapshot() if snapshot is not None else None


def span_share(ctx, rate: str, name: str) -> Optional[float]:
    """Span ``name``'s seconds over the traced window, in percent."""
    snap = _snapshot() if ctx["drive"].rate == rate else None
    s = snap["spans"].get(name) if snap else None
    return None if s is None else 100.0 * s["seconds"] / ctx["window_s"]


def counter_ratio(ctx, rate: str, name: str, per: str, scale: float = 1.0) -> Optional[float]:
    """Counter ``name`` over counter ``per``, times ``scale``."""
    snap = _snapshot() if ctx["drive"].rate == rate else None
    n, d = (snap["counters"].get(name), snap["counters"].get(per)) if snap else (None, None)
    return None if n is None or not d else scale * n / d
