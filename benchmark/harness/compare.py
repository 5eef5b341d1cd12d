"""The numbers that decide ``correct``, each a gap between the program and
the reference, and the check against each number's limit."""
import math
import statistics
from typing import Dict, Iterable, Optional, Tuple

import torch


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def worst_leaf(program: Dict[str, float], reference: Dict[str, float],
               keys: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """The largest ``|program norm - reference norm|`` of a leaf, over the
    larger of that leaf's reference norm and the median leaf's. A leaf
    missing or not finite on the program's side reads infinity."""
    keys = list(reference if keys is None else keys)
    med = statistics.median(reference[k] for k in keys)
    worst, name = 0.0, ""
    for k in keys:
        p = program.get(k, math.nan)
        gap = abs(p - reference[k]) / max(reference[k], med) if math.isfinite(p) else math.inf
        if gap > worst or not math.isfinite(gap):
            worst, name = gap, k
            if not math.isfinite(gap):
                break
    return worst, name


def relative(program: float, reference: float) -> float:
    if not math.isfinite(program):
        return math.inf
    return abs(program - reference) / max(abs(reference), 1e-30)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """-> (every number that has a limit within it, ``{name: {"value",
    "limit"}}``). A limit without a number fails."""
    out = {}
    ok = True
    for k in limits:
        v = numbers.get(k, math.inf)
        ok = ok and math.isfinite(v) and v <= limits[k]
        out[k] = {"value": v, "limit": limits[k]}
    return ok, out
