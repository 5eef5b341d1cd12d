"""Binary-classification metrics as tensor reductions (port of
``pd_fusion/ops/metrics.py``).

roc_auc, pr_auc (average precision), balanced_accuracy, f1 (threshold
0.5), brier and ECE (10 equal-width bins; bin membership is
``lower < p <= upper`` and bin "accuracy" is the fraction of samples where
``y == (p >= 0.5)``). Every metric takes an optional per-sample weight
vector; weight-0 entries are exact no-ops, which lets unequal-size CV
folds share one padded array. Tie handling is exact: ROC-AUC uses midrank
statistics over tie groups; average precision evaluates precision at
tie-group boundaries.

Parity with the JAX package, term for term:
- sorts are ``stable=True`` (``jnp.argsort`` is stable), so tie order and
  the reversed-stable order of ``risk_coverage`` match;
- ECE compares against the f64 ``np.linspace`` lower boundaries rounded
  DOWN to f32 (``_lower_bin_bounds_f32``);
- degenerate inputs give NaN (0/0), never a guarded 1e-38;
- ECE's bin sums are ``scatter_add``, which on a CUDA device adds in no
  fixed order: its result may differ from the CPU's in the last bits
  (well inside the 1e-6 the tests hold it to).

Every metric reduces over the last axis: ``y_prob`` [..., N] gives one
value per leading index (``analysis/bootstrap_ci.py`` computes all its
resamples' metrics so, [n_boot, N] in one call).
"""
from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch

Tensor = torch.Tensor


def _ones_like_weights(p: Tensor, w: Optional[Tensor]) -> Tensor:
    if w is None:
        return torch.ones_like(p)
    return w.to(p.dtype)


@lru_cache(maxsize=None)
def _lower_bin_bounds_f32(n_bins: int) -> np.ndarray:
    """The n_bins LOWER bin boundaries of the f64 np.linspace(0, 1,
    n_bins+1), each rounded DOWN to the nearest f32. For an f32
    probability p and f64 boundary b, (p > b) is then exactly
    (p > bound_f32) — no f32 value lies strictly between bound_f32 and b."""
    b64 = np.linspace(0.0, 1.0, n_bins + 1)[:-1]
    b32 = b64.astype(np.float32)
    too_high = b32.astype(np.float64) > b64
    b32 = np.where(too_high, np.nextafter(b32, np.float32(-np.inf)), b32)
    b32 = b32.astype(np.float32)
    b32.setflags(write=False)  # shared by every caller through the cache
    return b32


def _tie_group_bounds(s_sorted: Tensor):
    """For each position in an array sorted along its last axis, indices of
    the first and last element of its tie group. O(n) via cummax / reversed
    cummin."""
    n = s_sorted.shape[-1]
    idx = torch.arange(n, device=s_sorted.device).expand_as(s_sorted)
    diff = s_sorted[..., 1:] != s_sorted[..., :-1]
    one = torch.ones(s_sorted.shape[:-1] + (1,), dtype=torch.bool, device=s_sorted.device)
    is_start = torch.cat([one, diff], -1)
    is_end = torch.cat([diff, one], -1)
    group_start = torch.cummax(torch.where(is_start, idx, 0), -1).values
    group_end = torch.cummin(torch.where(is_end, idx, n - 1).flip(-1), -1).values.flip(-1)
    return group_start, group_end


def roc_auc(y_true: Tensor, y_prob: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """Tie-aware (midrank) weighted ROC-AUC: for each positive, the
    negative weight strictly below its tie group plus half the negative
    weight inside it. Works over the last axis: ``y_prob`` [..., N] (each
    row sorted on its own) against ``y_true`` and ``weights`` that
    broadcast to it -> [...]."""
    w = _ones_like_weights(y_prob, weights)
    y = y_true.to(y_prob.dtype)
    order = torch.argsort(y_prob, dim=-1, stable=True)
    s = torch.gather(y_prob, -1, order)
    yw = torch.gather((y * w).expand_as(y_prob), -1, order)
    nw = torch.gather(((1.0 - y) * w).expand_as(y_prob), -1, order)

    group_start, group_end = _tie_group_bounds(s)
    cum_neg = torch.cumsum(nw, -1)
    neg_below = torch.where(
        group_start > 0, torch.gather(cum_neg, -1, torch.clamp(group_start - 1, min=0)), 0.0
    )
    neg_in_group = torch.gather(cum_neg, -1, group_end) - neg_below
    contrib = yw * (neg_below + 0.5 * neg_in_group)
    return torch.sum(contrib, -1) / (torch.sum(yw, -1) * torch.sum(nw, -1))


def average_precision(y_true: Tensor, y_prob: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """Weighted average precision (sklearn ``average_precision_score``),
    over the last axis."""
    w = _ones_like_weights(y_prob, weights)
    y = y_true.to(y_prob.dtype)
    order = torch.argsort(-y_prob, dim=-1, stable=True)
    s = torch.gather(y_prob, -1, order)
    yw = torch.gather((y * w).expand_as(y_prob), -1, order)
    nw = torch.gather(((1.0 - y) * w).expand_as(y_prob), -1, order)

    _, group_end = _tie_group_bounds(s)
    tps = torch.cumsum(yw, -1)
    fps = torch.cumsum(nw, -1)
    tp_end = torch.gather(tps, -1, group_end)
    denom = tp_end + torch.gather(fps, -1, group_end)
    safe = torch.where(denom > 0, denom, 1.0)
    precision_at_end = torch.where(denom > 0, tp_end / safe, 0.0)
    return torch.sum(yw * precision_at_end, -1) / torch.sum(yw, -1)


def brier_score(y_true: Tensor, y_prob: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    w = _ones_like_weights(y_prob, weights)
    sq = (y_prob - y_true.to(y_prob.dtype)) ** 2
    return torch.sum(sq * w, -1) / torch.sum(w, -1)


def _confusion(y_true, y_prob, weights, threshold):
    w = _ones_like_weights(y_prob, weights)
    y = y_true.to(y_prob.dtype)
    pred = (y_prob >= threshold).to(y_prob.dtype)
    tp = torch.sum(w * y * pred, -1)
    fn = torch.sum(w * y * (1.0 - pred), -1)
    tn = torch.sum(w * (1.0 - y) * (1.0 - pred), -1)
    fp = torch.sum(w * (1.0 - y) * pred, -1)
    return tp, fn, tn, fp


def balanced_accuracy(
    y_true: Tensor, y_prob: Tensor, weights: Optional[Tensor] = None, threshold: float = 0.5
) -> Tensor:
    """Mean recall over the classes PRESENT in y_true (sklearn); NaN when
    no weight is present at all."""
    tp, fn, tn, fp = _confusion(y_true, y_prob, weights, threshold)
    has_pos = (tp + fn) > 0
    has_neg = (tn + fp) > 0
    tpr = torch.where(has_pos, tp / torch.where(has_pos, tp + fn, 1.0), 0.0)
    tnr = torch.where(has_neg, tn / torch.where(has_neg, tn + fp, 1.0), 0.0)
    n_present = has_pos.to(y_prob.dtype) + has_neg.to(y_prob.dtype)
    return torch.where(
        n_present > 0, (tpr + tnr) / torch.clamp(n_present, min=1.0), float("nan")
    )


def f1_score(
    y_true: Tensor, y_prob: Tensor, weights: Optional[Tensor] = None, threshold: float = 0.5
) -> Tensor:
    """sklearn zero_division semantics: no positives anywhere -> 0.0."""
    tp, fn, _, fp = _confusion(y_true, y_prob, weights, threshold)
    denom = 2.0 * tp + fp + fn
    return torch.where(denom > 0, 2.0 * tp / torch.where(denom > 0, denom, 1.0), 0.0)


def expected_calibration_error(
    y_true: Tensor,
    y_prob: Tensor,
    weights: Optional[Tensor] = None,
    n_bins: int = 10,
) -> Tensor:
    """ECE: 10 equal-width bins with membership ``lower < p <= upper``
    (p == 0 falls in no bin) against the f64 linspace boundaries, bin
    accuracy = fraction where ``y == (p >= 0.5)``, divided by the FULL
    weight."""
    w = _ones_like_weights(y_prob, weights).expand_as(y_prob)
    y = y_true.to(y_prob.dtype)
    bounds = torch.tensor(_lower_bin_bounds_f32(n_bins), device=y_prob.device)
    idx = torch.sum(y_prob[..., None] > bounds, dim=-1) - 1
    valid = (y_prob > 0.0) & (y_prob <= 1.0)
    idx = torch.clamp(idx, 0, n_bins - 1)
    wv = torch.where(valid, w, 0.0)

    acc = (y == (y_prob >= 0.5).to(y_prob.dtype)).to(y_prob.dtype)
    zeros = torch.zeros(y_prob.shape[:-1] + (n_bins,), dtype=y_prob.dtype, device=y_prob.device)
    bin_w = zeros.scatter_add(-1, idx, wv)
    bin_acc = zeros.scatter_add(-1, idx, wv * acc)
    bin_conf = zeros.scatter_add(-1, idx, wv * y_prob)

    total_w = torch.sum(w, -1, keepdim=True)
    nonzero = bin_w > 0
    safe_w = torch.where(nonzero, bin_w, 1.0)
    per_bin = torch.where(
        nonzero, (bin_w / total_w) * torch.abs(bin_acc / safe_w - bin_conf / safe_w), 0.0
    )
    return torch.sum(per_bin, -1)


# canonical metric order for packed single-transfer layouts (must match
# the binary_metrics dict below)
METRIC_NAMES = ("roc_auc", "pr_auc", "balanced_accuracy", "f1", "brier_score", "ece")


def binary_metrics(
    y_true: Tensor,
    y_prob: Tensor,
    weights: Optional[Tensor] = None,
    threshold: float = 0.5,
) -> Dict[str, Tensor]:
    """All six metrics over the last axis, as tensors of the leading shape
    (0-d for one vector) on the inputs' device."""
    return {
        "roc_auc": roc_auc(y_true, y_prob, weights),
        "pr_auc": average_precision(y_true, y_prob, weights),
        "balanced_accuracy": balanced_accuracy(y_true, y_prob, weights, threshold),
        "f1": f1_score(y_true, y_prob, weights, threshold),
        "brier_score": brier_score(y_true, y_prob, weights),
        "ece": expected_calibration_error(y_true, y_prob, weights),
    }


def pack_metrics_and_probs(md: Dict[str, Tensor], probs: Tensor) -> Tensor:
    """Flatten a {metric: [...]} dict (METRIC_NAMES order) plus the probs
    tensor into ONE 1-D f32 buffer (one device->host copy); same layout as
    the JAX package's."""
    return torch.cat(
        [torch.stack([md[k] for k in METRIC_NAMES]).reshape(-1).to(torch.float32),
         probs.reshape(-1).to(torch.float32)]
    )


def binary_metrics_packed(probs: Tensor, y_true: Tensor, weights: Tensor) -> Tensor:
    """All six metrics of every row of probs [..., N] (e.g. [S, N] scenarios
    or [K, S, N] folds x scenarios), packed with the probs into one buffer:
    one ``binary_metrics`` per row, then one device -> host copy."""
    lead, n = probs.shape[:-1], probs.shape[-1]
    per = [binary_metrics(y, p, w) for y, p, w in
           zip(y_true.reshape(-1, n), probs.reshape(-1, n), weights.reshape(-1, n))]
    md = {k: torch.stack([m[k] for m in per]).reshape(lead) for k in METRIC_NAMES}
    return pack_metrics_and_probs(md, probs)


def unpack_metrics_and_probs(packed, metric_shape, probs_shape):
    """Host-side inverse of pack_metrics_and_probs (packed is a numpy
    array after the single fetch)."""
    n_per = int(np.prod(metric_shape))
    md = {
        k: packed[i * n_per:(i + 1) * n_per].reshape(metric_shape)
        for i, k in enumerate(METRIC_NAMES)
    }
    return md, packed[len(METRIC_NAMES) * n_per:].reshape(probs_shape)


def risk_coverage(y_true: Tensor, y_prob: Tensor) -> Tensor:
    """Risk-coverage curve as ONE packed [2, n] tensor (row 0 coverage,
    row 1 risk): sort by confidence max(p, 1-p) descending; risk at
    coverage k/n is the error rate among the k most confident
    predictions. Ties come in REVERSE input order (stable ascending sort,
    then reversed), as ``np.argsort(confidence)[::-1]`` orders them."""
    n = y_true.shape[0]
    confidence = torch.maximum(y_prob, 1.0 - y_prob)
    order = torch.argsort(confidence, stable=True).flip(0)
    preds = (y_prob >= 0.5).to(torch.int32)
    correct = (preds == y_true.to(torch.int32)).to(y_prob.dtype)[order]
    ks = torch.arange(1, n + 1, dtype=y_prob.dtype, device=y_prob.device)
    coverage = ks / n
    accuracy = torch.cumsum(correct, 0) / ks
    return torch.stack([coverage, 1.0 - accuracy])
