"""Histogram gradient-boosted trees, binary logistic loss (port of
``pd_fusion/nn/gbdt.py``).

LightGBM-style quantile-binned histogram boosting:

- **Host/device split**: quantile bin-edge fitting and feature binning are
  numpy (done once, bit-identical to the JAX package's); every boosting
  round (gradients, per-node histograms, split search, routing, leaf
  values, margin update) is torch ops on the port's device, one Python
  loop over rounds and levels.
- **Static shapes**: trees grow depth-wise to a fixed ``depth``. A node
  with no beneficial split emits a pass-through split (threshold =
  MISSING_BIN, everything routed left), which equals stopping early.
- **Missing values**: NaN/inf get a reserved bin; the split search tries
  "missing goes left" and "missing goes right" for every threshold.
- **Folds as a batch dimension**: every device function takes one model
  (``bins`` [N, F]) or a fold-batched stack (``bins`` [K, N, F], ``y``
  and ``w`` [K, N], one base score per fold); the CV engine trains all
  folds together. Zero-weight rows are exact no-ops.

Histograms have two lowerings of the same sums (``hist_mode``):
``scatter`` (``index_add_``: the least arithmetic) and ``onehot`` (one
float32 matmul per fold and level over one-hot bin codes made once per
fit, TF32 off, which is what the JAX package's ``Precision.HIGHEST``
means). On the card ``index_add_`` adds with float atomics, whose order
changes from run to run; exact gain ties are structural here, so that
drift can fork an ensemble. ``onehot`` reduces in the matmul's fixed
order, and its node totals and leaf sums are per-fold matmuls too; ``auto``
picks it on CUDA (two fits give bit-identical trees, and a fold-batched
fit equals its folds' single fits) and ``scatter`` on the CPU, where
``index_add_`` adds in index order.

Data parallelism (``data_group``, the data axis of the CV engine's
``("fold", "data")`` mesh): each rank holds its rows of every fold, the
per-level histograms, node totals and leaf sums are summed over the group
(one all-reduce each), and every rank chooses the splits from the same
reduced sums. Routing and the margins stay on the rank's own rows.

Gain/leaf formulas are the standard second-order ones: gain = 1/2
[GL^2/(HL+lam) + GR^2/(HR+lam) - G^2/(H+lam)], leaf value
-lr * G/(H+lam), boosting from the base log-odds of the weighted label
mean.
"""
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from pd_fusion_torch.parallel.distributed import all_reduce
from pd_fusion_torch.utils.device import get_device

N_BINS = 256  # total codes per feature
MISSING_BIN = N_BINS - 1  # reserved code for NaN/inf
N_VALUE_BINS = N_BINS - 1  # ordered (splittable) value bins: 0..254
TREE_KEYS = ("feat", "thr", "miss_left", "gain", "leaf", "leaf_cover")


# --------------------------------------------------------------------------
# Host-side binning (fit once, numpy)
# --------------------------------------------------------------------------

def fit_bin_edges(X: np.ndarray, max_value_bins: int = N_VALUE_BINS) -> List[np.ndarray]:
    """Per-feature ascending quantile edges (<= max_value_bins-1 of them).

    Bin convention: bin i holds values in (edges[i-1], edges[i]], bin 0 is
    (-inf, edges[0]]; a split "bin <= t" therefore means value <= edges[t].
    Non-finite values are not binned here (they get MISSING_BIN).
    """
    X = np.asarray(X, np.float32)
    edges = []
    qs = np.linspace(0.0, 1.0, max_value_bins)[1:-1]
    for j in range(X.shape[1]):
        col = X[:, j]
        finite = col[np.isfinite(col)]
        if finite.size == 0:
            edges.append(np.zeros(0, np.float32))
            continue
        edges.append(np.unique(np.quantile(finite, qs).astype(np.float32)))
    return edges


def bin_features(X: np.ndarray, edges: List[np.ndarray]) -> np.ndarray:
    """Map raw features to int32 bin codes using fitted edges."""
    X = np.asarray(X, np.float32)
    out = np.empty(X.shape, np.int32)
    for j, e in enumerate(edges):
        col = X[:, j]
        finite = np.isfinite(col)
        # first index i with edges[i] >= v  ->  v in (edges[i-1], edges[i]]
        codes = np.searchsorted(e, col, side="left").astype(np.int32)
        out[:, j] = np.where(finite, codes, MISSING_BIN)
    return out


def compute_base_score(y: np.ndarray, w: Optional[np.ndarray] = None) -> float:
    """Weighted-prevalence log-odds (LightGBM boost_from_average). The ONE
    canonical expression: the CV engine and DeviceHistGBDT.fit must give
    bit-identical base scores, or ulp-level drift can flip near-tie split
    argmaxes between the two paths."""
    y = np.asarray(y, np.float32)
    w = np.ones_like(y) if w is None else np.asarray(w, np.float32)
    wsum = float(w.sum())
    p = float((y * w).sum() / wsum) if wsum > 0 else 0.5
    p = min(max(p, 1e-7), 1.0 - 1e-7)
    return float(np.log(p / (1.0 - p)))


# --------------------------------------------------------------------------
# Backend resolution
# --------------------------------------------------------------------------

def resolve_gbdt_backend(setting: Optional[str]) -> str:
    """Resolve a GBDT backend setting to 'device' or 'host'.

    ``auto`` (the default) picks the device trainer when the port's device
    is CUDA and the host backend (scikit-learn's HistGradientBoosting) on
    the CPU, as the JAX package picks its device trainer on its
    accelerator. Explicit 'device'/'host' settings and the
    PD_FUSION_GBDT_BACKEND env var (highest precedence) force either side.
    """
    env = os.environ.get("PD_FUSION_GBDT_BACKEND", "")
    if env in ("device", "host"):
        return env
    if setting == "device":
        return "device"
    if setting in ("host", "histgb", "lightgbm", "xgboost"):
        return "host"
    if setting not in (None, "", "auto"):
        raise ValueError(
            f"unknown GBDT backend {setting!r} (use 'device', 'host', or 'auto')"
        )
    return "device" if get_device().type == "cuda" else "host"


def resolve_hist_mode(mode: Optional[str], device=None) -> str:
    """Resolve a hist_mode setting ('scatter' | 'onehot' | 'auto'/None) to
    a concrete lowering: 'auto' is onehot on CUDA (deterministic sums) and
    scatter elsewhere."""
    if mode in ("scatter", "onehot"):
        return mode
    if mode not in (None, "", "auto"):
        raise ValueError(f"unknown hist_mode {mode!r} (use 'scatter', 'onehot', or 'auto')")
    return "onehot" if get_device(device).type == "cuda" else "scatter"


# --------------------------------------------------------------------------
# Device-side training (every function fold-batched: leading K axis)
# --------------------------------------------------------------------------

def _split_gain(GL, HL, CL, G, H, C, lam, min_child_weight, min_child_samples):
    """Second-order split gain with validity masking; invalid -> -inf."""
    GR = G - GL
    HR = H - HL
    CR = C - CL
    # safe denominators: masked-out entries may hit 0/0
    dl = torch.where(HL + lam > 0, HL + lam, 1.0)
    dr = torch.where(HR + lam > 0, HR + lam, 1.0)
    dp = torch.where(H + lam > 0, H + lam, 1.0)
    gain = 0.5 * (GL * GL / dl + GR * GR / dr - G * G / dp)
    valid = (
        (HL >= min_child_weight)
        & (HR >= min_child_weight)
        & (CL >= min_child_samples)
        & (CR >= min_child_samples)
    )
    return torch.where(valid, gain, float("-inf"))


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return torch.nn.functional.one_hot(idx, n).to(dtype)


def bin_onehots(bins: torch.Tensor, dtype) -> List[torch.Tensor]:
    """The onehot lowering's left factor, per fold: the one-hot bin codes
    as [F*B, N]. The codes never change during a fit, so a fit makes
    these once (K*F*B*N elements)."""
    K, n, f = bins.shape
    return [_one_hot(bins[k].T, N_BINS, dtype).transpose(1, 2).reshape(f * N_BINS, n)
            for k in range(K)]


def _node_sums(data: torch.Tensor, node: torch.Tensor, n_nodes: int, hist_mode: str,
               data_group=None):
    """Per-node sums of data [K, N, C] -> [K, n_nodes, C]. ``onehot`` makes
    one matmul per fold, the product a single fit of that fold makes, so a
    fold-batched fit equals K single fits on the card too. Under
    ``data_group`` the rank's sums are summed over the group."""
    K, _, C = data.shape
    if hist_mode == "onehot":
        out = torch.stack([_one_hot(node[k], n_nodes, data.dtype).T @ data[k]
                           for k in range(K)])
    else:
        flat = (node + torch.arange(K, device=node.device)[:, None] * n_nodes).reshape(-1)
        out = torch.zeros((K * n_nodes, C), dtype=data.dtype, device=data.device)
        out = out.index_add_(0, flat, data.reshape(-1, C)).reshape(K, n_nodes, C)
    return out if data_group is None else all_reduce(out, data_group)


def _histograms(bins, data, node, n_nodes, hist_mode, onehots=None, data_group=None):
    """Per-(node, feature, bin) sums of data=[g,h,w] -> [K, L, F, B, 3],
    plus per-node totals [K, L, 3]. ``bins``: int64 [K, N, F];
    ``onehots``: ``bin_onehots(bins)`` for the onehot lowering (made here
    when not given). Under ``data_group`` both are summed over the group."""
    K, n, f = bins.shape
    dt = data.dtype
    if hist_mode == "onehot":
        if onehots is None:
            onehots = bin_onehots(bins, dt)
        # one [F*B, N] @ [N, L*3] matmul per fold
        nw = (_one_hot(node, n_nodes, dt)[..., None] * data[:, :, None, :]).reshape(
            K, n, n_nodes * 3)
        hist = torch.stack([onehots[k] @ nw[k] for k in range(K)])  # [K, F*B, L*3]
        hist = hist.reshape(K, f, N_BINS, n_nodes, 3).permute(0, 3, 1, 2, 4)
    elif hist_mode == "scatter":
        fold = torch.arange(K, device=bins.device)[:, None, None]
        f_range = torch.arange(f, device=bins.device)[None, None, :]
        flat_ids = ((fold * n_nodes + node[:, :, None]) * f + f_range) * N_BINS + bins
        data_b = data[:, :, None, :].expand(K, n, f, 3).reshape(-1, 3)
        hist = torch.zeros((K * n_nodes * f * N_BINS, 3), dtype=dt, device=data.device)
        hist = hist.index_add_(0, flat_ids.reshape(-1), data_b).reshape(
            K, n_nodes, f, N_BINS, 3)
    else:
        raise ValueError(f"unknown hist_mode {hist_mode!r} (use 'scatter' or 'onehot')")
    if data_group is not None:
        hist = all_reduce(hist.contiguous(), data_group)
    return hist, _node_sums(data, node, n_nodes, hist_mode, data_group)


def _route(bins, node, f_of_n, t_of_n, ml_of_n):
    """One level of routing: the child index of every sample."""
    b = bins.gather(-1, f_of_n.unsqueeze(-1)).squeeze(-1)
    go_left = torch.where(b == MISSING_BIN, ml_of_n, b <= t_of_n)
    return node * 2 + (1 - go_left.long())


def _build_tree(bins, g, h, w, depth, lr, lam, min_child_weight, min_child_samples, hist_mode,
                onehots=None, data_group=None):
    """Grow one depth-wise tree per fold; returns (tree arrays, per-sample
    value [K, N])."""
    K, n, f = bins.shape
    l_max = 1 << (depth - 1)
    node = torch.zeros((K, n), dtype=torch.long, device=bins.device)
    data = torch.stack([g, h, w], dim=-1)  # [K, N, 3]

    feats, thrs, mls, gains_rec = [], [], [], []
    for level in range(depth):
        n_nodes = 1 << level
        hist, tot = _histograms(bins, data, node, n_nodes, hist_mode, onehots, data_group)
        miss = hist[:, :, :, MISSING_BIN, :]  # [K, L, F, 3]
        cum = torch.cumsum(hist[:, :, :, :N_VALUE_BINS, :], dim=3)  # [K, L, F, T, 3]

        G = tot[:, :, None, None, 0]
        H = tot[:, :, None, None, 1]
        C = tot[:, :, None, None, 2]
        gains = []
        for go_miss_left in (True, False):
            left = cum + miss[:, :, :, None, :] if go_miss_left else cum
            gains.append(_split_gain(left[..., 0], left[..., 1], left[..., 2],
                                     G, H, C, lam, min_child_weight, min_child_samples))
        flat = torch.stack(gains, dim=-1).reshape(K, n_nodes, -1)  # [K, L, F*T*2]
        # argmax ties go to the first index, as jnp.argmax
        best = torch.argmax(flat, dim=-1)
        best_gain = flat.gather(-1, best[..., None])[..., 0]
        f_best = best // (N_VALUE_BINS * 2)
        rest = best % (N_VALUE_BINS * 2)
        t_best = rest // 2
        ml_best = (rest % 2) == 0  # even index == missing-left arm
        # no beneficial split -> pass-through: everything (incl. missing)
        # routed left via threshold MISSING_BIN + missing-left
        no_split = ~(best_gain > 0.0)
        f_best = torch.where(no_split, 0, f_best)
        t_best = torch.where(no_split, MISSING_BIN, t_best)
        ml_best = torch.where(no_split, True, ml_best)

        pad = (0, l_max - n_nodes)
        feats.append(torch.nn.functional.pad(f_best, pad))
        thrs.append(torch.nn.functional.pad(t_best, pad))
        mls.append(torch.nn.functional.pad(ml_best, pad))
        gains_rec.append(torch.nn.functional.pad(torch.where(no_split, 0.0, best_gain), pad))

        node = _route(bins, node, f_best.gather(1, node), t_best.gather(1, node),
                      ml_best.gather(1, node))

    # one 3-column sum: cols 0, 1 are the leaf-value stats, col 2 the leaf
    # cover for TreeSHAP
    leaf_stats3 = _node_sums(data, node, 1 << depth, hist_mode, data_group)
    denom = leaf_stats3[..., 1] + lam
    leaf_vals = torch.where(
        denom > 0, -lr * leaf_stats3[..., 0] / torch.where(denom > 0, denom, 1.0), 0.0)
    tree = {
        "feat": torch.stack(feats, 1).int(),  # [K, D, Lmax]
        "thr": torch.stack(thrs, 1).int(),  # [K, D, Lmax]
        "miss_left": torch.stack(mls, 1),  # [K, D, Lmax] bool
        "gain": torch.stack(gains_rec, 1),  # [K, D, Lmax] split gains (0 = pass-through)
        "leaf": leaf_vals,  # [K, 2^D]
        # leaf sample-weight totals: TreeSHAP derives every internal node's
        # cover from its descendant leaves (ops/treeshap.py)
        "leaf_cover": leaf_stats3[..., 2],  # [K, 2^D]
    }
    return tree, leaf_vals.gather(1, node)


def _fold_batched(bins, *arrays):
    """-> (single, bins int64 [K, N, F], arrays with a leading fold axis)."""
    single = bins.dim() == 2
    if single:
        bins = bins[None]
        arrays = tuple(None if a is None else a[None] for a in arrays)
    return single, bins.long(), arrays


def train_gbdt(
    bins: torch.Tensor,  # [N, F] or [K, N, F] int codes from bin_features
    y: torch.Tensor,  # [N] or [K, N] in {0, 1}
    w: torch.Tensor,  # [N] or [K, N] sample weights (0 = padding)
    base_score,  # float, or [K] initial margins (log-odds)
    *,
    n_rounds: int,
    depth: int,
    lr: float,
    lam: float,
    min_child_weight: float,
    min_child_samples: float,
    hist_mode: str = "scatter",
    n_rows: Optional[List[int]] = None,
    data_group=None,
) -> Dict[str, torch.Tensor]:
    """Train the ensemble(s). The margin's dtype is ``y``'s (float32 in
    production; the tests run float64, where cross-implementation ulp
    drift cannot flip near-tie argmaxes). Returns per key [R, ...], or
    [K, R, ...] for a fold-batched stack.

    ``n_rows`` (a stack's real row counts, padding after them) takes each
    fold's probabilities from a sigmoid over its own rows alone, 2K more
    launches a round: the CPU's vectorised sigmoid rounds an element by its
    place in the tensor, so only then does each fold's ensemble there equal
    its unpadded single fit. CUDA's sigmoid does not depend on the place,
    so ``fit_gbdt_stack`` passes it on the CPU only.

    ``data_group``: the rows are this rank's share of each fold; the sums
    that choose the splits and the leaf values are the group's."""
    single, bins, (y, w) = _fold_batched(bins, y, w)
    K, n, _ = bins.shape
    base = torch.as_tensor(base_score, dtype=y.dtype, device=y.device).reshape(-1)
    margin = base[:, None].expand(K, n).clone()
    rounds = []
    with torch.no_grad():
        onehots = bin_onehots(bins, y.dtype) if hist_mode == "onehot" else None
        for _ in range(n_rounds):
            p = torch.sigmoid(margin)
            for k, n_k in enumerate(n_rows or ()):
                p[k, :n_k] = torch.sigmoid(margin[k, :n_k])
            g = (p - y) * w
            h = p * (1.0 - p) * w
            tree, delta = _build_tree(bins, g, h, w, depth, lr, lam, min_child_weight,
                                      min_child_samples, hist_mode, onehots, data_group)
            margin = margin + delta
            rounds.append(tree)
    trees = {k: torch.stack([t[k] for t in rounds], 1) for k in TREE_KEYS}
    return {k: v[0] for k, v in trees.items()} if single else trees


def predict_margin(trees: Dict[str, torch.Tensor], bins: torch.Tensor, base_score, *,
                   depth: int) -> torch.Tensor:
    """Sum of tree outputs + base margin for binned samples: trees [R, ...]
    with bins [N, F], or a fold-batched ensemble [K, R, ...] with bins
    [K, N, F]. The trees' outputs are added one round after another, in
    the trainer's order."""
    single, bins, _ = _fold_batched(bins)
    if single:
        trees = {k: v[None] for k, v in trees.items()}
    K, n, _ = bins.shape
    R = trees["leaf"].shape[1]
    with torch.no_grad():
        node = torch.zeros((K, R, n), dtype=torch.long, device=bins.device)
        bins_r = bins[:, None].expand(K, R, n, bins.shape[2])
        for level in range(depth):
            at = lambda key: trees[key][:, :, level].gather(2, node)  # noqa: E731
            node = _route(bins_r, node, at("feat").long(), at("thr").long(), at("miss_left"))
        vals = trees["leaf"].gather(2, node)  # [K, R, N]
        base = torch.as_tensor(base_score, dtype=vals.dtype, device=vals.device).reshape(-1)
        margin = base[:, None].expand(K, n)
        for r in range(R):
            margin = margin + vals[:, r]
    return margin[0] if single else margin


# --------------------------------------------------------------------------
# scikit-learn-style wrapper (the device backend of UnimodalGBDT)
# --------------------------------------------------------------------------

class NotFittedError(ValueError, AttributeError):
    """scikit-learn's NotFittedError (a ValueError and an AttributeError, so
    ``hasattr`` probes see False); the card's machine has no scikit-learn."""


class DeviceHistGBDT:
    """scikit-learn-like binary classifier over train_gbdt/predict_margin.

    Accepts lgbm-style params (n_estimators, learning_rate, max_depth,
    reg_lambda, min_child_samples, min_child_weight); num_leaves maps to
    the nearest depth when max_depth is unset. Stores numpy state only, so
    a pickle holds no device buffer; the device is the port's at fit and
    predict time.
    """

    def __init__(
        self,
        n_estimators: int = 100,
        learning_rate: float = 0.1,
        max_depth: Optional[int] = None,
        num_leaves: Optional[int] = None,
        reg_lambda: float = 0.0,
        min_child_samples: int = 20,
        min_child_weight: float = 1e-3,
        random_state: Optional[int] = None,  # deterministic: accepted, unused
        hist_mode: Optional[str] = None,
        class_weight: Optional[str] = None,  # None or "balanced" (lgbm semantics)
    ):
        if max_depth is None or max_depth <= 0:
            leaves = num_leaves or 31
            max_depth = max(1, int(np.ceil(np.log2(max(2, leaves)))))
        if max_depth > 10:
            logging.getLogger("pd_fusion").warning(
                "DeviceHistGBDT: max_depth %d clamped to 10 (2^depth leaf arrays are "
                "static-shape; the host backend honors larger depths)", max_depth,
            )
        self.n_estimators = int(n_estimators)
        self.learning_rate = float(learning_rate)
        self.max_depth = int(min(max_depth, 10))
        self.reg_lambda = float(reg_lambda)
        self.min_child_samples = float(min_child_samples)
        self.min_child_weight = float(min_child_weight)
        # 'auto' resolves at fit time (onehot on CUDA, scatter elsewhere)
        self.hist_mode = hist_mode or os.environ.get("PD_FUSION_GBDT_HIST", "auto")
        if self.hist_mode not in ("scatter", "onehot", "auto"):
            raise ValueError(
                f"unknown hist_mode {self.hist_mode!r} (use 'scatter', 'onehot', or 'auto')"
            )
        if class_weight not in (None, "balanced"):
            raise ValueError(f"unsupported class_weight {class_weight!r}")
        self.class_weight = class_weight
        self.edges_: Optional[List[np.ndarray]] = None
        self.trees_: Optional[Dict[str, np.ndarray]] = None
        self.base_score_: float = 0.0
        self._trees_dev = None  # device-resident cache; never pickled

    def hparams(self) -> dict:
        """train_gbdt's keyword arguments."""
        return dict(n_rounds=self.n_estimators, depth=self.max_depth, lr=self.learning_rate,
                    lam=self.reg_lambda, min_child_weight=self.min_child_weight,
                    min_child_samples=self.min_child_samples,
                    hist_mode=resolve_hist_mode(self.hist_mode))

    def _fit_inputs(self, X, y, sample_weight=None):
        """(edges, bins, y, weights, base score) of a fit on (X, y)."""
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32).reshape(-1)
        w = (np.ones_like(y) if sample_weight is None
             else np.asarray(sample_weight, np.float32).reshape(-1))
        if self.class_weight == "balanced" and sample_weight is None:
            # sklearn/lgbm formula: n_samples / (n_classes * bincount(y))
            counts = np.bincount(y.astype(np.int64), minlength=2).astype(np.float64)
            cw = len(y) / (2.0 * np.maximum(counts, 1.0))
            w = cw[y.astype(np.int64)].astype(np.float32)
        edges = fit_bin_edges(X)
        return edges, bin_features(X, edges), y, w, compute_base_score(y, w)

    def fit(self, X, y, sample_weight=None):
        self.edges_, bins, y, w, self.base_score_ = self._fit_inputs(X, y, sample_weight)
        dev = get_device()
        trees = train_gbdt(torch.as_tensor(bins, device=dev), torch.as_tensor(y, device=dev),
                           torch.as_tensor(w, device=dev), np.float32(self.base_score_),
                           **self.hparams())
        self.trees_ = {k: v.cpu().numpy() for k, v in trees.items()}
        self._trees_dev = trees  # keep the device copies for predicts
        return self

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_trees_dev"] = None  # device buffers are not pickled state
        return state

    def _device_trees(self):
        if self.trees_ is None:
            raise NotFittedError("DeviceHistGBDT is not fitted")
        if self._trees_dev is None:
            dev = get_device()
            self._trees_dev = {k: torch.as_tensor(v, device=dev) for k, v in self.trees_.items()}
        return self._trees_dev

    def _margin(self, X) -> np.ndarray:
        trees = self._device_trees()
        bins = bin_features(np.asarray(X, np.float32), self.edges_)
        dev = trees["leaf"].device
        return predict_margin(trees, torch.as_tensor(bins, device=dev),
                              np.float32(self.base_score_), depth=self.max_depth).cpu().numpy()

    @property
    def feature_importances_(self) -> np.ndarray:
        """Gain-based importances, normalized to sum 1 (total split gain per
        feature across the ensemble). Raises AttributeError subclasses when
        unavailable, so ``hasattr`` probes see False."""
        if self.trees_ is None:
            raise NotFittedError("DeviceHistGBDT is not fitted")
        if "gain" not in self.trees_:
            raise AttributeError(
                "this DeviceHistGBDT artifact predates gain recording; "
                "retrain to get feature_importances_"
            )
        feat = self.trees_["feat"].ravel()
        thr = self.trees_["thr"].ravel()
        gain = self.trees_["gain"].ravel().astype(np.float64)
        real = thr != MISSING_BIN  # pass-through/padded nodes carry no split
        imp = np.bincount(feat[real], weights=gain[real], minlength=len(self.edges_))
        tot = imp.sum()
        return (imp / tot if tot > 0 else imp).astype(np.float64)

    def predict_proba(self, X) -> np.ndarray:
        p1 = 1.0 / (1.0 + np.exp(-self._margin(X)))
        return np.stack([1.0 - p1, p1], axis=1)

    def predict(self, X) -> np.ndarray:
        return (self._margin(X) > 0).astype(np.int64)

    def shap_values(self, X) -> np.ndarray:
        """Exact path-dependent TreeSHAP in margin (log-odds) space. Sets
        ``expected_value_``; rows satisfy sum(phi) + expected_value_ ==
        decision margin."""
        from pd_fusion_torch.ops import treeshap

        trees = self._device_trees()
        if "leaf_cover" not in self.trees_:
            raise AttributeError(
                "this DeviceHistGBDT artifact predates cover recording; retrain to get shap_values"
            )
        bins = bin_features(np.asarray(X, np.float32), self.edges_)
        phi, ev = treeshap.shap_values(trees, bins, self.base_score_, depth=self.max_depth)
        self.expected_value_ = ev
        return phi


def fit_gbdt_stack(models: List["DeviceHistGBDT"], Xs, ys) -> List["DeviceHistGBDT"]:
    """Fit ``models[i]`` on ``(Xs[i], ys[i])`` as one fold-batched
    ``train_gbdt`` call; the models share their hyperparameters. Each is
    binned with its own edges and weighted as its ``fit`` would; rows are
    padded to the longest with weight 0 (exact no-ops) and features to the
    widest with ``MISSING_BIN`` codes, whose splits leave one side empty and
    so never pass ``min_child_weight`` (> 0): each ensemble equals the
    model's own ``fit``, which the tests and ``analysis/tabular_checks.py``
    hold."""
    hp = models[0].hparams()
    if any(m.hparams() != hp or m.class_weight != models[0].class_weight for m in models):
        raise ValueError("fit_gbdt_stack needs models with one set of hyperparameters")
    if not hp["min_child_weight"] > 0.0:
        raise ValueError("fit_gbdt_stack pads features, which needs min_child_weight > 0")
    prepared = [models[0]._fit_inputs(X, y) for X, y in zip(Xs, ys)]
    K = len(models)
    n_max = max(len(y) for _, _, y, _, _ in prepared)
    f_max = max(b.shape[1] for _, b, _, _, _ in prepared)
    bins = np.full((K, n_max, f_max), MISSING_BIN, np.int32)
    y_st = np.zeros((K, n_max), np.float32)
    w_st = np.zeros((K, n_max), np.float32)
    for k, (_, b, y, w, _) in enumerate(prepared):
        bins[k, : b.shape[0], : b.shape[1]] = b
        y_st[k, : len(y)] = y
        w_st[k, : len(y)] = w
    dev = get_device()
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    bases = np.array([base for *_, base in prepared], np.float32)
    n_rows = [len(p[2]) for p in prepared] if dev.type == "cpu" else None
    trees = train_gbdt(t(bins), t(y_st), t(w_st), t(bases), n_rows=n_rows, **hp)
    for k, (m, (edges, *_, base)) in enumerate(zip(models, prepared)):
        m.edges_, m.base_score_ = edges, base
        m._trees_dev = {key: v[k] for key, v in trees.items()}
        m.trees_ = {key: v.cpu().numpy() for key, v in m._trees_dev.items()}
    return models


def gbdt_trees_from_jax(trees, device=None) -> Dict[str, torch.Tensor]:
    """A JAX ensemble (dict of arrays, [R, ...] or [K, R, ...]) -> the
    port's tensors (copied)."""
    return {k: torch.tensor(np.array(v, copy=True), device=device) for k, v in trees.items()}
