"""Checks of the histogram GBDT (``nn/gbdt.py``) shared by the CPU tests,
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``: the
teacher-forced split-optimality audit (a numpy copy of the JAX package's
``tests/test_device_gbdt.py::audit_device_trees``), seeded data, and the
card-against-CPU and fit-against-fit comparisons.

Exact gain ties are structural in histogram boosting (a split and its
complement, or samples with identical (g, h) interchangeable between two
features, give equal gains), so two correct implementations, or one on
two devices, may pick different splits wherever rounding breaks a tie
differently. The invariant is per-node optimality of a trainer's own
choices: every real split's gain equals its node's best (to ``tol``
relative), every real split gains more than ``-zero_tol`` (relative; 0 in
float64), pass-through nodes only where nothing gains more than ``tol``,
and leaf values -lr*G/(H+lam) of the trainer's own routing (to
``leaf_tol``). The audit replays in float64; a float32 ensemble passes
with ``F32_TOLS``: a float32 trainer may take a split whose exact gain is
0 (a tie with the pass-through) where rounding made it positive.
"""
import numpy as np
import torch

from pd_fusion_torch.nn.gbdt import MISSING_BIN, N_VALUE_BINS, TREE_KEYS

F64_TOLS = {"tol": 1e-9, "leaf_tol": 1e-9, "zero_tol": 0.0}
F32_TOLS = {"tol": 1e-5, "leaf_tol": 1e-5, "zero_tol": 1e-5}


def _oracle_gain(GL, HL, CL, G, H, C, lam, mcw, mcs):
    """Second-order gain of candidate splits (arrays), -inf where a child
    breaks ``min_child_weight`` / ``min_child_samples``."""
    GR, HR, CR = G - GL, H - HL, C - CL
    dl = np.where(HL + lam > 0, HL + lam, 1.0)
    dr = np.where(HR + lam > 0, HR + lam, 1.0)
    dp = H + lam if H + lam > 0 else 1.0
    gain = 0.5 * (GL * GL / dl + GR * GR / dr - G * G / dp)
    ok = (HL >= mcw) & (HR >= mcw) & (CL >= mcs) & (CR >= mcs)
    return np.where(ok, gain, -np.inf)


def _node_gain_of(bins_sel, g_sel, h_sel, w_sel, f, t, miss_left, lam, mcw, mcs):
    """Gain of one (feature, threshold, missing-direction) candidate."""
    b = bins_sel[:, f]
    left = np.where(b == MISSING_BIN, miss_left, b <= t)
    return float(_oracle_gain(np.array(g_sel[left].sum()), np.array(h_sel[left].sum()),
                              np.array(w_sel[left].sum()), g_sel.sum(), h_sel.sum(),
                              w_sel.sum(), lam, mcw, mcs))


def _node_best_gain(bins_sel, g_sel, h_sel, w_sel, lam, mcw, mcs):
    """Max split gain over every (feature, threshold, missing-direction)."""
    G, H, C = g_sel.sum(), h_sel.sum(), w_sel.sum()
    best = -np.inf
    for f in range(bins_sel.shape[1]):
        bh = bins_sel[:, f]
        hist = [np.bincount(bh, weights=v, minlength=256) for v in (g_sel, h_sel, w_sel)]
        cum = [np.cumsum(x[:N_VALUE_BINS]) for x in hist]
        for miss_left in (True, False):
            left = [c + x[MISSING_BIN] if miss_left else c for c, x in zip(cum, hist)]
            best = max(best, float(_oracle_gain(*left, G, H, C, lam, mcw, mcs).max()))
    return best


def audit_trees(bins, y, w, trees, n_rounds, depth, lr, lam, mcw, mcs, base, tol=1e-9,
                leaf_tol=1e-9, zero_tol=0.0):
    """Teacher-forced float64 audit of a trained ensemble (numpy trees
    [R, ...]); raises AssertionError at the first non-optimal node or
    wrong leaf. -> the replayed margin [N]."""
    n = bins.shape[0]
    y = np.asarray(y, np.float64)
    w = np.asarray(w, np.float64)
    margin = np.full(n, base, np.float64)
    for r in range(n_rounds):
        p = 1.0 / (1.0 + np.exp(-margin))
        g = (p - y) * w
        h = p * (1.0 - p) * w
        node = np.zeros(n, np.int64)
        for level in range(depth):
            for nd in range(1 << level):
                sel = node == nd
                best = _node_best_gain(bins[sel], g[sel], h[sel], w[sel], lam, mcw, mcs)
                f_d = int(trees["feat"][r][level, nd])
                t_d = int(trees["thr"][r][level, nd])
                ml_d = bool(trees["miss_left"][r][level, nd])
                where = f"round {r} level {level} node {nd}"
                if t_d == MISSING_BIN:  # pass-through
                    if best > tol:
                        raise AssertionError(f"{where}: passed through but a split gains {best}")
                    continue
                gain_d = _node_gain_of(bins[sel], g[sel], h[sel], w[sel], f_d, t_d, ml_d, lam,
                                       mcw, mcs)
                if not gain_d > -zero_tol * max(1.0, abs(best)):
                    raise AssertionError(f"{where}: the split's gain {gain_d} is not positive")
                if gain_d < best - tol * max(1.0, abs(best)):
                    raise AssertionError(f"{where}: the split's gain {gain_d} < best {best}")
            f_of_n = trees["feat"][r][level][node]
            t_of_n = trees["thr"][r][level][node]
            ml_of_n = trees["miss_left"][r][level][node]
            b = bins[np.arange(n), f_of_n]
            go_left = np.where(b == MISSING_BIN, ml_of_n, b <= t_of_n)
            node = node * 2 + (1 - go_left.astype(np.int64))
        for leaf in range(1 << depth):
            sel = node == leaf
            denom = h[sel].sum() + lam
            expect = -lr * g[sel].sum() / denom if denom > 0 else 0.0
            got = float(trees["leaf"][r][leaf])
            if abs(got - expect) > leaf_tol * max(1.0, abs(expect)):
                raise AssertionError(f"round {r} leaf {leaf}: value {got} != {expect}")
        margin = margin + trees["leaf"][r][node]
    return margin


def make_data(seed=0, n=300, f=6, miss=0.15):
    """A nonlinear binary task with missing values (NaN)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    logits = 1.5 * X[:, 0] - X[:, 1] + 0.8 * X[:, 2] * X[:, 3]
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    X[rng.random((n, f)) < miss] = np.nan
    return X, y


def to_numpy(trees):
    return {k: v.cpu().numpy() for k, v in trees.items()}


def same_structure(a, b) -> bool:
    """Whether two numpy ensembles split alike (feature, threshold,
    missing direction at every node)."""
    return all(np.array_equal(a[k], b[k]) for k in ("feat", "thr", "miss_left"))


def bitwise_equal(a, b) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in TREE_KEYS)


def fit(bins, y, w, base, hp, device):
    """One ``train_gbdt`` call on ``device`` from numpy inputs -> numpy
    trees (a fold-batched stack when ``bins`` is [K, N, F])."""
    from pd_fusion_torch.nn.gbdt import train_gbdt

    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return to_numpy(train_gbdt(t(bins), t(y), t(w), t(np.asarray(base, np.float32)), **hp))


def cv_like_inputs(K=5, n=400, f=10, seed=0):
    """Fold-batched inputs at a CV frame's widths: per-fold bins [K, n, f]
    (each fold binned with its own edges), labels, weights with a ragged
    last fold, and the per-fold base scores."""
    from pd_fusion_torch.nn.gbdt import bin_features, compute_base_score, fit_bin_edges

    bins, ys, ws, bases = [], [], [], []
    for k in range(K):
        X, y = make_data(seed * 100 + k, n=n, f=f, miss=0.05)
        bins.append(bin_features(X, fit_bin_edges(X)))
        wk = np.ones(n, np.float32)
        if k == K - 1:
            wk[-n // 10:] = 0.0
        ys.append(y)
        ws.append(wk)
        bases.append(compute_base_score(y, wk))
    return np.stack(bins), np.stack(ys), np.stack(ws), np.array(bases, np.float32)


def compare_card_with_cpu(bins, y, w, base, hp, device="cuda"):
    """One fit on the card and one on the CPU from the same bins. Where the
    trees differ (a near-tie broken the other way), both must pass the
    float32 audit from the first round that differs. -> (structures
    equal, first differing round or None, max abs leaf difference over
    the rounds before it)."""
    card = fit(bins, y, w, base, hp, device)
    cpu = fit(bins, y, w, base, hp, "cpu")
    R = card["leaf"].shape[0]
    first = next((r for r in range(R)
                  if not same_structure({k: v[r] for k, v in card.items()},
                                        {k: v[r] for k, v in cpu.items()})), None)
    upto = R if first is None else first
    leaf_err = float(np.abs(card["leaf"][:upto] - cpu["leaf"][:upto]).max()) if upto else 0.0
    if first is not None:
        # audit both fully: each ensemble must be optimal for its own margins
        for trees in (card, cpu):
            audit_trees(bins, y, w, trees, R, hp["depth"], hp["lr"], hp["lam"],
                        hp["min_child_weight"], hp["min_child_samples"], float(base), **F32_TOLS)
    return first is None, first, leaf_err


def check_two_fits_identical(bins, y, w, base, hp, device="cuda") -> None:
    """Two fits on ``device`` from the same inputs must give bit-identical
    ensembles (the onehot lowering reduces in a fixed order)."""
    a, b = (fit(bins, y, w, base, hp, device) for _ in range(2))
    if not bitwise_equal(a, b):
        raise AssertionError(f"two {hp['hist_mode']} fits on {device} differ")


def check_fold_batched_equals_per_fold(bins, y, w, base, hp, device="cuda") -> bool:
    """The fold-batched fit (the CV engine's) against one fit per fold on
    ``device``: the same splits and leaf values, and gains within 1e-6
    relative. -> whether every fold is bit-identical. On the card every
    op is per element or per fold, so the fits are bit-identical; on the
    CPU the vectorised sigmoid rounds a row's tail elements differently
    when the row stands alone, which forks near-ties after enough rounds,
    so CPU callers keep to a few rounds."""
    stacked = fit(bins, y, w, base, hp, device)
    same = True
    for k in range(bins.shape[0]):
        mine = {key: v[k] for key, v in stacked.items()}
        one = fit(bins[k], y[k], w[k], base[k], hp, device)
        if not (same_structure(mine, one) and np.array_equal(mine["leaf"], one["leaf"])
                and np.allclose(mine["gain"], one["gain"], rtol=1e-6, atol=0)):
            raise AssertionError(f"fold {k}: the fold-batched fit differs from the fold's own fit")
        same = same and bitwise_equal(mine, one)
    return same


SHAP_ATOL = 1e-5  # card against CPU, float32 sums in another order
ADDITIVITY_ATOL = 5e-4  # sum(phi) + expected value against the margin (float32)


def compare_shap_card_with_cpu(trees, bins, base, depth, device="cuda"):
    """TreeSHAP of one ensemble (numpy trees [R, ...]) on the card and on
    the CPU, and additivity on the card: sum(phi) + expected value ==
    margin. -> (max abs phi difference, additivity error, card s, CPU s)."""
    import time

    from pd_fusion_torch.nn.gbdt import predict_margin
    from pd_fusion_torch.ops.treeshap import shap_values

    out = {}
    for dev in (device, "cpu"):
        t = {k: torch.as_tensor(v, device=dev) for k, v in trees.items()}
        if dev != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        phi, ev = shap_values(t, bins, base, depth=depth)
        out[dev] = (phi, ev, time.perf_counter() - t0)
        if dev == device:
            margin = predict_margin(t, torch.as_tensor(bins, device=dev), np.float32(base),
                                    depth=depth).cpu().numpy()
    err = float(np.abs(out[device][0] - out["cpu"][0]).max())
    err = max(err, abs(out[device][1] - out["cpu"][1]))
    add = float(np.abs(out[device][0].sum(1) + out[device][1] - margin).max())
    if err > SHAP_ATOL or add > ADDITIVITY_ATOL:
        raise AssertionError(f"TreeSHAP card vs CPU max abs err {err:.3e} (atol {SHAP_ATOL}), "
                             f"additivity {add:.3e} (atol {ADDITIVITY_ATOL})")
    return err, add, out[device][2], out["cpu"][2]
