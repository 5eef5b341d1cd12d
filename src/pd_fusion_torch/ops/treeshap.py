"""Exact path-dependent TreeSHAP for the histogram GBDT, as dense tensor
algebra instead of the recursive EXTEND/UNWIND walk (port of
``pd_fusion/ops/treeshap.py``).

Semantics are shap's ``tree_path_dependent``: the value of a feature
coalition S is the expected tree output when the features in S follow
the sample and the others split by node "covers" (training sample-weight
totals); the SHAP value of feature i is the Shapley value of that game.

A depth-D tree has 2^D leaves whose paths each touch <= D distinct
features, and the per-leaf game value factorizes per path level. So all
2^D coalition masks of all 2^D leaves are one dense [N, leaves, masks]
block per tree (duplicate features on a path are tied to their first
occurrence, the "representative" slot; masks touching other slots are
invalid); every coalition's reach probability is D broadcast multiplies,
and one contraction against precomputed Shapley weights gives the
values. The trees are a Python loop, as the JAX package's scan over
trees; samples go in chunks of ``_CHUNK``.
"""
from math import factorial

import numpy as np
import torch

MAX_DEPTH = 8  # [N, 2^D, 2^D] blocks; 4^D memory beyond this is silly
_CHUNK = 256  # samples per chunk (bounds the dense block)


def _shapley_weight_table(depth_plus_one: int) -> np.ndarray:
    """W[k, u] = k! (u-k-1)! / u! for k < u (0 elsewhere, never read)."""
    n = depth_plus_one + 1
    W = np.zeros((n, n), np.float64)
    for u in range(1, n):
        for k in range(u):
            W[k, u] = factorial(k) * factorial(u - k - 1) / factorial(u)
    return W.astype(np.float32)


def _shap_chunk(trees, bins: torch.Tensor, depth: int, n_features: int):
    """SHAP values for one sample chunk (bins int64 [N, F] on the trees'
    device). Returns ([N, F] margin-space phi, expected margin offset
    excluding base_score, a 0-d tensor)."""
    from pd_fusion_torch.nn.gbdt import MISSING_BIN

    dev = bins.device
    D, L, M = depth, 1 << depth, 1 << depth
    N = bins.shape[0]
    lvl = torch.arange(D, device=dev)
    leaf_ids = torch.arange(L, device=dev)
    # ancestor node index at each level + branch direction taken from it
    anc = leaf_ids[None, :] >> (D - lvl[:, None])  # [D, L]
    dirs = (leaf_ids[None, :] >> (D - 1 - lvl[:, None])) & 1  # [D, L]
    masks = torch.arange(M, device=dev)
    bit = ((masks[None, :] >> lvl[:, None]) & 1).bool()  # [D, M]
    pc = bit.sum(0)  # [M] coalition size (valid masks use only rep slots)
    Wtab = torch.as_tensor(_shapley_weight_table(D + 1), device=dev)
    lvl_col = lvl[:, None]

    phi = torch.zeros((N, n_features), dtype=torch.float32, device=dev)
    ev = torch.zeros((), dtype=torch.float32, device=dev)
    for r in range(trees["leaf"].shape[0]):
        feat, leaf, lc = trees["feat"][r].long(), trees["leaf"][r], trees["leaf_cover"][r]
        f_path = feat[lvl_col, anc]  # [D, L]
        t_path = trees["thr"][r].long()[lvl_col, anc]
        ml_path = trees["miss_left"][r][lvl_col, anc]
        # cover fraction of the taken branch (the off-coalition factor);
        # internal-node covers derive from descendant-leaf sums
        cov_all = torch.stack(
            [torch.nn.functional.pad(lc.reshape(1 << lv, -1).sum(1), (0, L - (1 << lv)))
             for lv in range(D)] + [lc])  # [D+1, L] node covers per level (zero-padded)
        parent = cov_all[lvl_col, anc]
        child = cov_all[(lvl + 1)[:, None], anc * 2 + dirs]
        frac = torch.where(parent > 0, child / torch.where(parent > 0, parent, 1.0), 0.0)
        # whether the sample follows each path edge (the in-coalition factor)
        b = bins[:, f_path]  # [N, D, L]
        go_left = torch.where(b == MISSING_BIN, ml_path[None], b <= t_path[None])
        follow = (go_left == (dirs[None] == 0)).float()  # [N, D, L]
        # duplicate path features tie to their first occurrence (rep slot)
        eq = f_path[:, None, :] == f_path[None, :, :]  # [l', l, L]
        rep = torch.argmax(eq.int(), dim=0)  # [D, L] first level with same feature
        is_rep = rep == lvl_col  # [D, L]
        u = is_rep.sum(0)  # [L] distinct features on the path
        valid = ~((bit[:, None, :] & ~is_rep[:, :, None]).any(0))  # [L, M]
        inc = ((masks[None, None, :] >> rep[:, :, None]) & 1).bool()  # [D, L, M]
        # coalition reach probability, one multiply per level
        P = torch.ones((N, L, M), dtype=torch.float32, device=dev)
        for level in range(D):
            P = P * torch.where(inc[level][None], follow[:, level, :, None],
                                frac[level][None, :, None])
        # Shapley contraction: for rep slot r, +W(|S|,u)P(S+r) when r is in
        # the mask, -W(|S|,u)P(S) when not
        w_with = Wtab[torch.clamp(pc - 1, 0, D)[None, :], u[:, None]]  # [L, M]
        w_without = Wtab[torch.clamp(pc, 0, D)[None, :], u[:, None]]
        coef = (valid[None] * is_rep[:, :, None]
                * torch.where(bit[:, None, :], w_with[None], -w_without[None]))  # [D, L, M]
        onehot = torch.nn.functional.one_hot(f_path, n_features).float()  # [D, L, F]
        phi_slot = torch.einsum("nlm,dlm->ndl", P, coef)
        phi = phi + torch.einsum("ndl,l,dlf->nf", phi_slot, leaf, onehot)
        ev = ev + (leaf * torch.prod(frac, dim=0)).sum()
    return phi, ev


def shap_values(trees, bins, base_score, *, depth: int):
    """Margin-space SHAP values (like TreeExplainer on a boosted binary
    classifier) for binned samples; ``trees`` are tensors [R, ...] on the
    device the work runs on. Returns (phi [N, F] numpy, expected_value
    float) with sum(phi[n]) + expected_value == predict_margin(n)."""
    if depth > MAX_DEPTH:
        raise ValueError(
            f"treeshap: depth {depth} > {MAX_DEPTH} (the dense coalition "
            "block is 4^depth; use a host explainer for deeper trees)"
        )
    dev = trees["leaf"].device
    bins = np.asarray(bins)
    n, f = bins.shape
    with torch.no_grad():
        if n == 0:
            # expected_value is data-independent: take it from one all-zeros
            # probe chunk
            _, ev0 = _shap_chunk(trees, torch.zeros((_CHUNK, f), dtype=torch.long, device=dev),
                                 depth, f)
            return np.zeros((0, f), np.float32), float(ev0) + float(base_score)
        out = []
        ev = None
        for lo in range(0, n, _CHUNK):
            chunk = torch.as_tensor(bins[lo: lo + _CHUNK], device=dev).long()
            phi, ev_j = _shap_chunk(trees, chunk, depth, f)
            out.append(phi.cpu().numpy())
            ev = float(ev_j)
    return np.concatenate(out)[:n], ev + float(base_score)
