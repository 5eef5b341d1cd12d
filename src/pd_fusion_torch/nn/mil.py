"""Functional MIL attention network and trainer (port of ``pd_fusion/nn/mil.py``).

- net: instance layer (Linear-ReLU-Dropout) -> attention scores (plain
  tanh MLP or gated tanh*sigmoid) -> masked softmax over the bag ->
  weighted pool -> sigmoid classifier. The masked-softmax pool is the
  CUDA kernel K1 (``ops/attention_pool.py``); the D -> hidden instance
  layer is a plain ``torch.matmul`` in full float32 (the JAX package left
  it to XLA).
- training: minibatch Adam with class-balanced ``pos_weight``, optional
  global-norm gradient clipping and weight decay (the JAX package's
  ``optax.chain(clip_by_global_norm, add_decayed_weights, adam)``), early
  stopping on validation AUC with best-state restore.

Parameters are plain dicts of tensors in the JAX package's layout (see
``nn/mlp.py``); ``params_from_jax`` / ``params_to_numpy`` carry them
across. The JAX trainer runs every epoch inside one ``lax.scan`` and
freezes params once stopped; the port loops epochs in Python and leaves
the loop once stopped, which gives the same params. ``train_mil_impl``
takes explicit ``perms`` and ``dropout_keep`` draws as a test seam, so a
test can feed it the JAX package's own draws.
"""
import math
from typing import Dict, Optional

import numpy as np
import torch

from pd_fusion_torch.nn.mlp import linear_init
from pd_fusion_torch.ops.attention_pool import attention_pool
from pd_fusion_torch.ops.metrics import roc_auc

Params = Dict[str, Dict[str, torch.Tensor]]


def mil_init(generator: torch.Generator, input_dim: int, hidden_dim: int, attn_dim: int,
             gated: bool, device=None) -> Params:
    params = {
        "instance": linear_init(generator, input_dim, hidden_dim),
        "classifier": linear_init(generator, hidden_dim, 1),
    }
    if gated:
        params["attn_v"] = linear_init(generator, hidden_dim, attn_dim)
        params["attn_u"] = linear_init(generator, hidden_dim, attn_dim)
        params["attn_w"] = linear_init(generator, attn_dim, 1)
    else:
        params["attn1"] = linear_init(generator, hidden_dim, attn_dim)
        params["attn2"] = linear_init(generator, attn_dim, 1)
    return {k: {kk: v.to(device) for kk, v in layer.items()} for k, layer in params.items()}


def params_from_jax(tree, device=None) -> Params:
    """JAX MIL params (``{"instance", "classifier", "attn_v", "attn_u",
    "attn_w"}`` gated, or ``{..., "attn1", "attn2"}``; ``w`` is [in, out])
    as numpy arrays -> the port's params. Every array is COPIED: a tensor
    sharing a numpy buffer would let ``opt.step()`` mutate the caller's
    arrays."""
    return {
        k: {kk: torch.tensor(np.array(v, dtype=np.float32, copy=True), device=device)
            for kk, v in layer.items()}
        for k, layer in tree.items()
    }


def params_to_numpy(params: Params):
    """Inverse of ``params_from_jax``: fresh numpy copies."""
    return {
        k: {kk: v.detach().cpu().numpy().copy() for kk, v in layer.items()}
        for k, layer in params.items()
    }


def _lin(p, x):
    return torch.matmul(x, p["w"]) + p["b"]


def mil_apply(
    params: Params,
    x: torch.Tensor,  # [B, L, D]
    mask: torch.Tensor,  # [B, L]
    *,
    gated: bool,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    dropout_keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """-> logits [B] (sigmoid applied by callers; the loss uses logits).
    Dropout runs when ``dropout_rate > 0`` and either a ``generator`` or
    an explicit boolean ``dropout_keep`` [B, L, H] is given."""
    h = torch.relu(_lin(params["instance"], x))  # [B, L, H]
    if dropout_rate > 0.0:
        keep = dropout_keep
        if keep is None and generator is not None:
            u = torch.rand(h.shape, generator=generator, device=h.device)
            keep = u < 1.0 - dropout_rate
        if keep is not None:
            h = torch.where(keep, h / (1.0 - dropout_rate), 0.0)
    if gated:
        v = torch.tanh(_lin(params["attn_v"], h))
        u = torch.sigmoid(_lin(params["attn_u"], h))
        scores = _lin(params["attn_w"], v * u)[..., 0]  # [B, L]
    else:
        scores = _lin(params["attn2"], torch.tanh(_lin(params["attn1"], h)))[..., 0]
    pooled, _ = attention_pool(scores.contiguous(), mask, h)  # [B, H]
    return _lin(params["classifier"], pooled)[..., 0]


def _mil_loss(params, x, mask, y, w, pos_weight, gated, dropout, generator=None,
              dropout_keep=None):
    logits = mil_apply(params, x, mask, gated=gated, dropout_rate=dropout,
                       generator=generator, dropout_keep=dropout_keep)
    bce = torch.logaddexp(logits, torch.zeros_like(logits)) - y * logits
    clsw = torch.where(y >= 0.5, pos_weight, 1.0)
    # safe denominator: an all-padding batch (total weight 0) gives loss 0
    # with zero gradients, not 0/0
    t = torch.sum(w)
    return torch.sum(bce * clsw * w) / torch.where(t > 0, t, 1.0)


def _clip_by_global_norm(grads, max_norm):
    """``optax.clip_by_global_norm``: unchanged when the global norm is
    below ``max_norm``, else ``(g / norm) * max_norm``. No epsilon (torch's
    ``clip_grad_norm_`` adds 1e-6 to the norm and would drift)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


def _val_auc(params, Xv, bag_mask_v, yv, wv, gated, vmiss=None, missing_prob=0.5) -> float:
    """The epoch's validation AUC: rows flagged in ``vmiss`` score
    ``missing_prob``; a NaN prob on a real (wv > 0) row makes it NaN."""
    with torch.no_grad():
        val_prob = torch.sigmoid(mil_apply(params, Xv, bag_mask_v, gated=gated))
        if vmiss is not None:
            val_prob = torch.where(vmiss > 0, float(missing_prob), val_prob)
        auc = roc_auc(yv, val_prob, wv)
        bad = torch.any(torch.isnan(val_prob) & (wv > 0))
        return float(torch.where(bad, float("nan"), auc))


def _snapshot(params: Params) -> Params:
    return {k: {kk: v.detach().clone() for kk, v in layer.items()} for k, layer in params.items()}


def train_mil_impl(
    params: Params,
    X,  # [N, L, D] padded bags
    bag_mask,  # [N, L]
    y,  # [N]
    w_row,  # [N] per-row validity (0 for fold-padding rows)
    Xv,
    bag_mask_v,
    yv,
    wv,  # [Nv] validity weights for the (padded) val set
    generator: Optional[torch.Generator],
    lr: float,
    pos_weight,
    max_grad_norm,
    epochs: int,
    batch_size: int,
    gated: bool,
    dropout: float,
    weight_decay: float,
    use_clip: bool,
    track_best: bool,
    patience: int = 0,
    vmiss=None,
    missing_prob: float = 0.5,
    perms: Optional[torch.Tensor] = None,  # [epochs, N] explicit shuffles
    dropout_keep: Optional[torch.Tensor] = None,  # [epochs, n_batches, batch, L, H] bool
) -> Params:
    """MIL trainer: returns the val-AUC-best params when ``track_best``,
    else the final params. With ``patience > 0`` training stops once val
    AUC has not improved for ``patience`` epochs (the best params are
    restored); ``patience = 0`` returns the best epoch over the full run.
    ``w_row`` marks real rows (1) vs cross-fold padding rows (0, exact
    no-ops in the weighted loss; they still take part in the shuffle and
    the batch count, as in the JAX program). The padded final minibatch
    is filled with row 0 at weight 0. ``vmiss`` ([Nv], optional) flags val
    rows whose bag is missing: they score the constant ``missing_prob``
    and still enter the per-epoch AUC. A NaN val prob on a real row makes
    the epoch's AUC NaN, which never improves; a run that never improved
    returns its final params. Without explicit draws, shuffles and dropout
    masks come from ``generator`` (on the data's device)."""
    dev = X.device
    pos_weight = torch.as_tensor(pos_weight, dtype=torch.float32, device=dev)
    max_grad_norm = torch.as_tensor(max_grad_norm, dtype=torch.float32, device=dev)
    n = X.shape[0]
    n_batches = -(-n // batch_size)
    pad = n_batches * batch_size - n

    p = {k: {kk: v.detach().clone().requires_grad_(True) for kk, v in layer.items()}
         for k, layer in params.items()}
    # optax's leaf order (sorted keys) for the global norm
    leaves = [p[k][kk] for k in sorted(p) for kk in sorted(p[k])]
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=weight_decay)
    valid = torch.cat([torch.ones(n, device=dev), torch.zeros(pad, device=dev)])
    valid = valid.reshape(n_batches, batch_size)
    pad_idx = torch.zeros(pad, dtype=torch.long, device=dev)

    best_auc = -math.inf
    best_p = None
    since = 0
    for e in range(epochs):
        if perms is not None:
            perm = perms[e].to(dev, torch.long)
        else:
            perm = torch.randperm(n, generator=generator, device=dev)
        idx = torch.cat([perm, pad_idx]).reshape(n_batches, batch_size)
        wpad = valid * w_row[idx]
        for bi in range(n_batches):
            bidx = idx[bi]
            keep = dropout_keep[e, bi].to(dev) if dropout_keep is not None else None
            loss = _mil_loss(p, X[bidx], bag_mask[bidx], y[bidx], wpad[bi], pos_weight,
                             gated, dropout, generator, keep)
            grads = torch.autograd.grad(loss, leaves)
            if use_clip:
                grads = _clip_by_global_norm(grads, max_grad_norm)
            for leaf, g in zip(leaves, grads):
                leaf.grad = g
            opt.step()

        if track_best:
            auc = _val_auc(p, Xv, bag_mask_v, yv, wv, gated, vmiss, missing_prob)
            if auc > best_auc:  # NaN never improves
                best_auc, best_p, since = auc, _snapshot(p), 0
            else:
                since += 1
            if patience > 0 and since >= patience:
                break
    final_p = _snapshot(p)
    if not track_best or not math.isfinite(best_auc):
        return final_p
    return best_p


def train_mil(params, X, bag_mask, y, Xv, bag_mask_v, yv, wv, generator, lr, pos_weight,
              max_grad_norm, epochs: int, batch_size: int, gated: bool, dropout: float,
              weight_decay: float, use_clip: bool, track_best: bool, patience: int = 0,
              vmiss=None, missing_prob: float = 0.5):
    """Single-model wrapper (all rows real)."""
    return train_mil_impl(
        params, X, bag_mask, y, torch.ones(X.shape[0], device=X.device), Xv, bag_mask_v,
        yv, wv, generator, lr, pos_weight, max_grad_norm, epochs, batch_size, gated,
        dropout, weight_decay, use_clip, track_best, patience,
        vmiss=vmiss, missing_prob=missing_prob,
    )


def mil_predict(params: Params, X, bag_mask, gated: bool) -> torch.Tensor:
    with torch.no_grad():
        return torch.sigmoid(mil_apply(params, X, bag_mask, gated=gated))


def pad_bags(bags, max_len: Optional[int] = None):
    """Zero-pad variable-length bags [L_i, D] -> [N, max_len, D] + mask
    (numpy). max_len defaults to the batch max; pass a fixed value to share
    one shape across calls."""
    lens = [b.shape[0] for b in bags]
    L = max_len or max(lens)
    D = bags[0].shape[1]
    X = np.zeros((len(bags), L, D), np.float32)
    mask = np.zeros((len(bags), L), np.float32)
    for i, bag in enumerate(bags):
        l = min(bag.shape[0], L)
        X[i, :l] = bag[:l]
        mask[i, :l] = 1.0
    return X, mask
