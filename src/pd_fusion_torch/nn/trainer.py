"""Training loops for the tabular model families (port of
``pd_fusion/nn/trainer.py``).

The JAX package runs every epoch and minibatch of a training run as one
``lax.scan`` program and ``vmap``s it over a fold axis for the CV engine.
The port loops epochs and minibatches in Python over torch ops, and keeps
the fold axis as a batch dimension: every trainer here takes either one
model (``X`` [N, F], params ``w`` [in, out]) or a fold-batched stack of K
(``X`` [K, N, F], ``w`` [K, in, out]). A single model runs as a stack of
one. One ``torch.optim.Adam`` runs over the stacked leaves; Adam and
weight decay are elementwise and fold k's loss depends only on fold k's
slice, so the sum of the per-fold losses gives each fold exactly its own
gradient and update.

Optimizer: ``optax.chain(add_decayed_weights(wd), adam(lr))`` is
``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)``
(the L2 term is added to the gradient before the moments).

Random draws (shuffles, whole-modality keeps, dropout keeps) are made up
front, on the data's device, by ``draw_fullbatch`` / ``draw_minibatch``
from one generator per model (a list of generators, one per fold, for a
stack). Each trainer also takes the draws explicitly, in which case it
draws nothing: a test feeds it the JAX package's own draws that way.
Draw layouts (a stack adds a leading fold axis to each):

- ``perms``: int [E, n];
- ``moddrop_keep``: bool [E, n_batches, M], or [E, n_batches, bs, M]
  with ``per_sample``;
- ``dropout_keep``: one bool tensor per hidden layer, [E, n_batches, bs,
  h_i] for minibatch training, [E, n, h_i] for full-batch training.

Data parallelism (``data_group``, the data axis of the CV engine's
``("fold", "data")`` mesh): ``X``, ``y`` and ``w`` hold this rank's
contiguous rows of each fold, all ranks of the group equally many, and
every rank draws the draws of the whole fold (the same generators, or the
same explicit draws), so a minibatch is the same global rows on every
rank. Each rank takes the weighted loss of the batch's rows it owns over
the batch's global weight sum (one all-reduce of the sums per epoch), and
the gradients are summed over the group before each Adam step, so the
replicas' params stay bitwise equal and follow the one-card run up to the
order of the sums.
"""
import math
from typing import List, Optional, Sequence, Union

import torch

from pd_fusion_torch.nn.mlp import Params, bce_with_logits, mlp_apply
from pd_fusion_torch.ops.metrics import roc_auc
from pd_fusion_torch.parallel.distributed import all_reduce, all_reduce_grads, row_span

Generators = Union[torch.Generator, Sequence[torch.Generator]]


def make_optimizer(leaves, lr: float, weight_decay: float = 0.0) -> torch.optim.Adam:
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def _hidden_widths(params: Params) -> List[int]:
    return [int(layer["w"].shape[-1]) for layer in params[:-1]]


def draw_fullbatch(generator: torch.Generator, epochs: int, n: int, hidden: Sequence[int],
                   dropout: float, device) -> Optional[List[torch.Tensor]]:
    """Dropout keeps for full-batch training: per hidden layer [E, n, h]
    (None without dropout)."""
    if dropout <= 0.0:
        return None
    return [torch.rand((epochs, n, h), generator=generator, device=device) < 1.0 - dropout
            for h in hidden]


def draw_minibatch(generator: torch.Generator, epochs: int, n: int, batch_size: int,
                   n_mod: int, hidden: Sequence[int], dropout: float, moddrop_rate: float,
                   per_sample: bool, device):
    """(perms, moddrop_keep, dropout_keep) for minibatch training, drawn in
    that order. A shuffle is the stable argsort of float64 uniforms."""
    nb = -(-n // batch_size)
    perms = torch.argsort(
        torch.rand((epochs, n), generator=generator, device=device, dtype=torch.float64),
        dim=-1, stable=True)
    kshape = (epochs, nb, batch_size, n_mod) if per_sample else (epochs, nb, n_mod)
    moddrop_keep = torch.rand(kshape, generator=generator, device=device) < 1.0 - moddrop_rate
    dropout_keep = None
    if dropout > 0.0:
        dropout_keep = [
            torch.rand((epochs, nb, batch_size, h), generator=generator, device=device)
            < 1.0 - dropout
            for h in hidden
        ]
    return perms, moddrop_keep, dropout_keep


def _each(t, fn):
    """``fn`` over a draw: a tensor, one tensor per layer, or None."""
    if t is None:
        return None
    if isinstance(t, list):
        return [fn(x) for x in t]
    return fn(t)


def _lead(t):
    """Add a leading fold axis (a single model's draws -> a stack of one)."""
    return _each(t, lambda x: x[None])


def _fold_axis_to(t, axis: int):
    """Stacked draws [K, E, ...] -> the fold axis at ``axis``."""
    return _each(t, lambda x: x.movedim(0, axis))


def _stacked_draws(draw, generator: Generators, single: bool):
    """``draw(g)`` (a tuple of draws) for each model's generator, stacked
    on a leading fold axis."""
    per_fold = [draw(g) for g in ([generator] if single else generator)]

    def stack(items):
        if items[0] is None:
            return None
        if isinstance(items[0], list):
            return [torch.stack(layer) for layer in zip(*items)]
        return torch.stack(items)

    return tuple(stack(list(items)) for items in zip(*per_fold))


def _as_stack(params: Params, X: torch.Tensor):
    """-> (single, trainable stacked params, their leaves, unstack): a
    single model becomes a stack of one."""
    single = X.dim() == 2
    p = [{k: (v[None] if single else v).detach().clone().requires_grad_(True)
          for k, v in layer.items()} for layer in params]
    leaves = [layer[k] for layer in p for k in ("w", "b")]

    def unstack():
        return [{k: (v[0] if single else v).detach() for k, v in layer.items()} for layer in p]

    return single, p, leaves, unstack


def _step(opt, leaves, loss, data_group=None):
    grads = torch.autograd.grad(loss, leaves)
    if data_group is not None:
        grads = all_reduce_grads(grads, data_group)
    for leaf, g in zip(leaves, grads):
        leaf.grad = g
    opt.step()


def fullbatch_impl(
    params: Params,
    X: torch.Tensor,
    y: torch.Tensor,
    w: Optional[torch.Tensor],
    generator: Optional[Generators],
    lr: float,
    epochs: int,
    dropout: float = 0.2,
    weight_decay: float = 0.0,
    dropout_keep: Optional[Sequence[torch.Tensor]] = None,
    data_group=None,
) -> Params:
    """One Adam step per epoch on the whole set (no minibatching, no early
    stopping): the unweighted mean loss when ``w is None``, the weighted
    mean with the safe denominator otherwise; fresh dropout draws each
    epoch. Under ``data_group`` (``w`` required) the rows are this rank's
    and the denominator is the fold's global weight sum."""
    single, p, leaves, unstack = _as_stack(params, X)
    if single:
        X, y, w = X[None], y[None], _lead(w)
    lo, n = row_span(X.shape[1], data_group)
    if dropout_keep is None and dropout > 0.0:
        hidden = _hidden_widths(p)
        (dropout_keep,) = _stacked_draws(
            lambda g: (draw_fullbatch(g, epochs, n, hidden, dropout, X.device),),
            generator, single)
    elif single:
        dropout_keep = _lead(dropout_keep)
    dropout_keep = _fold_axis_to(dropout_keep, 1)  # [E, K, n, h]
    total = None
    if data_group is not None:
        dropout_keep = _each(dropout_keep, lambda d: d[:, :, lo: lo + X.shape[1]])
        total = all_reduce(torch.sum(w, dim=-1), data_group)
    opt = make_optimizer(leaves, lr, weight_decay)
    for e in range(epochs):
        dk = None if dropout_keep is None else [d[e] for d in dropout_keep]
        logits = mlp_apply(p, X, dropout_rate=dropout, dropout_keep=dk)
        _step(opt, leaves, bce_with_logits(logits, y, w, total).sum(), data_group)
    return unstack()


# the JAX package's jitted single-model entry point; the port has no jit
train_fullbatch = fullbatch_impl


def minibatch_moddrop_impl(
    params: Params,
    X: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    assign: torch.Tensor,  # [F, M] feature -> modality one-hot
    generator: Optional[Generators],
    lr: float,
    epochs: int,
    batch_size: int,
    dropout: float = 0.2,
    weight_decay: float = 0.0,
    moddrop_rate: float = 0.2,
    per_sample: bool = False,
    perms: Optional[torch.Tensor] = None,
    moddrop_keep: Optional[torch.Tensor] = None,
    dropout_keep: Optional[Sequence[torch.Tensor]] = None,
    data_group=None,
) -> Params:
    """Minibatch Adam with whole-modality dropout. Each epoch takes one
    permutation of the n rows; the index list is padded with row 0 to
    ``n_batches * batch_size`` and the padding rows get weight 0. Per
    batch, one Bernoulli(1 - rate) keep per modality shared by the whole
    batch (``per_sample=False``) or one per sample and modality
    (``per_sample=True``); the feature keep is ``1 - assign @ (1 - keep)``.
    Pass all three draws or none. Under ``data_group`` each batch keeps its
    global shape: the rows another rank owns enter at weight 0 (as row 0
    of this rank's shard), and the loss divides by the batch's global
    weight sum."""
    single, p, leaves, unstack = _as_stack(params, X)
    if single:
        X, y, w = X[None], y[None], w[None]
    K, n_own = X.shape[0], X.shape[1]
    lo, n = row_span(n_own, data_group)
    dev = X.device
    n_batches = -(-n // batch_size)
    pad = n_batches * batch_size - n
    if perms is None:
        hidden = _hidden_widths(p)
        perms, moddrop_keep, dropout_keep = _stacked_draws(
            lambda g: draw_minibatch(g, epochs, n, batch_size, assign.shape[1], hidden, dropout,
                                     moddrop_rate, per_sample, dev),
            generator, single)
    elif single:
        perms, moddrop_keep, dropout_keep = _lead(perms), _lead(moddrop_keep), _lead(dropout_keep)
    perms = _fold_axis_to(perms, 1)  # [E, K, n]
    moddrop_keep = _fold_axis_to(moddrop_keep, 2)  # [E, nb, K, (bs,) M]
    dropout_keep = _fold_axis_to(dropout_keep, 2)  # [E, nb, K, bs, h]
    # every step's feature keep in one product: [E, nb, K, bs or 1, F]
    feat_keep = 1.0 - torch.matmul(1.0 - moddrop_keep.to(X.dtype), assign.to(dev).T)
    if not per_sample:
        feat_keep = feat_keep.unsqueeze(-2)
    folds = torch.arange(K, device=dev)[:, None]
    pad_idx = torch.zeros((K, pad), dtype=torch.long, device=dev)
    pad_w = torch.zeros((K, pad), dtype=X.dtype, device=dev)
    opt = make_optimizer(leaves, lr, weight_decay)
    for e in range(epochs):
        perm = perms[e].to(dev, torch.long)
        total = None
        if data_group is None:
            idx = torch.cat([perm, pad_idx], 1)
            wpad = torch.cat([torch.gather(w, 1, perm), pad_w], 1)
        else:
            own = (perm >= lo) & (perm < lo + n_own)
            local = torch.where(own, perm - lo, 0)
            idx = torch.cat([local, pad_idx], 1)
            wpad = torch.cat([torch.where(own, torch.gather(w, 1, local), 0.0), pad_w], 1)
        wpad = wpad.reshape(K, n_batches, batch_size)
        if data_group is not None:
            total = all_reduce(torch.sum(wpad, dim=-1), data_group)  # [K, nb]
        Xe = X[folds, idx].reshape(K, n_batches, batch_size, -1)
        ye = y[folds, idx].reshape(K, n_batches, batch_size)
        for b in range(n_batches):
            dk = None if dropout_keep is None else [d[e, b] for d in dropout_keep]
            logits = mlp_apply(p, Xe[:, b] * feat_keep[e, b], dropout_rate=dropout,
                               dropout_keep=dk)
            loss = bce_with_logits(logits, ye[:, b], wpad[:, b],
                                   None if total is None else total[:, b])
            _step(opt, leaves, loss.sum(), data_group)
    return unstack()


# the JAX package's jitted single-model entry point; the port has no jit
train_minibatch_moddrop = minibatch_moddrop_impl


def _snapshot(p: Params) -> Params:
    return [{k: v.detach().clone() for k, v in layer.items()} for layer in p]


def train_fullbatch_earlystop(
    params: Params,
    X: torch.Tensor,
    y: torch.Tensor,
    Xv: torch.Tensor,
    yv: torch.Tensor,
    generator: Optional[torch.Generator],
    lr: float,
    pos_weight,
    epochs: int,
    dropout: float = 0.3,
    weight_decay: float = 0.0,
    patience: int = -1,
    dropout_keep: Optional[Sequence[torch.Tensor]] = None,
) -> Params:
    """Full-batch Adam with pos-weighted BCE (``mean(bce * where(y >= 0.5,
    pos_weight, 1))``) and best-val-AUC tracking, for one model.

    After each epoch's step the val AUC is taken; a NaN AUC (single-class
    val set) or any NaN val probability counts as AUC 0.0, which still
    beats the -inf start. Training stops once ``max(patience, 1)`` epochs
    in a row did not improve, so ``patience=0`` stops at the first epoch
    that does not improve; a negative patience never stops. The best
    epoch's params come back, or the final params if no AUC was ever
    finite. The JAX package freezes the params once stopped and runs the
    remaining epochs of its scan; leaving the loop gives the same params.
    """
    p = [{k: v.detach().clone().requires_grad_(True) for k, v in layer.items()}
         for layer in params]
    leaves = [layer[k] for layer in p for k in ("w", "b")]
    if dropout_keep is None and dropout > 0.0:
        dropout_keep = draw_fullbatch(generator, epochs, X.shape[0], _hidden_widths(params),
                                      dropout, X.device)
    clsw = torch.where(y >= 0.5, torch.as_tensor(pos_weight, dtype=X.dtype, device=X.device),
                       1.0)
    opt = make_optimizer(leaves, lr, weight_decay)
    best_auc, best_p, since = -math.inf, None, 0
    for e in range(epochs):
        dk = None if dropout_keep is None else [d[e] for d in dropout_keep]
        logits = mlp_apply(p, X, dropout_rate=dropout, dropout_keep=dk)
        bce = torch.logaddexp(logits, torch.zeros_like(logits)) - y * logits
        _step(opt, leaves, torch.mean(bce * clsw))
        with torch.no_grad():
            val_prob = torch.sigmoid(mlp_apply(p, Xv))
            auc = roc_auc(yv, val_prob)
            bad = torch.isnan(auc) | torch.any(torch.isnan(val_prob))
            auc = float(torch.where(bad, 0.0, auc))
        if auc > best_auc:
            best_auc, best_p, since = auc, _snapshot(p), 0
        else:
            since += 1
        if patience >= 0 and since >= max(patience, 1):
            break
    if not math.isfinite(best_auc):
        return _snapshot(p)
    return best_p


def predict_logits(params: Params, X: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return mlp_apply(params, X)


def predict_proba(params: Params, X: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return torch.sigmoid(mlp_apply(params, X))
