"""Missingness-conditioned Mixture-of-Experts, stacked-expert formulation
(port of ``pd_fusion/nn/moe.py``).

One dense expert MLP per modality and a router MLP over the [N, M]
availability mask, whose softmax weights combine the experts'
probabilities: ``sum_m w_m * sigmoid(expert_m)``; full-batch Adam on BCE.

The experts are STACKED: per-modality inputs are zero-padded to a common
feature width and all experts run as one batched product
(``'mnf,mfh->mnh'``). Padded weight rows get exactly-zero gradients
(their inputs are zero), so stacking equals the serial per-expert
computation.

Params: ``{"experts": [{"w": [M, in, out], "b": [M, out]}, ...],
"router": [{"w": [in, out], "b": [out]}, ...]}``. A fold-batched stack of
K models has a leading fold axis on every leaf and inputs ``x`` [K, M, N,
F], ``mask`` [K, N, M]; leading axes broadcast, so params with a leading
[K, 1] apply to inputs [K, S, M, N, F] (every fold and scenario at once).

Initialisation is torch ``nn.Linear``'s, with the TRUE per-expert fan-in
on layer 0 and the padded rows zeroed, as in the JAX package; the draws
come from a ``torch.Generator`` (per layer, per modality in sorted order,
w then b; then the router), so they differ from the JAX package's. Tests
carry weights across with ``moe_params_from_jax``. Training draws
nothing at random.
"""
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pd_fusion_torch.nn.trainer import make_optimizer
from pd_fusion_torch.parallel.distributed import all_reduce, all_reduce_grads

MoEParams = Dict[str, List[Dict[str, torch.Tensor]]]


def _uniform(generator, shape, fan_in):
    bound = 1.0 / torch.sqrt(torch.tensor(float(max(fan_in, 1)), dtype=torch.float32))
    return torch.empty(shape, dtype=torch.float32).uniform_(-float(bound), float(bound),
                                                             generator=generator)


def moe_init(generator: torch.Generator, modality_dims: Dict[str, int],
             expert_hidden: Sequence[int], router_hidden: Sequence[int], device=None) -> MoEParams:
    """Drawn on the CPU, then moved to ``device``."""
    mods = sorted(modality_dims)
    M = len(mods)
    layer_dims = [max(modality_dims[m] for m in mods), *expert_hidden, 1]
    experts = []
    for li in range(len(layer_dims) - 1):
        ws, bs = [], []
        for mod in mods:
            fan_in = modality_dims[mod] if li == 0 else layer_dims[li]
            w = _uniform(generator, (layer_dims[li], layer_dims[li + 1]), fan_in)
            if li == 0:
                w[modality_dims[mod]:] = 0.0  # rows of the zero padding
            ws.append(w)
            bs.append(_uniform(generator, (layer_dims[li + 1],), fan_in))
        experts.append({"w": torch.stack(ws).to(device), "b": torch.stack(bs).to(device)})
    router_dims = [M, *router_hidden, M]
    router = []
    for li in range(len(router_dims) - 1):
        w = _uniform(generator, (router_dims[li], router_dims[li + 1]), router_dims[li])
        b = _uniform(generator, (router_dims[li + 1],), router_dims[li])
        router.append({"w": w.to(device), "b": b.to(device)})
    return {"experts": experts, "router": router}


def moe_params_from_jax(tree, device=None) -> MoEParams:
    """JAX MoE params (numpy arrays, stacked or not) -> the port's. Every
    array is COPIED, so ``opt.step()`` never writes into the caller's."""
    return {part: [{k: torch.tensor(np.array(v, dtype=np.float32, copy=True), device=device)
                    for k, v in layer.items()} for layer in tree[part]]
            for part in ("experts", "router")}


def moe_params_to_numpy(params: MoEParams):
    """Inverse of ``moe_params_from_jax``: fresh numpy copies."""
    return {part: [{k: v.detach().cpu().numpy().copy() for k, v in layer.items()}
                   for layer in params[part]] for part in ("experts", "router")}


def map_params(params: MoEParams, fn) -> MoEParams:
    return {part: [{k: fn(v) for k, v in layer.items()} for layer in params[part]]
            for part in ("experts", "router")}


def moe_apply(params: MoEParams, x_stack: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x_stack: [..., M, N, Fmax] zero-padded per-modality inputs; mask:
    [..., N, M]. Returns the combined probability [..., N]."""
    h = x_stack
    n_layers = len(params["experts"])
    for li, layer in enumerate(params["experts"]):
        h = torch.einsum("...mnf,...mfh->...mnh", h, layer["w"]) + layer["b"].unsqueeze(-2)
        if li < n_layers - 1:
            h = torch.relu(h)
    expert_probs = torch.sigmoid(h[..., 0])  # [..., M, N]

    r = mask
    for li, layer in enumerate(params["router"]):
        r = torch.matmul(r, layer["w"]) + layer["b"].unsqueeze(-2)
        if li < len(params["router"]) - 1:
            r = torch.relu(r)
    weights = torch.softmax(r, dim=-1)  # [..., N, M]
    return torch.sum(weights * expert_probs.transpose(-1, -2), dim=-1)


def moe_loss(params, x_stack, mask, y, w: Optional[torch.Tensor] = None,
             total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Clipped BCE on probabilities, one value per fold: the unweighted
    mean without ``w``, else the weighted mean with the safe denominator
    ``where(t > 0, t, 1)`` (padding rows have weight 0); ``total`` gives
    ``t`` when the rows are one rank's share of a data group."""
    p = torch.clamp(moe_apply(params, x_stack, mask), 1e-7, 1.0 - 1e-7)
    l = -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))
    if w is None:
        return torch.mean(l, dim=-1)
    t = torch.sum(w, dim=-1) if total is None else total
    return torch.sum(l * w, dim=-1) / torch.where(t > 0, t, 1.0)


def train_moe_folds(params: MoEParams, x_stack, mask, y, w: Optional[torch.Tensor], lr: float,
                    epochs: int, weight_decay: float = 0.0, data_group=None) -> MoEParams:
    """Full-batch Adam, one step per epoch, on a fold-batched stack (x
    [K, M, N, F], mask [K, N, M], y and w [K, N]). One Adam runs over the
    stacked leaves: fold k's loss touches only fold k's slice, so the sum
    of the per-fold losses gives every fold its own gradient and update.
    ``add_decayed_weights(wd)`` ahead of Adam is Adam's ``weight_decay``.
    Under ``data_group`` the N axis holds this rank's rows: the loss
    divides by the fold's global weight sum and the gradients are summed
    over the group before each step (``w`` required)."""
    p = map_params(params, lambda v: v.detach().clone().requires_grad_(True))
    leaves = [layer[k] for part in ("experts", "router") for layer in p[part] for k in ("w", "b")]
    opt = make_optimizer(leaves, lr, weight_decay)
    total = None if data_group is None else all_reduce(torch.sum(w, dim=-1), data_group)
    for _ in range(epochs):
        grads = torch.autograd.grad(moe_loss(p, x_stack, mask, y, w, total).sum(), leaves)
        if data_group is not None:
            grads = all_reduce_grads(grads, data_group)
        for leaf, g in zip(leaves, grads):
            leaf.grad = g
        opt.step()
    return map_params(p, lambda v: v.detach())


def train_moe(params: MoEParams, x_stack, mask, y, lr: float, epochs: int,
              weight_decay: float = 0.0) -> MoEParams:
    """One model ([M, N, F] inputs), the unweighted mean loss."""
    trained = train_moe_folds(map_params(params, lambda v: v[None]), x_stack[None], mask[None],
                              y[None], None, lr, epochs, weight_decay)
    return map_params(trained, lambda v: v[0])


def moe_predict(params: MoEParams, x_stack, mask) -> torch.Tensor:
    with torch.no_grad():
        return moe_apply(params, x_stack, mask)
