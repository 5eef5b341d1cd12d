"""Functional MLP core shared by every tabular model family (port of
``pd_fusion/nn/mlp.py``).

Parameters are plain lists of dicts of tensors in the JAX package's
layout: ``[{"w": [fan_in, fan_out], "b": [fan_out]}, ...]``, applied as
``x @ w + b``. A fold-batched stack of K models has a leading fold axis on
every leaf (``w`` [K, in, out], ``b`` [K, out]) and inputs [K, ..., in];
its layers are ``torch.baddbmm`` products, one per layer for all folds.

Initialisation matches torch ``nn.Linear``'s default, as the JAX package's
does: U(-1/sqrt(fan_in), +1/sqrt(fan_in)) for both w and b, the bound
computed in float32. The draws come from an explicit ``torch.Generator``
(per layer w first, then b), so they differ from the JAX package's
``jax.random`` draws; tests carry weights across with
``mlp_params_from_jax``.

The network returns logits; the loss is the softplus form of BCE,
``softplus(z) - y * z``.
"""
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

Params = List[Dict[str, torch.Tensor]]


def linear_init(generator: torch.Generator, fan_in: int, fan_out: int) -> Dict[str, torch.Tensor]:
    bound = float(torch.tensor(1.0 / math.sqrt(max(fan_in, 1)), dtype=torch.float32))
    w = torch.empty((fan_in, fan_out), dtype=torch.float32).uniform_(-bound, bound, generator=generator)
    b = torch.empty((fan_out,), dtype=torch.float32).uniform_(-bound, bound, generator=generator)
    return {"w": w, "b": b}


def mlp_init(generator: torch.Generator, dims: Sequence[int], device=None) -> Params:
    """dims = [in, h1, ..., hk, out]; drawn on the CPU, then moved."""
    return [
        {k: v.to(device) for k, v in linear_init(generator, dims[i], dims[i + 1]).items()}
        for i in range(len(dims) - 1)
    ]


def mlp_params_from_jax(tree, device=None) -> Params:
    """JAX MLP params (a list of ``{"w", "b"}`` numpy arrays, stacked or
    not) -> the port's params. Every array is COPIED: a tensor sharing a
    numpy buffer would let ``opt.step()`` mutate the caller's arrays."""
    return [
        {k: torch.tensor(np.array(v, dtype=np.float32, copy=True), device=device)
         for k, v in layer.items()}
        for layer in tree
    ]


def mlp_params_to_numpy(params: Params):
    """Inverse of ``mlp_params_from_jax``: fresh numpy copies."""
    return [{k: v.detach().cpu().numpy().copy() for k, v in layer.items()} for layer in params]


def _linear(h: torch.Tensor, layer: Dict[str, torch.Tensor]) -> torch.Tensor:
    w, b = layer["w"], layer["b"]
    if w.dim() == 2:
        return torch.matmul(h, w) + b
    # fold-batched: w [K, in, out], h [K, ..., in]
    K = w.shape[0]
    out = torch.baddbmm(b.unsqueeze(1), h.reshape(K, -1, w.shape[1]), w)
    return out.reshape(*h.shape[:-1], w.shape[2])


def mlp_apply(
    params: Params,
    x: torch.Tensor,
    *,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    dropout_keep: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Forward pass -> logits ``h[..., 0]``. Hidden layers are
    Linear-ReLU-Dropout. Dropout is inverted (``h / keep``) and runs only
    when ``dropout_rate > 0`` and either a ``generator`` or explicit
    boolean keep masks (one per hidden layer, shaped like its output) are
    given, i.e. during training."""
    h = x
    n_layers = len(params)
    for i, layer in enumerate(params):
        h = _linear(h, layer)
        if i < n_layers - 1:
            h = torch.relu(h)
            if dropout_rate > 0.0:
                keep = None
                if dropout_keep is not None:
                    keep = dropout_keep[i]
                elif generator is not None:
                    u = torch.rand(h.shape, generator=generator, device=h.device)
                    keep = u < 1.0 - dropout_rate
                if keep is not None:
                    h = torch.where(keep, h / (1.0 - dropout_rate), 0.0)
    return h[..., 0]


def bce_with_logits(logits: torch.Tensor, y: torch.Tensor,
                    weights: Optional[torch.Tensor] = None,
                    total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary cross-entropy on logits, averaged over the last axis (one
    value per fold for fold-batched inputs, a 0-d tensor otherwise).

    Padded samples (weight 0) contribute nothing; the weighted mean divides
    by the total weight, with the safe denominator ``where(t > 0, t, 1)``:
    an all-padding batch gives loss 0 with exactly-zero gradients.
    ``total`` gives that denominator (one per fold) when ``weights`` holds
    only this rank's rows of a batch sharded over a data group.
    """
    l = torch.logaddexp(logits, torch.zeros_like(logits)) - y * logits
    if weights is None:
        return torch.mean(l, dim=-1)
    t = torch.sum(weights, dim=-1) if total is None else total
    return torch.sum(l * weights, dim=-1) / torch.where(t > 0, t, 1.0)
