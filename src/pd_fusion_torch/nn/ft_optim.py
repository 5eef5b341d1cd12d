"""The MIL fine-tune's optimizer: two Adam groups behind one clip and one
weight decay (port of ``pd_fusion/models/mil_attention_finetune.py::
_build_tx`` and the update of ``_ft_update``).

The JAX chain, term for term:

1. the backbone's gradients are multiplied by the 0/1 freeze gate;
2. ``optax.clip_by_global_norm(max_grad_norm)`` over both groups'
   gradients (when ``max_grad_norm`` is set);
3. ``optax.add_decayed_weights(wd, mask=bn_buffer_mask)`` (when ``wd >
   0``), with the backbone's weights also multiplied by the gate, so a
   frozen backbone's decay is exactly 0;
4. ``optax.multi_transform`` of ``adam(lr_backbone)`` over the backbone and
   ``adam(lr)`` over the head: betas (0.9, 0.999), eps 1e-8 outside the
   square root, bias correction by each group's step count.

The BN running statistics are left out here: their gradient is 0, so the
JAX chain moves them by exactly 0 before ``merge_bn_stats`` overwrites
them. Every step counts in both groups, frozen steps too (optax's backbone
Adam sees a zero gradient then, so its bias correction after the gate
opens uses the total count); ``torch.optim.Adam`` would skip a parameter
with no gradient, so the step is written here. A frozen step may pass
``None`` for the backbone's gradients (the backward pass stopped at the
head): that is the zero gradient. The update is functional: new tensors,
the old ones untouched. ``adam_update`` alone is also the CNN3D trainer's
optax ``adam`` (``nn/cnn3d.py``).
"""
from typing import Dict, List, Optional, Sequence

import torch

from pd_fusion_torch.nn.mil import _clip_by_global_norm

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def init_group(leaves: Sequence[torch.Tensor]) -> Dict:
    """One Adam group's state: step count and both moments, zero."""
    return {"count": 0, "mu": [torch.zeros_like(t) for t in leaves],
            "nu": [torch.zeros_like(t) for t in leaves]}


def adam_update(params: List[torch.Tensor], updates: Optional[List[torch.Tensor]], state: Dict,
          lr: float) -> List[torch.Tensor]:
    """optax ``adam``: the moments (in place in ``state``), then ``params -
    lr * mu_hat / (sqrt(nu_hat) + eps)``; ``updates=None`` is a zero update."""
    mu, nu = state["mu"], state["nu"]
    state["count"] += 1
    torch._foreach_mul_(mu, BETA1)
    torch._foreach_mul_(nu, BETA2)
    if updates is not None:
        torch._foreach_add_(mu, updates, alpha=1.0 - BETA1)
        torch._foreach_addcmul_(nu, updates, updates, value=1.0 - BETA2)
    mu_hat = torch._foreach_div(mu, 1.0 - BETA1 ** state["count"])
    denom = torch._foreach_div(nu, 1.0 - BETA2 ** state["count"])
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    torch._foreach_div_(mu_hat, denom)
    torch._foreach_mul_(mu_hat, -lr)
    return torch._foreach_add(params, mu_hat)


def ft_update(backbone: List[torch.Tensor], head: List[torch.Tensor],
              g_backbone: Optional[List[torch.Tensor]], g_head: List[torch.Tensor],
              state: Dict, gate: float, lr_backbone: float, lr: float, weight_decay: float,
              max_grad_norm: Optional[float]):
    """One step over the trainable leaves (BN statistics excluded) of both
    groups. ``state`` is ``{"backbone": group, "head": group}`` and is
    updated in place. -> (new backbone leaves, new head leaves)."""
    gate = float(gate)
    g_b = None if (g_backbone is None or gate == 0.0) else [g * gate for g in g_backbone]
    g_h = list(g_head)
    if max_grad_norm:
        grads = (g_b or []) + g_h
        clipped = _clip_by_global_norm(grads, float(max_grad_norm))
        g_b, g_h = (clipped[:len(g_b)] if g_b is not None else None), clipped[-len(g_h):]
    if weight_decay > 0:
        g_h = torch._foreach_add(g_h, head, alpha=weight_decay)
        if g_b is not None:
            g_b = torch._foreach_add(g_b, [p * gate for p in backbone], alpha=weight_decay)
    return (adam_update(backbone, g_b, state["backbone"], lr_backbone),
            adam_update(head, g_h, state["head"], lr))
