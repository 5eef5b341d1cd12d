"""The MIL fine-tune's frozen step (gate 0) in plain PyTorch, float32: the
backbone runs its train-mode forward outside autograd, so its batch norms
normalize with the batch's statistics and move their running statistics,
while its weights take no gradient, no decay and no update; the loss's
gradient reaches the head alone, which is clipped by its own global norm,
decayed and stepped by Adam. The helpers are ``reference/mil_ft.py``'s.
"""
import torch

from benchmark.reference import resnet
from benchmark.reference.mil_ft import (_stats_tensors, adam_state, augment, focal_loss,
                                        head_forward, imagenet_batch, opt_step)


def train_steps(bp, hp, batches, hy):
    """Follow ``batches`` from ``bp`` (backbone, with its running
    statistics) and ``hp`` (head) with the backbone frozen -> a record per
    step: ``loss``, ``grads`` and ``taken`` (the head's), and the parameters
    after it (``backbone``: the same weights, the new running statistics;
    ``head``)."""
    bp, hp = dict(bp), dict(hp)
    state = {"backbone": adam_state([], bp), "head": adam_state(list(hp), hp)}
    out = []
    for batch in batches:
        hl = {k: v.detach().requires_grad_(True) for k, v in hp.items()}
        B, L = batch["slices"].shape[:2]
        mean, std = _stats_tensors(hy, batch["slices"].device)
        with torch.no_grad():
            x = augment(batch["slices"], batch)
            x = imagenet_batch(x.reshape(B * L, *x.shape[2:]), hy["input_size"], mean, std)
            emb, stats = resnet.forward(bp, x, hy["arch"], train=True)
        logits = head_forward(hl, emb.reshape(B, L, -1), batch["mask"], hy["dropout"],
                              batch["keep"])
        loss = focal_loss(logits, batch["y"], batch["valid"], hy["gamma"], hy["alpha"])
        grads = dict(zip(hl, torch.autograd.grad(loss, list(hl.values()))))
        with torch.no_grad():
            new, taken = opt_step({}, hp, grads, state, hy)
        bp = dict(bp, **stats)
        hp = {k: new[k] for k in hp}
        out.append({"loss": loss.detach(), "grads": grads, "taken": taken, "backbone": bp,
                    "head": hp})
    return out
