"""The MIL fine-tune on a MaxViT backbone in plain PyTorch, float32: the same
augmentation, resize, gated attention head, focal loss and clipped
two-group Adam with weight decay as ``reference/mil_ft.py`` (whose helpers
it takes), with MaxViT (``reference/maxvit.py``) in place of the ResNet.
As the ResNet's, the backbone has running statistics: a training step
normalizes every BN by the batch's statistics, moves the running averages
once, and decays every trainable leaf (BN scales and shifts included)
but not the running statistics. The training forward recomputes each
MBConv in its backward (``recompute=True``), so that a step of 256 images
of 224^2 fits on one card; the function is the same.
"""
import numpy as np
import torch

from benchmark.reference import maxvit
from benchmark.reference.mil_ft import (_stats_tensors, adam_state, augment, focal_loss,
                                        head_forward, imagenet_batch, opt_step)


def loss_and_grads(bp, hp, batch, hy, a: maxvit.Arch):
    """One training batch (``batch`` as ``mil_ft.loss_and_grads`` takes it)
    -> (loss, {name: gradient} of every trainable leaf of both groups, the
    running statistics after the batch)."""
    names = list(maxvit.param_shapes(a, hy["input_size"]))
    leaves = {k: bp[k].detach().requires_grad_(True) for k in names}
    hl = {k: v.detach().requires_grad_(True) for k, v in hp.items()}
    p = dict(bp, **leaves)
    B, L = batch["slices"].shape[:2]
    mean, std = _stats_tensors(hy, batch["slices"].device)
    with torch.no_grad():
        x = augment(batch["slices"], batch)
        x = imagenet_batch(x.reshape(B * L, *x.shape[2:]), hy["input_size"], mean, std)
    emb, stats = maxvit.forward(p, x, a, train=True, recompute=True)
    logits = head_forward(hl, emb.reshape(B, L, -1), batch["mask"], hy["dropout"], batch["keep"])
    loss = focal_loss(logits, batch["y"], batch["valid"], hy["gamma"], hy["alpha"])
    keys = list(leaves) + list(hl)
    grads = torch.autograd.grad(loss, list(leaves.values()) + list(hl.values()))
    return loss.detach(), dict(zip(keys, grads)), {k: v.detach() for k, v in stats.items()}


def train_steps(bp, hp, batches, hy, a: maxvit.Arch):
    """Follow ``batches`` from ``bp`` (backbone, with its running
    statistics) and ``hp`` (head) -> a record per step: ``loss``, ``grads``
    (raw), ``taken`` (as Adam took it), and the parameters after it
    (``backbone``, ``head``)."""
    names = list(maxvit.param_shapes(a, hy["input_size"]))
    bp, hp = dict(bp), dict(hp)
    state = {"backbone": adam_state(names, bp), "head": adam_state(list(hp), hp)}
    out = []
    for batch in batches:
        loss, grads, stats = loss_and_grads(bp, hp, batch, hy, a)
        with torch.no_grad():
            new, taken = opt_step(bp, hp, grads, state, hy)
        bp = dict(bp, **{k: new[k] for k in names}, **stats)
        hp = {k: new[k] for k in hp}
        out.append({"loss": loss, "grads": grads, "taken": taken, "backbone": bp, "head": hp})
    return out


@torch.no_grad()
def predict(bp, hp, bags, rng_draws, hy, a: maxvit.Arch, chunk: int, tta: int):
    """Eval-mode TTA predict of ``bags`` (a list of [L, h, w] tensors),
    ``chunk`` bags at a time; ``rng_draws(B, L, h, w)`` gives each pass's
    draws. -> float32 numpy probabilities, the passes' mean."""
    mean, std = _stats_tensors(hy, bags[0].device)
    out = []
    for s in range(0, len(bags), chunk):
        X = torch.stack(bags[s:s + chunk])
        B, L, h, w = X.shape
        mask = torch.ones(B, L, device=X.device)
        acc = np.zeros(B, np.float32)
        for _ in range(tta):
            x = augment(X, rng_draws(B, L, h, w))
            x = imagenet_batch(x.reshape(B * L, h, w), hy["input_size"], mean, std)
            emb, _ = maxvit.forward(bp, x, a, train=False)
            acc += torch.sigmoid(head_forward(hp, emb.reshape(B, L, -1), mask)).cpu().numpy()
        out.append(acc / np.float32(tta))
    return np.concatenate(out)
