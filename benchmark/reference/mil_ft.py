"""The MIL fine-tune in plain PyTorch, float32: train-time augmentation,
the ImageNet resize, the ResNet (``reference/resnet.py``), the gated
attention head, focal loss, the clipped two-group Adam with weight decay,
and the TTA predict.

Written from the method, not from the program: the augmentation is
scipy's ``affine_transform`` convention (output pixel o samples the input
at ``rot @ o + offset``, ``offset = centre - rot @ centre + translate``,
bilinear, 0 wherever a tap or the source lies outside the image), then
``clip(x * scale + shift + noise, 0, 1)``; the resize is
``F.interpolate`` bilinear with half-pixel centres; the head is
Linear-ReLU-dropout, ``tanh(V h) * sigmoid(U h)`` scores, a softmax over
the bag's slices, the weighted pool and a linear classifier (Ilse et al.
2018, arXiv:1802.04712); the loss is focal loss on logits (Lin et al.
2017, arXiv:1708.02002); the optimizer is global-norm clipping, then
decay ``g + wd * p`` on every trainable leaf, then Adam (betas 0.9,
0.999, eps 1e-8) at one rate for the backbone and another for the head.
"""
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import resnet

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8
HEAD_LINEARS = ("instance", "attn_v", "attn_u", "attn_w", "classifier")


def affine(slices, angle_deg, translate):
    """slices [B, L, h, w]; angle [B] in degrees; translate [B, 2] in
    pixels -> each bag's slices rotated about the centre and moved."""
    B, L, h, w = slices.shape
    dev = slices.device
    th = torch.deg2rad(angle_deg.float())
    c, s = torch.cos(th), torch.sin(th)
    ci, cj = h / 2.0, w / 2.0
    off_i = ci - (c * ci - s * cj) + translate[:, 0]
    off_j = cj - (s * ci + c * cj) + translate[:, 1]
    i = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    j = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    src_i = c[:, None, None] * i - s[:, None, None] * j + off_i[:, None, None]
    src_j = s[:, None, None] * i + c[:, None, None] * j + off_j[:, None, None]
    i0, j0 = torch.floor(src_i), torch.floor(src_j)
    ti, tj = (src_i - i0)[:, None], (src_j - j0)[:, None]
    i0, j0 = i0.long(), j0.long()
    flat = slices.reshape(B, L, h * w)

    def tap(a, b):
        ok = ((a >= 0) & (a < h) & (b >= 0) & (b < w))[:, None]
        idx = (a.clamp(0, h - 1) * w + b.clamp(0, w - 1)).reshape(B, 1, h * w).expand(B, L, h * w)
        return torch.where(ok, torch.gather(flat, 2, idx).reshape(B, L, h, w), 0.0)

    out = (tap(i0, j0) * (1 - ti) * (1 - tj) + tap(i0, j0 + 1) * (1 - ti) * tj
           + tap(i0 + 1, j0) * ti * (1 - tj) + tap(i0 + 1, j0 + 1) * ti * tj)
    inside = ((src_i >= 0) & (src_i <= h - 1) & (src_j >= 0) & (src_j <= w - 1))[:, None]
    return torch.where(inside, out, 0.0)


def augment(slices, d):
    """``d``: the draws ``angle`` [B], ``translate`` [B, 2], ``scale``,
    ``shift`` [B], ``noise`` [B, L, h, w] (tensors)."""
    x = affine(slices, d["angle"], d["translate"])
    return torch.clamp(x * d["scale"][:, None, None, None] + d["shift"][:, None, None, None]
                       + d["noise"], 0.0, 1.0)


def imagenet_batch(slices, size: int, mean, std):
    """[N, h, w] in [0, 1] -> [N, 3, size, size], channel-normalized."""
    x = F.interpolate(slices[:, None], size=(size, size), mode="bilinear", align_corners=False)
    x = x.expand(-1, 3, -1, -1)
    return (x - mean.reshape(1, 3, 1, 1)) / std.reshape(1, 3, 1, 1)


def head_forward(hp: Dict[str, torch.Tensor], emb, mask, dropout: float = 0.0, keep=None):
    """emb [B, L, D], mask [B, L] -> logits [B]. ``hp`` holds
    ``<layer>.w`` ([in, out]) and ``<layer>.b``."""
    def lin(name, x):
        return x @ hp[f"{name}.w"] + hp[f"{name}.b"]

    h = torch.relu(lin("instance", emb))
    if keep is not None and dropout > 0:
        h = torch.where(keep, h / (1.0 - dropout), 0.0)
    scores = lin("attn_w", torch.tanh(lin("attn_v", h)) * torch.sigmoid(lin("attn_u", h)))[..., 0]
    a = torch.softmax(torch.where(mask > 0, scores, -1e9), dim=1)
    pooled = torch.sum(a[..., None] * h, dim=1)
    return lin("classifier", pooled)[..., 0]


def focal_loss(logits, y, valid, gamma: float, alpha: float):
    bce = F.softplus(logits) - y * logits
    p = torch.sigmoid(logits)
    pos = y >= 0.5
    pt = torch.where(pos, p, 1 - p)
    a = torch.where(pos, alpha, 1 - alpha)
    n = torch.sum(valid)
    return torch.sum(a * (1 - pt) ** gamma * bce * valid) / torch.where(n > 0, n, 1.0)


def hyper(params: Dict) -> Dict:
    """The settings of a configuration's ``params`` that the math reads."""
    pre = bool(params.get("pretrained", True))
    return {
        "arch": params["backbone"], "input_size": int(params["input_size"]),
        "mean": [0.485, 0.456, 0.406] if pre else [0.5] * 3,
        "std": [0.229, 0.224, 0.225] if pre else [0.5] * 3,
        "dropout": float(params["dropout"]), "gamma": float(params["focal_gamma"]),
        "alpha": float(params["focal_alpha"]), "lr": float(params["lr"]),
        "lr_backbone": float(params["lr_backbone"]),
        "weight_decay": float(params["weight_decay"]),
        "max_grad_norm": float(params["max_grad_norm"]),
    }


def _stats_tensors(hy, device):
    mean = torch.tensor(hy["mean"], dtype=torch.float32, device=device)
    std = torch.tensor(hy["std"], dtype=torch.float32, device=device)
    return mean, std


def loss_and_grads(bp, hp, batch, hy):
    """One training batch: ``batch`` holds ``slices`` [B, L, h, w],
    ``mask`` [B, L], ``y``, ``valid`` [B], the draws and ``keep`` [B, L,
    H]. -> (loss, {name: gradient} of every trainable leaf, the running
    statistics after the batch)."""
    arch = hy["arch"]
    names = resnet.trainable(arch)
    leaves = {k: bp[k].detach().requires_grad_(True) for k in names}
    hl = {k: v.detach().requires_grad_(True) for k, v in hp.items()}
    p = dict(bp, **leaves)
    B, L = batch["slices"].shape[:2]
    mean, std = _stats_tensors(hy, batch["slices"].device)
    with torch.no_grad():
        x = augment(batch["slices"], batch)
        x = imagenet_batch(x.reshape(B * L, *x.shape[2:]), hy["input_size"], mean, std)
    emb, stats = resnet.forward(p, x, arch, train=True)
    logits = head_forward(hl, emb.reshape(B, L, -1), batch["mask"], hy["dropout"], batch["keep"])
    loss = focal_loss(logits, batch["y"], batch["valid"], hy["gamma"], hy["alpha"])
    keys = list(leaves) + list(hl)
    grads = torch.autograd.grad(loss, [leaves[k] for k in leaves] + [hl[k] for k in hl])
    return loss.detach(), dict(zip(keys, grads)), stats


def adam_state(names: List[str], like: Dict[str, torch.Tensor]):
    return {"count": 0, "mu": {k: torch.zeros_like(like[k]) for k in names},
            "nu": {k: torch.zeros_like(like[k]) for k in names}}


def opt_step(bp, hp, grads, state, hy):
    """Clip over both groups, decay, then each group's Adam. -> (new
    backbone trainable leaves, new head leaves, the gradient as Adam took
    it)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.where(norm < hy["max_grad_norm"], 1.0, hy["max_grad_norm"] / norm)
    params = dict(bp, **hp)
    taken = {k: g * scale + hy["weight_decay"] * params[k] for k, g in grads.items()}
    new = {}
    for group, lr in (("backbone", hy["lr_backbone"]), ("head", hy["lr"])):
        st = state[group]
        st["count"] += 1
        t = st["count"]
        for k in st["mu"]:
            st["mu"][k] = BETA1 * st["mu"][k] + (1 - BETA1) * taken[k]
            st["nu"][k] = BETA2 * st["nu"][k] + (1 - BETA2) * taken[k] * taken[k]
            m_hat = st["mu"][k] / (1 - BETA1 ** t)
            v_hat = st["nu"][k] / (1 - BETA2 ** t)
            new[k] = params[k] - lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
    return new, taken


def train_steps(bp, hp, batches, hy):
    """Follow ``batches`` from the parameters ``bp`` (backbone, with its
    running statistics) and ``hp`` (head). -> a record per step: ``loss``,
    ``grads`` (raw), ``taken`` (as Adam took it), and the parameters after
    it (``backbone``, ``head``)."""
    arch = hy["arch"]
    bp, hp = dict(bp), dict(hp)
    state = {"backbone": adam_state(resnet.trainable(arch), bp), "head": adam_state(list(hp), hp)}
    out = []
    for batch in batches:
        loss, grads, stats = loss_and_grads(bp, hp, batch, hy)
        with torch.no_grad():
            new, taken = opt_step(bp, hp, grads, state, hy)
        bp = dict(bp, **{k: new[k] for k in resnet.trainable(arch)}, **stats)
        hp = {k: new[k] for k in hp}
        out.append({"loss": loss, "grads": grads, "taken": taken, "backbone": bp, "head": hp})
    return out


@torch.no_grad()
def predict(bp, hp, bags, rng_draws, hy, chunk: int, tta: int, used=None):
    """Eval-mode TTA predict of ``bags`` (a list of [L, h, w] tensors),
    ``chunk`` bags at a time; ``rng_draws(B, L, h, w)`` gives each pass's
    draws; ``used``: the head pools only each bag's first ``used``
    slices (all by default). -> float32 numpy probabilities, the passes'
    mean."""
    mean, std = _stats_tensors(hy, bags[0].device)
    out = []
    for s in range(0, len(bags), chunk):
        X = torch.stack(bags[s:s + chunk])
        B, L, h, w = X.shape
        mask = torch.ones(B, L, device=X.device)
        if used is not None:
            mask[:, used:] = 0.0
        acc = np.zeros(B, np.float32)
        for _ in range(tta):
            x = augment(X, rng_draws(B, L, h, w))
            x = imagenet_batch(x.reshape(B * L, h, w), hy["input_size"], mean, std)
            emb, _ = resnet.forward(bp, x, hy["arch"], train=False)
            acc += torch.sigmoid(head_forward(hp, emb.reshape(B, L, -1), mask)).cpu().numpy()
        out.append(acc / np.float32(tta))
    return np.concatenate(out)


def bn_stats_from_batch(bp, x, arch):
    """Running statistics set to one batch's statistics (the unbiased
    variance): the state of a network whose running averages have settled."""
    with torch.no_grad():
        _, stats = resnet.forward(bp, x, arch, train=True, momentum=1.0)
    return dict(bp, **stats)
