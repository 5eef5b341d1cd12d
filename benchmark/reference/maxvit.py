"""MaxViT as published (Tu et al. 2022, arXiv:2204.01697, section 3; the
layout of torchvision's ``maxvit_t``), in plain PyTorch over NCHW float32.

Parameters are a flat dict under torchvision's state_dict names
(``stem.0.0.weight``, ``blocks.0.layers.1.layers.MBconv.layers.conv_b.0.
weight``, ``blocks.2.layers.0.layers.grid_attention.attn_layer.1.to_qkv.
weight``, ...; the classifier's LayerNorm ``classifier.2``). The stem is a
3x3/2 convolution, BN and GELU, then a 3x3 convolution with bias. A block
is an MBConv (pre-norm BN; a 1x1 expansion by 4, BN, GELU; a 3x3
depthwise convolution, ``F.conv2d(groups=)``, carrying the block's
stride, BN, GELU; squeeze-excitation at a quarter of the block's width
with SiLU and a sigmoid gate; a 1x1 projection with bias; the shortcut
pooled 3x3/2 and projected 1x1 where the block changes width or stride),
then block attention and grid attention, each ``x + attn(LN(x))`` and
``x + MLP(LN(x))`` (ratio 4, exact GELU) over groups of P x P tokens:
torchvision's window partition and, for the grid, the same partition at
``H / P`` with its two token axes swapped. The relative position bias is
gathered from its table by index. Batch norm is ``F.batch_norm``: batch
statistics in training (the biased variance normalizes, the unbiased one
enters the running average), the running statistics in evaluation. The
embedding is the last stage's mean over the map, then the classifier's
LayerNorm. A network's table is its configuration's ``architecture``
block (``arch_from``).

Where this departs from torchvision's module, as the program does: the
attention scale is ``head_dim^-0.5`` (the paper's; torchvision's is the
layer width's ``C^-0.5``); BN momentum 0.1 (torchvision's 0.99 is
TensorFlow's convention); no stochastic depth and no dropout; the
classifier's linears are left out. ``recompute=True`` runs each MBConv
under ``torch.utils.checkpoint`` (a memory trade, the same function) so
that a training step at the fine-tune's size fits on one card.
"""
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


class Arch(NamedTuple):
    stem: int
    widths: Tuple[int, ...]
    depths: Tuple[int, ...]
    head_dim: int
    partition: int
    expansion: int
    squeeze: float
    mlp_ratio: int
    bn_eps: float
    ln_eps: float


def arch_from(architecture: Dict) -> Arch:
    """A configuration's ``architecture`` block -> the table."""
    a = architecture
    return Arch(int(a["stem_width"]), tuple(a["stage_widths"]), tuple(a["stage_blocks"]),
                int(a["head_dim"]), int(a["partition_size"]), int(a["mbconv_expansion"]),
                float(a["squeeze_ratio"]), int(a["mlp_ratio"]), float(a["bn_eps"]),
                float(a["norm_eps"]))


def emb_dim(a: Arch) -> int:
    return a.widths[-1]


def stages(a: Arch, size: int) -> List[Tuple[int, int, int, int]]:
    """(map side, input width, width, blocks) of each stage."""
    res, cin, out = (size + 1) // 2, a.stem, []
    for C, depth in zip(a.widths, a.depths):
        res = (res + 1) // 2
        out.append((res, cin, C, depth))
        cin = C
    return out


def _bn_names(pre: str, c: int, trainable: bool) -> Dict[str, Tuple[int, ...]]:
    keys = ("weight", "bias") if trainable else ("running_mean", "running_var")
    return {f"{pre}.{k}": (c,) for k in keys}


def _shapes(a: Arch, size: int, trainable: bool) -> Dict[str, Tuple[int, ...]]:
    out: Dict[str, Tuple[int, ...]] = {}

    def conv(name, cout, cin, k, bias):
        if trainable:
            out[f"{name}.weight"] = (cout, cin, k, k)
            if bias:
                out[f"{name}.bias"] = (cout,)

    def bn(name, c):
        out.update(_bn_names(name, c, trainable))

    def linear(name, cin, cout):
        if trainable:
            out[f"{name}.weight"], out[f"{name}.bias"] = (cout, cin), (cout,)

    conv("stem.0.0", a.stem, 3, 3, False)
    bn("stem.0.1", a.stem)
    conv("stem.1.0", a.stem, a.stem, 3, True)
    for i, (_, cin, C, depth) in enumerate(stages(a, size)):
        mid, se, heads = C * a.expansion, int(C * a.squeeze), C // a.head_dim
        for j in range(depth):
            c_in = cin if j == 0 else C
            pre = f"blocks.{i}.layers.{j}.layers."
            mb = pre + "MBconv."
            if j == 0:
                conv(mb + "proj.1", C, c_in, 1, True)
            bn(mb + "layers.pre_norm", c_in)
            conv(mb + "layers.conv_a.0", mid, c_in, 1, False)
            bn(mb + "layers.conv_a.1", mid)
            conv(mb + "layers.conv_b.0", mid, 1, 3, False)
            bn(mb + "layers.conv_b.1", mid)
            conv(mb + "layers.squeeze_excitation.fc1", se, mid, 1, True)
            conv(mb + "layers.squeeze_excitation.fc2", mid, se, 1, True)
            conv(mb + "layers.conv_c", C, mid, 1, True)
            for layer in ("window_attention", "grid_attention"):
                L = pre + layer + "."
                if trainable:
                    out[L + "attn_layer.0.weight"], out[L + "attn_layer.0.bias"] = (C,), (C,)
                linear(L + "attn_layer.1.to_qkv", C, 3 * C)
                linear(L + "attn_layer.1.merge", C, C)
                if trainable:
                    out[L + "attn_layer.1.relative_position_bias_table"] = (
                        (2 * a.partition - 1) ** 2, heads)
                    out[L + "mlp_layer.0.weight"], out[L + "mlp_layer.0.bias"] = (C,), (C,)
                linear(L + "mlp_layer.1", C, C * a.mlp_ratio)
                linear(L + "mlp_layer.3", C * a.mlp_ratio, C)
    if trainable:
        C = emb_dim(a)
        out["classifier.2.weight"], out["classifier.2.bias"] = (C,), (C,)
    return out


def param_shapes(a: Arch, size: int = 224) -> Dict[str, Tuple[int, ...]]:
    """Every trainable leaf's name and shape, in torchvision's order."""
    return _shapes(a, size, True)


def running_shapes(a: Arch, size: int = 224) -> Dict[str, Tuple[int, ...]]:
    """Every BN's running statistics."""
    return _shapes(a, size, False)


def relative_position_index(m: int):
    coords = torch.stack(torch.meshgrid(torch.arange(m), torch.arange(m), indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += m - 1
    rel[:, :, 1] += m - 1
    rel[:, :, 0] *= 2 * m - 1
    return rel.sum(-1)


def _bn(x, p, name, a, train, momentum, stats):
    mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    if train:
        mean, var = mean.clone(), var.clone()  # F.batch_norm moves them in place
    y = F.batch_norm(x, mean, var, p[f"{name}.weight"], p[f"{name}.bias"], training=train,
                     momentum=momentum, eps=a.bn_eps)
    if train:
        stats[f"{name}.running_mean"], stats[f"{name}.running_var"] = mean, var
    return y


def mbconv(p, pre, x, stride, a, train, momentum, stats):
    """One MBConv on NCHW ``x``; ``pre`` ends with ``MBconv.``."""
    L = pre + "layers."
    res = x
    if f"{pre}proj.1.weight" in p:
        if stride == 2:
            res = F.avg_pool2d(res, 3, stride=2, padding=1)
        res = F.conv2d(res, p[f"{pre}proj.1.weight"], p[f"{pre}proj.1.bias"])
    h = _bn(x, p, L + "pre_norm", a, train, momentum, stats)
    h = F.gelu(_bn(F.conv2d(h, p[L + "conv_a.0.weight"]), p, L + "conv_a.1", a, train, momentum,
                   stats))
    h = F.conv2d(h, p[L + "conv_b.0.weight"], stride=stride, padding=1, groups=h.shape[1])
    h = F.gelu(_bn(h, p, L + "conv_b.1", a, train, momentum, stats))
    se = L + "squeeze_excitation."
    s = F.adaptive_avg_pool2d(h, 1)
    s = F.silu(F.conv2d(s, p[se + "fc1.weight"], p[se + "fc1.bias"]))
    s = torch.sigmoid(F.conv2d(s, p[se + "fc2.weight"], p[se + "fc2.bias"]))
    h = F.conv2d(h * s, p[L + "conv_c.weight"], p[L + "conv_c.bias"])
    return res + h


def _ln(x, p, name, eps):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], eps)


def attention(p, pre, x, heads: int, m: int):
    """Relative-position multi-head attention of ``x`` [B, G, N, C]."""
    B, G, N, C = x.shape
    d = C // heads
    q, k, v = torch.chunk(F.linear(x, p[pre + "to_qkv.weight"], p[pre + "to_qkv.bias"]), 3, -1)
    q, k, v = (t.reshape(B, G, N, heads, d).permute(0, 1, 3, 2, 4) for t in (q, k, v))
    dot = (q * d ** -0.5) @ k.transpose(-2, -1)
    idx = relative_position_index(m).to(x.device)
    bias = p[pre + "relative_position_bias_table"][idx.view(-1)].view(N, N, -1)
    attn = torch.softmax(dot + bias.permute(2, 0, 1).unsqueeze(0).unsqueeze(0), dim=-1)
    out = (attn @ v).permute(0, 1, 3, 2, 4).reshape(B, G, N, C)
    return F.linear(out, p[pre + "merge.weight"], p[pre + "merge.bias"])


def partition_attention(p, pre, x, a: Arch, grid: bool):
    """One attention layer on NCHW ``x``: torchvision's window partition
    (at P = the partition size; for the grid at P = H / partition size,
    then the group and token axes swapped), the two residual sub-layers,
    and the partition undone."""
    B, C, H, W = x.shape
    P = H // a.partition if grid else a.partition
    t = x.reshape(B, C, H // P, P, W // P, P).permute(0, 2, 4, 3, 5, 1)
    t = t.reshape(B, (H // P) * (W // P), P * P, C)
    if grid:
        t = t.transpose(-2, -3)
    t = t + attention(p, pre + "attn_layer.1.", _ln(t, p, pre + "attn_layer.0", a.ln_eps),
                      C // a.head_dim, a.partition)
    h = F.gelu(F.linear(_ln(t, p, pre + "mlp_layer.0", a.ln_eps), p[pre + "mlp_layer.1.weight"],
                        p[pre + "mlp_layer.1.bias"]))
    t = t + F.linear(h, p[pre + "mlp_layer.3.weight"], p[pre + "mlp_layer.3.bias"])
    if grid:
        t = t.transpose(-2, -3)
    t = t.reshape(B, H // P, W // P, P, P, C).permute(0, 5, 1, 3, 2, 4)
    return t.reshape(B, C, H, W)


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, a: Arch, train: bool,
            momentum: float = 0.1, recompute: bool = False):
    """x [N, 3, H, W] -> (embeddings [N, emb], the running statistics after
    this batch: a dict of the ``running_*`` keys, empty in evaluation)."""
    stats: Dict[str, torch.Tensor] = {}
    h = F.conv2d(x, p["stem.0.0.weight"], stride=2, padding=1)
    h = F.gelu(_bn(h, p, "stem.0.1", a, train, momentum, stats))
    h = F.conv2d(h, p["stem.1.0.weight"], p["stem.1.0.bias"], padding=1)
    for i, (_, _, _, depth) in enumerate(stages(a, x.shape[-1])):
        for j in range(depth):
            pre = f"blocks.{i}.layers.{j}.layers."
            stride = 2 if j == 0 else 1
            if recompute:
                h = checkpoint(mbconv, p, pre + "MBconv.", h, stride, a, train, momentum, stats,
                               use_reentrant=False)
            else:
                h = mbconv(p, pre + "MBconv.", h, stride, a, train, momentum, stats)
            h = partition_attention(p, pre + "window_attention.", h, a, grid=False)
            h = partition_attention(p, pre + "grid_attention.", h, a, grid=True)
    return _ln(h.mean(dim=(2, 3)), p, "classifier.2", a.ln_eps), stats
