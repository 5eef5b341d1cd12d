"""ResNet-18 and ResNet-50 as published (He et al. 2015, arXiv:1512.03385,
Table 1; torchvision's v1.5 layout: the stride of a bottleneck sits on its
3x3 convolution), in plain PyTorch over NCHW float32.

Parameters are a flat dict under torchvision's state_dict names
(``layer1.0.conv1.weight``, ``layer1.0.bn1.running_mean``, ...). The
network has no classifier: the embedding is the global average pool, as
the MIL fine-tune uses it. Batch norm is ``F.batch_norm``: batch
statistics in training (the biased variance normalizes, the unbiased one
enters the running average, momentum 0.1), the running statistics in
evaluation. A network's table (its block, blocks per stage, widths and
expansion) is its configuration's ``architecture`` block, taken by
``register``: the configuration file is its one source.
"""
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


class Arch(NamedTuple):
    block: str  # "basic" or "bottleneck"
    layers: Tuple[int, ...]  # blocks per stage
    expansion: int
    embedding: int
    widths: Tuple[int, ...]  # each stage's width; the stem's is the first


# backbone name -> its table, as a configuration's ``architecture`` gives it
ARCHS: Dict[str, Arch] = {}


def register(name: str, architecture: Dict) -> Arch:
    """Take a configuration's ``architecture`` block as ``name``'s table."""
    a = Arch(architecture["block"], tuple(architecture["stage_blocks"]),
             int(architecture["expansion"]), int(architecture["embedding_dim"]),
             tuple(architecture["stage_widths"]))
    if a.embedding != a.widths[-1] * a.expansion:
        raise ValueError(f"{name}: embedding_dim {a.embedding} is not the last stage's width")
    ARCHS[name] = a
    return a


class Conv(NamedTuple):
    name: str  # the weight's key without ".weight"
    bn: str  # the batch norm that follows it
    cin: int
    cout: int
    k: int
    stride: int
    pad: int


def emb_dim(arch: str) -> int:
    return ARCHS[arch].embedding


def convs(arch: str) -> List[Conv]:
    """Every convolution of the network, in forward order."""
    block, layers, exp, _, widths = ARCHS[arch]
    out = [Conv("conv1", "bn1", 3, widths[0], 7, 2, 3)]
    cin = widths[0]
    for li, (n, width) in enumerate(zip(layers, widths), 1):
        for bi in range(n):
            stride = 2 if (li > 1 and bi == 0) else 1
            pre = f"layer{li}.{bi}"
            if block == "basic":
                shapes = [(cin, width, 3, stride), (width, width, 3, 1)]
                cout = width
            else:
                shapes = [(cin, width, 1, 1), (width, width, 3, stride), (width, width * exp, 1, 1)]
                cout = width * exp
            for ci, (a, b, k, s) in enumerate(shapes, 1):
                out.append(Conv(f"{pre}.conv{ci}", f"{pre}.bn{ci}", a, b, k, s, k // 2))
            if stride != 1 or cin != cout:
                out.append(Conv(f"{pre}.downsample.0", f"{pre}.downsample.1", cin, cout, 1,
                                stride, 0))
            cin = cout
    return out


def conv_out(size: int, c: Conv) -> int:
    return (size + 2 * c.pad - c.k) // c.stride + 1


def _bn(x, p, name, train, momentum, stats):
    mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    if train:
        mean, var = mean.clone(), var.clone()  # F.batch_norm moves them in place
    y = F.batch_norm(x, mean, var, p[f"{name}.weight"], p[f"{name}.bias"], training=train,
                     momentum=momentum, eps=BN_EPS)
    if train:
        stats[f"{name}.running_mean"], stats[f"{name}.running_var"] = mean, var
    return y


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, arch: str, train: bool,
            momentum: float = 0.1):
    """x [N, 3, H, W] -> (embeddings [N, emb], the running statistics after
    this batch: a dict of the ``running_*`` keys, empty in evaluation)."""
    block = ARCHS[arch].block
    stats: Dict[str, torch.Tensor] = {}
    table = {c.name: c for c in convs(arch)}

    def conv_bn(h, name):
        c = table[name]
        h = F.conv2d(h, p[f"{name}.weight"], stride=c.stride, padding=c.pad)
        return _bn(h, p, c.bn, train, momentum, stats)

    h = F.max_pool2d(torch.relu(conv_bn(x, "conv1")), 3, stride=2, padding=1)
    layers = ARCHS[arch].layers
    for li, n in enumerate(layers, 1):
        for bi in range(n):
            pre = f"layer{li}.{bi}"
            n_convs = 2 if block == "basic" else 3
            y = h
            for ci in range(1, n_convs + 1):
                y = conv_bn(y, f"{pre}.conv{ci}")
                if ci < n_convs:
                    y = torch.relu(y)
            identity = conv_bn(h, f"{pre}.downsample.0") if f"{pre}.downsample.0" in table else h
            h = torch.relu(y + identity)
    return h.mean(dim=(2, 3)), stats


def trainable(arch: str) -> List[str]:
    """The names of the trainable leaves: conv weights, BN weight and bias."""
    names = []
    for c in convs(arch):
        names += [f"{c.name}.weight", f"{c.bn}.weight", f"{c.bn}.bias"]
    return names


def running(arch: str) -> List[str]:
    names = []
    for c in convs(arch):
        names += [f"{c.bn}.running_mean", f"{c.bn}.running_var"]
    return names
