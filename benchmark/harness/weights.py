"""Weights made from the seed on the device, in a few large calls, and the
program's parameter layout.

The benchmark's weights are flat dicts: the backbone under torchvision's
names (``reference/resnet.py``), the head under ``<layer>.w`` ([in, out])
and ``<layer>.b``. The backbone is the published initialisation: He-normal
convolutions (fan-out), batch norm at identity. The head's linears are
uniform in +-1/sqrt(fan_in). ``to_program_*`` / ``from_program_*`` carry
them into and out of the program's nested trees (``pd_fusion_torch``'s
``nn/resnet.py`` and ``nn/mil.py`` layouts), without copies.
"""
import math
from typing import Dict

import torch

from benchmark.reference import resnet
from benchmark.reference.mil_ft import HEAD_LINEARS


def backbone(arch: str, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    table = resnet.convs(arch)
    sizes = [c.cout * c.cin * c.k * c.k for c in table]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    widths = [c.cout for c in table]
    ones = torch.split(torch.ones(2 * sum(widths), device=device), widths * 2)
    zeros = torch.split(torch.zeros(2 * sum(widths), device=device), widths * 2)
    out = {}
    for i, (c, part) in enumerate(zip(table, torch.split(flat, sizes))):
        std = math.sqrt(2.0 / (c.k * c.k * c.cout))
        out[f"{c.name}.weight"] = part.view(c.cout, c.cin, c.k, c.k) * std
        out[f"{c.bn}.weight"], out[f"{c.bn}.running_var"] = ones[i], ones[len(table) + i]
        out[f"{c.bn}.bias"], out[f"{c.bn}.running_mean"] = zeros[i], zeros[len(table) + i]
    return out


def head_shapes(D: int, H: int, A: int):
    return {"instance": (D, H), "attn_v": (H, A), "attn_u": (H, A), "attn_w": (A, 1),
            "classifier": (H, 1)}


def head(D: int, H: int, A: int, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    shapes = head_shapes(D, H, A)
    sizes = []
    for name in HEAD_LINEARS:
        i, o = shapes[name]
        sizes += [i * o, o]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    parts = iter(torch.split(flat, sizes))
    out = {}
    for name in HEAD_LINEARS:
        i, o = shapes[name]
        bound = 1.0 / math.sqrt(i)
        out[f"{name}.w"] = next(parts).view(i, o) * bound
        out[f"{name}.b"] = next(parts) * bound
    return out


_BN = {"weight": "gamma", "bias": "beta", "running_mean": "mean", "running_var": "var"}


def to_program_backbone(named: Dict, arch: str) -> Dict:
    """Flat torchvision-named dict -> the program's nested tree."""
    def bn(prefix):
        return {v: named[f"{prefix}.{k}"] for k, v in _BN.items()}

    block, layers = resnet.ARCHS[arch].block, resnet.ARCHS[arch].layers
    n_convs = 2 if block == "basic" else 3
    tree = {"conv1": {"w": named["conv1.weight"]}, "bn1": bn("bn1")}
    for li, n in enumerate(layers, 1):
        blocks = []
        for bi in range(n):
            pre = f"layer{li}.{bi}"
            b = {}
            for ci in range(1, n_convs + 1):
                b[f"conv{ci}"] = {"w": named[f"{pre}.conv{ci}.weight"]}
                b[f"bn{ci}"] = bn(f"{pre}.bn{ci}")
            if f"{pre}.downsample.0.weight" in named:
                b["downsample"] = {"conv": {"w": named[f"{pre}.downsample.0.weight"]},
                                   "bn": bn(f"{pre}.downsample.1")}
            blocks.append(b)
        tree[f"layer{li}"] = blocks
    return tree


def from_program_backbone(tree: Dict, arch: str) -> Dict:
    """The program's nested tree -> the flat torchvision-named dict."""
    names = {k: k for k in resnet.trainable(arch) + resnet.running(arch)}
    out = {}

    def walk(t, n):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], n[k])
        elif isinstance(t, (list, tuple)):
            for a, b in zip(t, n):
                walk(a, b)
        else:
            out[n] = t

    walk(tree, to_program_backbone(names, arch))
    return out


def to_program_head(named: Dict) -> Dict:
    return {name: {"w": named[f"{name}.w"], "b": named[f"{name}.b"]} for name in HEAD_LINEARS}


def from_program_head(tree: Dict) -> Dict:
    return {f"{name}.{k}": tree[name][k] for name in HEAD_LINEARS for k in ("w", "b")}
