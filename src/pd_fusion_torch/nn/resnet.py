"""Functional ResNet-18/50, inference half (port of ``pd_fusion/nn/resnet.py``).

Parameters are nested dicts that mirror torchvision's state_dict names, as
the JAX package's pytree does, but conv weights are OIHW (torch's layout;
the JAX package keeps HWIO). ``params_from_jax`` carries a JAX pytree over,
so both packages compute the same function in the tests;
``convert_torch_state_dict`` reads torchvision-named weights.

Inputs are NHWC ``[N, H, W, 3]`` as in the JAX package;
``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is an NCHW tensor in
channels-last memory, the layout cuDNN prefers on the card, so no copy is
made. Convolutions pad symmetrically by ``k // 2`` (the stem 7x7/s2 by 3);
the max pool is 3x3/s2 with padding 1 and a -inf pad value
(``F.max_pool2d``'s own).

Precision: ``utils/device.py`` turns TF32 off, so float32 stays float32.
For bfloat16 the caller folds BN in float32 and then casts the folded
weights and the input (``imaging/pipeline.py``), as the JAX package does.

With no weights file, ``load_backbone`` gives a seeded He-normal init
(``pretrained: false``). It never asks torchvision for weights: that
would download them. The seeded init draws from a torch generator, so it
differs from the JAX package's random backbone of the same seed.

Training-mode BN (``resnet_apply_train``, ``_bn_train``,
``merge_bn_stats``, ``bn_buffer_mask``) comes with the MIL fine-tune
(ROADMAP Queue 1 item 11).
"""
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_CONFIGS = {
    "resnet18": {"block": "basic", "layers": [2, 2, 2, 2], "expansion": 1, "emb_dim": 512},
    "resnet50": {"block": "bottleneck", "layers": [3, 4, 6, 3], "expansion": 4, "emb_dim": 2048},
}
BN_EPS = 1e-5


def emb_dim(arch: str) -> int:
    return _CONFIGS[arch]["emb_dim"]


def _n_convs(arch: str) -> int:
    return 2 if _CONFIGS[arch]["block"] == "basic" else 3


def _conv(x, w, b=None, stride=1, padding=None):
    """Conv with torch's symmetric ``k // 2`` padding; the input is cast to
    the weights' dtype (bfloat16 activations under bfloat16 weights)."""
    if padding is None:
        padding = w.shape[2] // 2
    return F.conv2d(x.to(w.dtype), w, b, stride=stride, padding=padding)


def _bn(x, p):
    inv = torch.rsqrt(p["var"] + BN_EPS)
    return ((x - p["mean"][:, None, None]) * (inv * p["gamma"])[:, None, None]
            + p["beta"][:, None, None])


def _he_conv(gen, cout, cin, kh, kw):
    std = math.sqrt(2.0 / (kh * kw * cout))  # torch's kaiming fan_out mode for resnet convs
    return torch.randn(cout, cin, kh, kw, generator=gen) * std


def _bn_init(c):
    return {"gamma": torch.ones(c), "beta": torch.zeros(c), "mean": torch.zeros(c),
            "var": torch.ones(c)}


def init_resnet(gen: torch.Generator, arch: str = "resnet18") -> Dict[str, Any]:
    """Seeded He-normal init (CPU tensors), BN at identity."""
    cfg = _CONFIGS[arch]
    exp = cfg["expansion"]
    params: Dict[str, Any] = {"conv1": {"w": _he_conv(gen, 64, 3, 7, 7)}, "bn1": _bn_init(64)}
    cin = 64
    for li, (n_blocks, cout) in enumerate(zip(cfg["layers"], [64, 128, 256, 512])):
        blocks = []
        for bi in range(n_blocks):
            stride = 2 if (li > 0 and bi == 0) else 1
            if cfg["block"] == "basic":
                shapes = [(cout, cin, 3, 3), (cout, cout, 3, 3)]
                out_c = cout
            else:
                shapes = [(cout, cin, 1, 1), (cout, cout, 3, 3), (cout * exp, cout, 1, 1)]
                out_c = cout * exp
            block: Dict[str, Any] = {}
            for ci, shape in enumerate(shapes, 1):
                block[f"conv{ci}"] = {"w": _he_conv(gen, *shape)}
                block[f"bn{ci}"] = _bn_init(shape[0])
            if stride != 1 or cin != out_c:
                block["downsample"] = {"conv": {"w": _he_conv(gen, out_c, cin, 1, 1)},
                                       "bn": _bn_init(out_c)}
            blocks.append(block)
            cin = out_c
        params[f"layer{li + 1}"] = blocks
    return params


def _map(tree, fn, key=None):
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, key) for v in tree]
    return fn(key, tree)


def params_to(params, device=None, dtype=None):
    """Every tensor of a (raw or folded) parameter tree moved and/or cast."""
    return _map(params, lambda _, t: t.to(device=device, dtype=dtype))


def params_from_jax(jax_params) -> Dict[str, Any]:
    """A JAX ResNet pytree (raw, or folded by ``fold_bn_inference``), its
    leaves as numpy or JAX arrays -> the port's tree: HWIO conv weights
    become OIHW float32 tensors, everything else float32 tensors."""
    def leaf(key, a):
        a = np.asarray(a, np.float32)
        if key == "w" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.array(a, np.float32, order="C"))  # a writable copy

    return _map(jax_params, leaf)


def _stem(x, conv1, bias=None, bn=None):
    out = _conv(x, conv1, bias, stride=2, padding=3)
    out = torch.relu(_bn(out, bn) if bn is not None else out)
    return F.max_pool2d(out, 3, stride=2, padding=1)


def _nchw(x):
    """NHWC [N, H, W, 3] -> NCHW view (channels-last memory, no copy)."""
    return x.permute(0, 3, 1, 2)


def resnet_apply(params, x, arch: str = "resnet18", train: bool = False):
    """x [N, H, W, 3] -> embeddings [N, emb_dim] (global-average-pooled;
    no classifier, as torchvision's with ``fc = Identity``). Inference BN
    from the running statistics."""
    if train:
        raise NotImplementedError(
            "train-mode BN is not ported yet (ROADMAP Queue 1 item 11, the MIL fine-tune)")
    basic = _CONFIGS[arch]["block"] == "basic"
    out = _stem(_nchw(x), params["conv1"]["w"], bn=params["bn1"])
    for li in range(4):
        for bi, p in enumerate(params[f"layer{li + 1}"]):
            stride = 2 if (li > 0 and bi == 0) else 1
            identity = out
            if basic:
                h = torch.relu(_bn(_conv(out, p["conv1"]["w"], stride=stride), p["bn1"]))
                h = _bn(_conv(h, p["conv2"]["w"]), p["bn2"])
            else:
                h = torch.relu(_bn(_conv(out, p["conv1"]["w"]), p["bn1"]))
                h = torch.relu(_bn(_conv(h, p["conv2"]["w"], stride=stride), p["bn2"]))
                h = _bn(_conv(h, p["conv3"]["w"]), p["bn3"])
            if "downsample" in p:
                identity = _bn(_conv(out, p["downsample"]["conv"]["w"], stride=stride),
                               p["downsample"]["bn"])
            out = torch.relu(h + identity)
    return torch.mean(out, dim=(2, 3))


def _fold_pair(conv_p, bn_p):
    """Exact fold of an inference BN into its conv: ``(conv(x, w) - mean) *
    rsqrt(var + eps) * gamma + beta == conv(x, w * s) + (beta - mean * s)``
    with ``s = gamma * rsqrt(var + eps)``, s on the output channels (O of
    OIHW)."""
    s = bn_p["gamma"] * torch.rsqrt(bn_p["var"] + BN_EPS)
    return {"w": conv_p["w"] * s[:, None, None, None], "b": bn_p["beta"] - bn_p["mean"] * s}


def fold_bn_inference(params, arch: str = "resnet18"):
    """Every BN folded into the conv before it -> a conv-and-bias tree for
    ``resnet_apply_folded``."""
    n_convs = _n_convs(arch)
    folded = {"conv1": _fold_pair(params["conv1"], params["bn1"])}
    for li in range(4):
        blocks = []
        for block in params[f"layer{li + 1}"]:
            fb = {f"conv{ci}": _fold_pair(block[f"conv{ci}"], block[f"bn{ci}"])
                  for ci in range(1, n_convs + 1)}
            if "downsample" in block:
                fb["downsample"] = _fold_pair(block["downsample"]["conv"], block["downsample"]["bn"])
            blocks.append(fb)
        folded[f"layer{li + 1}"] = blocks
    return folded


def resnet_apply_folded(folded, x, arch: str = "resnet18"):
    """Inference forward over a BN-folded tree (``fold_bn_inference``):
    equals ``resnet_apply(params, x)`` to float32 rounding. x [N, H, W, 3]
    -> [N, emb_dim], in the dtype of the folded weights."""
    basic = _CONFIGS[arch]["block"] == "basic"
    out = _stem(_nchw(x), folded["conv1"]["w"], folded["conv1"]["b"])
    for li in range(4):
        for bi, p in enumerate(folded[f"layer{li + 1}"]):
            stride = 2 if (li > 0 and bi == 0) else 1
            identity = out
            if basic:
                h = torch.relu(_conv(out, p["conv1"]["w"], p["conv1"]["b"], stride=stride))
                h = _conv(h, p["conv2"]["w"], p["conv2"]["b"])
            else:
                h = torch.relu(_conv(out, p["conv1"]["w"], p["conv1"]["b"]))
                h = torch.relu(_conv(h, p["conv2"]["w"], p["conv2"]["b"], stride=stride))
                h = _conv(h, p["conv3"]["w"], p["conv3"]["b"])
            if "downsample" in p:
                identity = _conv(out, p["downsample"]["w"], p["downsample"]["b"], stride=stride)
            out = torch.relu(h + identity)
    return torch.mean(out, dim=(2, 3))


def convert_torch_state_dict(sd: Dict[str, Any], arch: str = "resnet18") -> Dict[str, Any]:
    """A torchvision-named ResNet state_dict (tensors or numpy arrays) ->
    the port's tree, float32 CPU tensors, conv weights OIHW as given."""
    def arr(name):
        v = sd[name]
        a = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        return torch.from_numpy(np.array(a, np.float32, order="C"))  # a writable copy

    def bn_p(prefix):
        return {"gamma": arr(f"{prefix}.weight"), "beta": arr(f"{prefix}.bias"),
                "mean": arr(f"{prefix}.running_mean"), "var": arr(f"{prefix}.running_var")}

    cfg = _CONFIGS[arch]
    params: Dict[str, Any] = {"conv1": {"w": arr("conv1.weight")}, "bn1": bn_p("bn1")}
    for li, n_blocks in enumerate(cfg["layers"]):
        blocks = []
        for bi in range(n_blocks):
            pre = f"layer{li + 1}.{bi}"
            block: Dict[str, Any] = {}
            for ci in range(1, _n_convs(arch) + 1):
                block[f"conv{ci}"] = {"w": arr(f"{pre}.conv{ci}.weight")}
                block[f"bn{ci}"] = bn_p(f"{pre}.bn{ci}")
            if f"{pre}.downsample.0.weight" in sd:
                block["downsample"] = {"conv": {"w": arr(f"{pre}.downsample.0.weight")},
                                       "bn": bn_p(f"{pre}.downsample.1")}
            blocks.append(block)
        params[f"layer{li + 1}"] = blocks
    return params


def load_backbone(arch: str = "resnet18", weights_path=None, seed: int = 0):
    """Backbone params (CPU tensors) from a torchvision-named ``.npz`` or
    ``.pth`` (read with ``weights_only=True``; no pickle fallback) when
    ``weights_path`` is given, else the seeded He-normal init. -> (params,
    emb_dim, pretrained)."""
    if weights_path is not None:
        p = str(weights_path)
        if p.endswith(".npz"):
            with np.load(p) as data:
                sd = {k: data[k] for k in data.files}
        else:
            sd = torch.load(p, map_location="cpu", weights_only=True)
        return convert_torch_state_dict(sd, arch), emb_dim(arch), True
    return init_resnet(torch.Generator().manual_seed(int(seed)), arch), emb_dim(arch), False
