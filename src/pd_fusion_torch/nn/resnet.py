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

Convolution gradients (the MIL fine-tune's unfrozen step, the only caller
that takes them): every convolution's forward is cuDNN's, but under
autograd ``_conv`` runs it through ``_Conv2d``, whose backward is the
port's own. cuDNN's backward kernels add with float atomics
(``wgrad_alg0_engine``, ``dgrad_engine``): two unfrozen steps from one
state differed by up to 6.9e-05 on an H100, where XLA's TPU convolutions
give the JAX package the same bits on every run, and cuDNN's deterministic
algorithms cost the step 6.4% (PERF.md). So the weight gradient is the
products of the output gradient with the input's windows (``_patches``, a
gather of the zero-padded channels-last input; ``_outer_sum``, batched
products over groups of images summed in a fixed order); the data
gradient of a 1x1 convolution is one product ``g @ w`` (stride 2: written
into every second position), of a stride-1 one the forward convolution of
``g`` with the kernel flipped and its channel axes swapped, of a strided
one ``stride^2`` such convolutions, one per phase of the input positions,
each written into its own positions (``_data_grad``). Each is a cuBLAS
product or a cuDNN forward convolution, neither of which adds with
atomics, so the step gives the same bits on every run; at the fine-tune's
width it is also faster than cuDNN's backward (PERF.md). The stem's input
(the augmented slices) needs no gradient, and ``_Conv2d`` computes none
unless it is asked for. With no gradient wanted (the frozen step, the
embed flushes, inference) ``_conv`` is ``F.conv2d`` alone.

With no weights file, ``load_backbone`` gives a seeded He-normal init
(``pretrained: false``). It never asks torchvision for weights: that
would download them. The seeded init draws from a torch generator, so it
differs from the JAX package's random backbone of the same seed.

Training mode (the MIL fine-tune): ``resnet_apply(train=True)``
normalizes with batch statistics and leaves the running statistics alone;
``resnet_apply_train`` also returns the tree with the running statistics
moved by an EMA (torch ``.train()`` semantics: the biased variance
normalizes, the unbiased one enters the EMA, momentum 0.1), restricted to
the images whose ``sample_weight`` is 1. ``nn.BatchNorm2d`` cannot weight
images, so the train-mode BN, with the residual add and the ReLU that
follow it in a block or the stem, is the port's own autograd Function
(``ops/weighted_bn.py::WeightedBN``): on the card three hand-written
kernel launches forward and three backward, with sums in a fixed order and
no float atomics; on the CPU the same arithmetic in torch ops. With no
gradient wanted (the frozen step) it runs its forward alone. The running
statistics are a functional output: ``merge_bn_stats`` grafts them onto an
optimizer's output, and ``bn_buffer_mask`` marks the leaves that weight
decay may touch.

A training forward keeps its activations for the backward pass, in both
backbones (``nn/swin.py`` follows this rule). The JAX package wraps each
block in ``jax.checkpoint``; the port does not rematerialize: its forward
is deterministic, so a recompute would give the backward the same bits it
keeps, and the fine-tune's unfrozen step (256 images of 224^2) peaks at
22.8 GB on ResNet-50, within one 80 GB card (PERF.md).

Data-parallel training (``resnet_apply_train(group=)``, one process per
card): every BN takes the statistics of the whole group's batch, in torch
ops (``_bn_train_group``: all-reduces stand between the sums and the
normalization, where the fused kernels have none). Each
rank sums ``sum(w * x)`` and its ``sum(w) * H * W``, one all-reduce gives
the global mean, a second the global ``sum(w * (x - mean)^2)``: the two
passes of the one-card formula over the union of the ranks' images. The
all-reduce is ``torch.distributed.nn.functional.all_reduce``, whose
backward all-reduces the gradient, so each rank's backward is its share
of the gradient of the global-statistics BN. The running statistics move
by the global statistics.
"""
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from pd_fusion_torch.ops import weighted_bn

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_CONFIGS = {
    "resnet18": {"block": "basic", "layers": [2, 2, 2, 2], "expansion": 1, "emb_dim": 512},
    "resnet50": {"block": "bottleneck", "layers": [3, 4, 6, 3], "expansion": 4, "emb_dim": 2048},
}
BN_EPS = 1e-5
BN_STATS = ("mean", "var")  # the running-statistic buffers of a BN


def emb_dim(arch: str) -> int:
    return _CONFIGS[arch]["emb_dim"]


def _n_convs(arch: str) -> int:
    return 2 if _CONFIGS[arch]["block"] == "basic" else 3


def _conv(x, w, b=None, stride=1, padding=None):
    """Conv with torch's symmetric ``k // 2`` padding; the input is cast to
    the weights' dtype (bfloat16 activations under bfloat16 weights). Under
    autograd its gradients are the port's own (``_Conv2d``)."""
    if padding is None:
        padding = w.shape[2] // 2
    x = x.to(w.dtype)
    if torch.is_grad_enabled() and (w.requires_grad or x.requires_grad):
        return _Conv2d.apply(x, w, b, stride, padding)
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def _nhwc(t):
    """NCHW -> NHWC view (a channels-last tensor's own memory order)."""
    return t.permute(0, 2, 3, 1)


def _patches(x, kh, kw, stride, padding, out_hw):
    """[N, C, H, W] -> [N, Ho * Wo, kh * kw * C]: every output position's
    window of the zero-padded input, ordered (i, j, c). A view for a 1x1
    stride-1 conv on a channels-last input, else one gather."""
    N, C, H, W = x.shape
    if padding:
        xp = x.new_zeros(N, H + 2 * padding, W + 2 * padding, C)
        xp[:, padding:padding + H, padding:padding + W] = _nhwc(x)
    else:
        xp = _nhwc(x)
    sn, sh, sw, sc = xp.stride()
    cols = xp.as_strided((N, *out_hw, kh, kw, C),
                         (sn, stride * sh, stride * sw, sh, sw, sc), xp.storage_offset())
    return cols.reshape(N, out_hw[0] * out_hw[1], kh * kw * C)


def _outer_sum(a, b):
    """sum over the rows of a [N, P, M] and b [N, P, K] of their outer
    products -> [M, K], as batched products over groups of images summed
    in a fixed order: one product with a K of N * P (up to 802,816 in
    ResNet-50's layer1) would leave most of the card idle, so the images
    are cut into the most groups whose partial outputs stay under 2^22
    elements."""
    N, P, M = a.shape
    K = b.shape[2]
    c = max(d for d in range(1, N + 1) if N % d == 0 and (d == 1 or d * M * K <= 1 << 22))
    a = a.reshape(c, N // c * P, M)
    b = b.reshape(c, N // c * P, K)
    return torch.bmm(a.transpose(1, 2), b).sum(0)


def _phase(r, k, s, p, n_in, n_out):
    """Polyphase split of a strided conv's data gradient along one axis: the
    input positions ``r, r + s, ...`` take taps ``i0, i0 + s, ...`` of the
    kernel. -> (i0, the taps' count, the gradient's padding before and
    after (negative: cropped), the positions' count)."""
    i0 = (r + p) % s
    taps = len(range(i0, k, s))
    before = taps - 1 - (r + p) // s
    count = len(range(r, n_in, s))
    return i0, taps, before, count + taps - 1 - n_out - before, count


def _data_grad(g, w, stride, padding, in_hw):
    """The input gradient of ``conv2d(x, w, stride, padding)`` from the
    output gradient ``g``, written out: a 1x1 conv's is one product ``g @
    w`` (stride 2: written into every second position of a zero tensor); a
    stride-1 conv's is the forward conv of ``g`` with the kernel flipped in
    space and its channel axes swapped; a strided one's splits into
    ``stride^2`` such convs on the output grid, one per phase of the input
    positions, each written into its own positions (a copy, not an add)."""
    N, O, Ho, Wo = g.shape
    C, kh, kw = w.shape[1:]
    s, p = stride, padding
    if kh == kw == 1 and p == 0:
        y = (_nhwc(g).reshape(-1, O) @ w.reshape(O, C)).view(N, Ho, Wo, C)
        if s == 1:
            return y.permute(0, 3, 1, 2)
        gx = g.new_zeros(N, *in_hw, C)
        gx[:, ::s, ::s] = y
        return gx.permute(0, 3, 1, 2)
    wt = w.transpose(0, 1)
    if s == 1 and p < min(kh, kw):
        return F.conv2d(g, wt.flip((2, 3)), padding=(kh - 1 - p, kw - 1 - p))
    gx = g.new_zeros(N, *in_hw, C).permute(0, 3, 1, 2)
    for rh in range(s):
        ih, th, bh, ah, ch = _phase(rh, kh, s, p, in_hw[0], Ho)
        for rw in range(s):
            iw, tw, bw, aw, cw = _phase(rw, kw, s, p, in_hw[1], Wo)
            if not (th and tw and ch and cw):
                continue
            if bh == ah and bw == aw and min(bh, bw) >= 0:
                gp, pad = g, (bh, bw)
            else:
                gp, pad = F.pad(g, (bw, aw, bh, ah)), 0
            gx[:, :, rh::s, rw::s] = F.conv2d(gp, wt[:, :, ih::s, iw::s].flip((2, 3)),
                                              padding=pad)
    return gx


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` whose gradients are the port's own, the same bits on
    every run on the card where cuDNN's backward kernels add with atomics:
    forward by cuDNN; data gradient ``_data_grad``; weight gradient the
    products of the output gradient with the input's windows
    (``_patches``, ``_outer_sum``)."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        return F.conv2d(x, w, b, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (*conv2d_grads(g, x, w, ctx.stride, ctx.padding, ctx.needs_input_grad[:3]),
                None, None)


def conv2d_grads(g, x, w, stride, padding, needs):
    """(input, weight, bias) gradients of ``conv2d(x, w, b, stride,
    padding)`` from the output gradient ``g``; ``None`` where ``needs`` is
    false."""
    N, O, Ho, Wo = g.shape
    gx = _data_grad(g, w, stride, padding, x.shape[2:]) if needs[0] else None
    gw = gb = None
    if needs[1]:
        cols = _patches(x, w.shape[2], w.shape[3], stride, padding, (Ho, Wo))
        gw = _outer_sum(_nhwc(g).reshape(N, Ho * Wo, O), cols)
        gw = gw.view(O, w.shape[2], w.shape[3], w.shape[1]).permute(0, 3, 1, 2).contiguous()
    if needs[2]:
        gb = g.sum((0, 2, 3))
    return gx, gw, gb


def _normalize(x, mean, var, p):
    inv = torch.rsqrt(var + BN_EPS)
    return (x - mean[:, None, None]) * (inv * p["gamma"])[:, None, None] + p["beta"][:, None, None]


def _then(y, identity, relu):
    """What follows a BN in a block: ``+ identity``, then ReLU, if asked."""
    if identity is not None:
        y = y + identity
    return torch.relu(y) if relu else y


def _bn_infer(x, p, identity=None, relu=False):
    return _then(_normalize(x, p["mean"], p["var"], p), identity, relu), p


def _bn_batch(x, p, identity=None, relu=False):
    """``_bn(train=True)`` of the JAX package: batch statistics, no update."""
    return _then(_normalize(x, torch.mean(x, dim=(0, 2, 3)),
                            torch.var(x, dim=(0, 2, 3), correction=0), p), identity, relu), p


def _bn_train_group(x, p, momentum, w, group, identity=None, relu=False):
    """The train-mode BN of ``ops/weighted_bn.py`` (batch statistics of the
    images whose weight ``w`` is 1, the running statistics' EMA with the
    unbiased variance, then ``+ identity`` and ReLU if asked) with the
    statistics of every rank's images in ``group``, in torch ops: two
    all-reduces stand between the sums and the normalization. -> (output,
    the BN's params with the new running statistics, detached)."""
    from pd_fusion_torch.parallel.distributed import all_reduce_differentiable as all_reduce

    w = torch.ones(x.shape[0], dtype=x.dtype, device=x.device) if w is None else w
    wb = w[:, None, None, None]
    s = all_reduce(torch.cat([torch.sum(x * wb, dim=(0, 2, 3)),
                              (torch.sum(w) * (x.shape[2] * x.shape[3]))[None]]),
                   group=group)
    n = s[-1].detach()
    mean = s[:-1] / n
    var = all_reduce(torch.sum(torch.square(x - mean[:, None, None]) * wb, dim=(0, 2, 3)),
                     group=group) / n
    unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
    new_p = dict(p, mean=(1.0 - momentum) * p["mean"] + momentum * mean.detach(),
                 var=(1.0 - momentum) * p["var"] + momentum * unbiased.detach())
    return _then(_normalize(x, mean, var, p), identity, relu), new_p


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


def params_to_jax(params):
    """Inverse of ``params_from_jax``: the JAX package's tree of float32
    numpy arrays, conv weights HWIO."""
    def leaf(key, t):
        a = t.detach().cpu().numpy().astype(np.float32)
        if key == "w" and a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        return np.ascontiguousarray(a)

    return _map(params, leaf)


def _pool(x):
    """torch's stem max pool: 3x3, stride 2, padding 1 (with a -inf pad)."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


def _nchw(x):
    """NHWC [N, H, W, 3] -> NCHW view (channels-last memory, no copy)."""
    return x.permute(0, 3, 1, 2)


def _block(x, p, stride, basic, bn):
    """One residual block; ``bn(y, bn_params, identity=None, relu=False) ->
    (normalized, then + identity and ReLU if asked; bn_params after)``. ->
    (output, the block's params after)."""
    new_p = dict(p)
    if basic:
        h, new_p["bn1"] = bn(_conv(x, p["conv1"]["w"], stride=stride), p["bn1"], relu=True)
        h = _conv(h, p["conv2"]["w"])
        last = "bn2"
    else:
        h, new_p["bn1"] = bn(_conv(x, p["conv1"]["w"]), p["bn1"], relu=True)
        h, new_p["bn2"] = bn(_conv(h, p["conv2"]["w"], stride=stride), p["bn2"], relu=True)
        h = _conv(h, p["conv3"]["w"])
        last = "bn3"
    identity = x
    if "downsample" in p:
        identity, ds_bn = bn(_conv(x, p["downsample"]["conv"]["w"], stride=stride),
                             p["downsample"]["bn"])
        new_p["downsample"] = dict(p["downsample"], bn=ds_bn)
    out, new_p[last] = bn(h, p[last], identity, relu=True)
    return out, new_p


def _forward(params, x, arch, bn):
    """NCHW x -> (embeddings, params after every ``bn``)."""
    basic = _CONFIGS[arch]["block"] == "basic"
    new_params = dict(params)
    out, new_params["bn1"] = bn(_conv(x, params["conv1"]["w"], stride=2, padding=3), params["bn1"],
                                relu=True)
    out = _pool(out)
    for li in range(4):
        blocks = []
        for bi, p in enumerate(params[f"layer{li + 1}"]):
            stride = 2 if (li > 0 and bi == 0) else 1
            out, nb = _block(out, p, stride, basic, bn)
            blocks.append(nb)
        new_params[f"layer{li + 1}"] = blocks
    return torch.mean(out, dim=(2, 3)), new_params


def resnet_apply(params, x, arch: str = "resnet18", train: bool = False):
    """x [N, H, W, 3] -> embeddings [N, emb_dim] (global-average-pooled;
    no classifier, as torchvision's with ``fc = Identity``). Inference BN
    from the running statistics; ``train=True``: batch statistics, the
    running statistics untouched."""
    return _forward(params, _nchw(x), arch, _bn_batch if train else _bn_infer)[0]


def resnet_apply_train(params, x, arch: str = "resnet18", momentum: float = 0.1,
                       sample_weight=None, group=None):
    """Train-mode forward -> (embeddings, params with the running statistics
    moved by ``weighted_bn.bn_train``).
    ``sample_weight`` ([N] 0/1) restricts every BN's statistics to the
    weighted images, so a batch padded to a fixed shape has the unpadded
    batch's statistics. With
    ``group`` (a process group whose ranks hold the other images of the
    batch) the statistics are the whole batch's."""
    def bn(y, p, identity=None, relu=False):
        if group is not None:
            return _bn_train_group(y, p, momentum, sample_weight, group, identity, relu)
        return weighted_bn.bn_train(y, p, momentum, BN_EPS, sample_weight, identity, relu)

    return _forward(params, _nchw(x), arch, bn)


def _map2(a, b, fn, key=None):
    if isinstance(a, dict):
        return {k: _map2(v, b[k], fn, k) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return [_map2(u, v, fn, key) for u, v in zip(a, b)]
    return fn(key, a, b)


def merge_bn_stats(trained_params, stats_params):
    """``trained_params`` with every BN's running statistics taken from
    ``stats_params`` (the tree ``resnet_apply_train`` returned)."""
    return _map2(trained_params, stats_params, lambda k, t, s: s if k in BN_STATS else t)


def bn_buffer_mask(params):
    """A tree of bools, True where weight decay applies: every leaf but the
    BN running statistics (BN gamma and beta are decayed, as torch's Adam
    does)."""
    return _map(params, lambda k, _: k not in BN_STATS)


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
    out = _pool(torch.relu(_conv(_nchw(x), folded["conv1"]["w"], folded["conv1"]["b"], stride=2,
                                 padding=3)))
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
