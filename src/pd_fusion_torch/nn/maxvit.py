"""Functional MaxViT-T, a MIL fine-tune slice backbone (Tu et al. 2022,
"MaxViT: Multi-Axis Vision Transformer", arXiv:2204.01697, section 3,
variant MaxViT-T; where the paper is silent, torchvision's ``maxvit_t``).

Input NHWC [n, S, S, 3]. Equations, with BN the train-mode weighted batch
norm (``ops/weighted_bn.py``, eps 1e-3, no add, no ReLU) or, in
inference, the running statistics' affine map, and GELU the exact one:

- **Stem:** ``h = conv3x3_s2(x)`` (3 -> 64, no bias), ``h = GELU(BN(h))``,
  ``h = conv3x3_s1(h) + b`` (64 -> 64): S -> S/2.
- **Stages:** widths (64, 128, 256, 512), (2, 2, 5, 2) blocks; a stage's
  first block has stride 2, so at 224^2 the maps are 56, 28, 14 and 7. A
  block is an MBConv, then block attention, then grid attention.
- **MBConv(x; C_in -> C, stride s)**, mid = 4C, se = C/4:
  ``h = BN0(x)``; ``h = GELU(BN1(conv1x1(h)))``;
  ``h = GELU(BN2(dwconv3x3_s(h)))`` (depthwise: ``groups = mid``);
  ``h = h * sigmoid(fc2(SiLU(fc1(mean_HW(h)))))`` (fc1, fc2 1x1 convs with
  bias, mid -> se -> mid); ``h = conv1x1(h) + b``. The shortcut is ``x``
  when s = 1 and C_in = C, else ``conv1x1(avgpool3x3_s2_p1(x)) + b`` (the
  pool only at s = 2; it counts the zero padding, as torch's default).
  Output: shortcut + h.
- **Attention layers** on [n, H, W, C] with C/32 heads (head dim 32):
  ``t = t + proj(attn(LN(t)))``, then ``t = t + fc2(GELU(fc1(LN(t))))``
  (ratio 4). ``attn`` is softmax(``(q * 32^-0.5) k^T + bias``) v within
  groups of M^2 = 49 tokens, the bias a (2M - 1)^2 x heads table indexed
  by the two tokens' offset. This is Swin's unshifted block
  (``nn/swin.py::_block``), with the partition as its argument:
  - block attention: windows of 7 x 7 contiguous tokens (``swin.WINDOWS``);
  - grid attention: ``x.view(n, 7, H/7, 7, W/7, C).permute(0, 2, 4, 1, 3,
    5).reshape(-1, 49, C)``, the 49 tokens of a group H/7 apart, the bias
    indexed by their offset in grid coordinates (``GRID``).
  At 7 x 7 (stage 4) both partitions are the whole map.
- **Embedding:** the mean over H and W of stage 4, then LN (eps 1e-5): 512
  wide. torchvision's classifier (Linear 512 -> 512, tanh, the class
  layer) is dropped.

Parameters are nested dicts and lists: ``stem`` (``conv_a`` {w}, ``bn_a``,
``conv_b`` {w, b}); ``stages[i][j]`` holds ``mbconv`` (``pre_norm``,
``conv_a`` {w}, ``bn_a``, ``conv_b`` {w} (depthwise), ``bn_b``, ``se``
{fc1, fc2: {w, b}}, ``conv_c`` {w, b}, and ``proj`` {w, b} where the
shortcut has one), ``window`` and ``grid`` (Swin's block layout:
``norm1``, ``attn`` {qkv, proj, relative_position_bias_table}, ``norm2``,
``mlp`` {fc1, fc2}, linears {weight, bias} in torch's [out, in]); ``norm``.
Convolutions are OIHW under ``w``; a BN is ``{gamma, beta, mean, var}``,
the ResNet's layout, so the fine-tune's step merges the running statistics
and exempts them from decay as it does the ResNet's (``nn/resnet.py``:
``merge_bn_stats``, ``bn_buffer_mask``). ``convert_torchvision_state_dict``
reads a torchvision ``maxvit_t`` state_dict.

Where the port departs from torchvision's module, and why:

- The attention scale is ``head_dim^-0.5``, the paper's (scaled
  dot-product attention, as Swin's); torchvision scales by the layer's
  whole width, ``C^-0.5``.
- BN momentum 0.1 (torch's convention, the fine-tune's rule for the
  ResNets) in place of torchvision's 0.99 (TensorFlow's convention
  carried over); stochastic depth 0 (the ImageNet recipe's 0.2 is a
  pre-training regulariser). Every dropout 0, as MaxViT-T's own.
- The bias is the table through a one-hot matrix (``nn/swin.py``: the
  gather's backward adds with atomics on the card).
- 1x1 and 3x3 convolutions run through ``nn/resnet.py::_conv``: cuDNN's
  forward, the port's own gradients (the depthwise ones tap by tap); fc1
  and fc2 of the squeeze-excitation are products on [n, mid] rows.
- The shortcut's average pool runs on an NCHW copy (``_pool``): torch's
  CUDA backward of the pool on a channels-last input is wrong.

Memory: keep every activation, unless the step does not fit on one card
(the rule is ``nn/resnet.py``'s). At the fine-tune's 256 images of 224^2 a
plain MaxViT-T step keeps about 367 MB an image for its backward (94 GB,
more than the card's 80), of which the MBConvs' 187 MB. So in a training
forward each MBConv runs under ``torch.utils.checkpoint`` (non-reentrant):
its input alone is kept and its forward runs again in the backward. The
forward is deterministic, so the recompute gives the backward the bits
that keeping would give; the running statistics are taken from the first
forward, and the recompute's are discarded, so they move once a step.

Data parallelism (``group``) is not supported: ``maxvit_apply_train``
raises ``ValueError``.

Host spans and counters (``utils/profiling.py``): each MBConv's enqueue,
its recompute's included, runs in span ``backbone:mbconv``; grid
attention in span ``backbone:grid_attention`` (block attention keeps
Swin's ``backbone:window_attention``), neither with a range; counters
``backbone:grid_windows`` (images times grid groups, summed over blocks;
block attention adds to ``backbone:windows``) and ``backbone:recomputed``
(MBConv forwards run again in a backward).
"""
from typing import Any, Dict, List, NamedTuple, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pd_fusion_torch.nn import resnet, swin
from pd_fusion_torch.ops import weighted_bn
from pd_fusion_torch.utils import profiling

BN_EPS = 1e-3  # LayerNorm's is Swin's, 1e-5
INIT_STD = 0.02


class MaxVitArch(NamedTuple):
    stem: int
    widths: Tuple[int, ...]
    depths: Tuple[int, ...]
    head_dim: int
    partition: int  # M: groups of M x M tokens
    expansion: int = 4
    squeeze: float = 0.25
    mlp_ratio: int = 4


ARCHS: Dict[str, MaxVitArch] = {
    "maxvit_t": MaxVitArch(stem=64, widths=(64, 128, 256, 512), depths=(2, 2, 5, 2),
                           head_dim=32, partition=7),
}

Arch = Union[str, MaxVitArch]


def is_maxvit(arch) -> bool:
    return isinstance(arch, MaxVitArch) or arch in ARCHS


def _arch(arch: Arch) -> MaxVitArch:
    return ARCHS[arch] if isinstance(arch, str) else arch


def emb_dim(arch: Arch) -> int:
    return _arch(arch).widths[-1]


def stage_maps(arch: Arch, image_size: int) -> List[int]:
    """Each stage's map side at ``image_size``^2 (each must split into
    M x M groups)."""
    a = _arch(arch)
    res, out = image_size, []
    res = (res + 1) // 2  # the stem's stride 2
    for _ in a.depths:
        res = (res + 1) // 2
        if res % a.partition:
            raise ValueError(f"a {res}x{res} map does not split into {a.partition}x"
                             f"{a.partition} groups (input {image_size}^2)")
        out.append(res)
    return out


# ---- the grid partition ---------------------------------------------------
def _grid(x, m: int):
    """[n, H, W, C] -> [n * (H/m) * (W/m), m^2, C]: group (a, b) holds the
    tokens (i * H/m + a, j * W/m + b), i, j < m, in (i, j) order."""
    n, H, W, C = x.shape
    return (x.view(n, m, H // m, m, W // m, C).permute(0, 2, 4, 1, 3, 5)
            .reshape(-1, m * m, C))


def _grid_reverse(groups, m: int, n: int, H: int, W: int):
    """Inverse of ``_grid``."""
    C = groups.shape[-1]
    return (groups.view(n, H // m, W // m, m, m, C).permute(0, 3, 1, 4, 2, 5)
            .reshape(n, H, W, C))


GRID = swin.Partition(_grid, _grid_reverse, "backbone:grid_attention", "backbone:grid_windows")


# ---- init, loading ----------------------------------------------------------
def _normal(gen, *shape):
    return torch.randn(*shape, generator=gen) * INIT_STD


def _conv_init(gen, cout, cin, k, bias):
    p = {"w": _normal(gen, cout, cin, k, k)}
    if bias:
        p["b"] = torch.zeros(cout)
    return p


def _bn_init(c):
    return {"gamma": torch.ones(c), "beta": torch.zeros(c), "mean": torch.zeros(c),
            "var": torch.ones(c)}


def _attn_init(gen, C, heads, m, mlp_ratio):
    def linear(cin, cout):
        return {"weight": _normal(gen, cout, cin), "bias": torch.zeros(cout)}

    return {"norm1": swin._ln_init(C),
            "attn": {"qkv": linear(C, 3 * C), "proj": linear(C, C),
                     "relative_position_bias_table": swin._normal(gen, (2 * m - 1) ** 2, heads)},
            "norm2": swin._ln_init(C),
            "mlp": {"fc1": linear(C, C * mlp_ratio), "fc2": linear(C * mlp_ratio, C)}}


def init_maxvit(gen: torch.Generator, arch: Arch = "maxvit_t") -> Dict:
    """Seeded init (CPU tensors) as torchvision's ``maxvit_t``: conv and
    linear weights normal with std 0.02 and zero biases, BN and LN at
    identity, bias tables truncated-normal with std 0.02 (cut at +-2)."""
    a = _arch(arch)
    params: Dict[str, Any] = {"stem": {"conv_a": _conv_init(gen, a.stem, 3, 3, False),
                                       "bn_a": _bn_init(a.stem),
                                       "conv_b": _conv_init(gen, a.stem, a.stem, 3, True)},
                              "stages": []}
    cin = a.stem
    for C, depth in zip(a.widths, a.depths):
        mid, se = int(C * a.expansion), int(C * a.squeeze)
        stage = []
        for j in range(depth):
            c_in = cin if j == 0 else C
            mb = {"pre_norm": _bn_init(c_in), "conv_a": _conv_init(gen, mid, c_in, 1, False),
                  "bn_a": _bn_init(mid), "conv_b": _conv_init(gen, mid, 1, 3, False),
                  "bn_b": _bn_init(mid),
                  "se": {"fc1": _conv_init(gen, se, mid, 1, True),
                         "fc2": _conv_init(gen, mid, se, 1, True)},
                  "conv_c": _conv_init(gen, C, mid, 1, True)}
            if j == 0:  # stride 2: every stage's first block has a projected shortcut
                mb["proj"] = _conv_init(gen, C, c_in, 1, True)
            stage.append({"mbconv": mb,
                          "window": _attn_init(gen, C, C // a.head_dim, a.partition, a.mlp_ratio),
                          "grid": _attn_init(gen, C, C // a.head_dim, a.partition, a.mlp_ratio)})
        params["stages"].append(stage)
        cin = C
    params["norm"] = swin._ln_init(cin)
    return params


def torchvision_names(arch: Arch = "maxvit_t") -> Dict[str, Tuple]:
    """torchvision ``maxvit_t`` state_dict name -> the port's tree path, for
    every leaf of the backbone (the classifier's LN included, its linears
    not)."""
    a = _arch(arch)
    bn = {"weight": "gamma", "bias": "beta", "running_mean": "mean", "running_var": "var"}
    out: Dict[str, Tuple] = {}

    def conv(tv, path, bias):
        out[f"{tv}.weight"] = path + ("w",)
        if bias:
            out[f"{tv}.bias"] = path + ("b",)

    def norm(tv, path):
        for k, v in bn.items():
            out[f"{tv}.{k}"] = path + (v,)

    conv("stem.0.0", ("stem", "conv_a"), False)
    norm("stem.0.1", ("stem", "bn_a"))
    conv("stem.1.0", ("stem", "conv_b"), True)
    attn = {"attn_layer.0": ("norm1",), "attn_layer.1.to_qkv": ("attn", "qkv"),
            "attn_layer.1.merge": ("attn", "proj"), "mlp_layer.0": ("norm2",),
            "mlp_layer.1": ("mlp", "fc1"), "mlp_layer.3": ("mlp", "fc2")}
    for i, depth in enumerate(a.depths):
        for j in range(depth):
            pre, path = f"blocks.{i}.layers.{j}.layers.", ("stages", i, j)
            mb, mp = pre + "MBconv.", path + ("mbconv",)
            if j == 0:
                conv(mb + "proj.1", mp + ("proj",), True)  # proj.0 is the pool
            norm(mb + "layers.pre_norm", mp + ("pre_norm",))
            conv(mb + "layers.conv_a.0", mp + ("conv_a",), False)
            norm(mb + "layers.conv_a.1", mp + ("bn_a",))
            conv(mb + "layers.conv_b.0", mp + ("conv_b",), False)
            norm(mb + "layers.conv_b.1", mp + ("bn_b",))
            conv(mb + "layers.squeeze_excitation.fc1", mp + ("se", "fc1"), True)
            conv(mb + "layers.squeeze_excitation.fc2", mp + ("se", "fc2"), True)
            conv(mb + "layers.conv_c", mp + ("conv_c",), True)
            for tv_layer, layer in (("window_attention", "window"), ("grid_attention", "grid")):
                for tv, sub in attn.items():
                    for k in ("weight", "bias"):
                        out[f"{pre}{tv_layer}.{tv}.{k}"] = path + (layer,) + sub + (k,)
                out[f"{pre}{tv_layer}.attn_layer.1.relative_position_bias_table"] = \
                    path + (layer, "attn", "relative_position_bias_table")
    out["classifier.2.weight"], out["classifier.2.bias"] = ("norm", "weight"), ("norm", "bias")
    return out


def _put(tree, path, value):
    node = tree
    for part, nxt in zip(path[:-1], path[1:]):
        child = [] if isinstance(nxt, int) else {}
        if isinstance(node, list):
            node.extend([None] * (part + 1 - len(node)))
            node[part] = child if node[part] is None else node[part]
            node = node[part]
        else:
            node = node.setdefault(part, child)
    node[path[-1]] = value


def convert_torchvision_state_dict(sd: Dict[str, Any], arch: Arch = "maxvit_t") -> Dict:
    """A torchvision ``maxvit_t`` state_dict (tensors or numpy arrays) -> the
    port's tree, float32 CPU tensors. The relative position indices and
    ``num_batches_tracked`` are derived or unused; the classifier's
    linears are dropped."""
    names = torchvision_names(arch)
    missing = sorted(set(names) - set(sd))
    if missing:
        raise ValueError(f"the state_dict is not {arch}'s: {len(missing)} names missing, "
                         f"e.g. {missing[:3]}")

    def arr(v):
        a = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        return torch.from_numpy(np.array(a, np.float32, order="C"))  # a writable copy

    tree: Dict[str, Any] = {}
    for name, path in names.items():
        _put(tree, path, arr(sd[name]))
    return tree


def load_backbone(arch: Arch = "maxvit_t", weights_path=None, seed: int = 0):
    """Backbone params (CPU tensors) from a torchvision ``maxvit_t``
    checkpoint (``.pth``, read with ``weights_only=True``, or ``.npz``)
    when ``weights_path`` is given, else the seeded init. -> (params,
    emb_dim, pretrained)."""
    if weights_path is not None:
        p = str(weights_path)
        if p.endswith(".npz"):
            with np.load(p) as data:
                sd = {k: data[k] for k in data.files}
        else:
            sd = torch.load(p, map_location="cpu", weights_only=True)
        return convert_torchvision_state_dict(sd, arch), emb_dim(arch), True
    return init_maxvit(torch.Generator().manual_seed(int(seed)), arch), emb_dim(arch), False


# ---- the network ------------------------------------------------------------
def _bn_eval(x, p):
    s = p["gamma"] * torch.rsqrt(p["var"] + BN_EPS)
    return x * s[:, None, None] + (p["beta"] - p["mean"] * s)[:, None, None], p


def _1x1(x, p):
    """A 1x1 convolution with bias on [n, c] rows (the squeeze-excitation's)."""
    w = p["w"]
    return F.linear(x, w.view(w.shape[0], w.shape[1]), p["b"])


def _pool(x):
    """The strided shortcut's 3x3/2 average pool (the zero padding counted,
    torch's default) on an NCHW copy of ``x``, handed back channels-last.

    torch's CUDA backward of this pool on a channels-last float32 input is
    wrong (torch 2.11, CUDA 12.8, H100); the forward is right. The fault
    alone, against the same pool in float64 on the CPU::

        x = torch.randn(2, 64, 112, 112, device="cuda")
        x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
        g = torch.randn(2, 64, 56, 56, device="cuda")
        gx = torch.autograd.grad(F.avg_pool2d(x, 3, 2, 1), x, g)[0]

    ``gx`` is 1.05 off in relative norm, at batches 2 to 256 and at each
    strided shortcut's shape (1.01-1.05), whatever the gradient's layout;
    from an NCHW ``x`` it is 4e-8 off. It put a MaxViT-T step's gradients
    4-5% off float64; with this pool they are as close as the plain
    float32 reference's, 8e-6 (PERF.md)."""
    return F.avg_pool2d(x.contiguous(), 3, stride=2, padding=1).contiguous(
        memory_format=torch.channels_last)


def depthwise_conv(x, w, stride: int):
    """The MBConv's 3x3 depthwise convolution (``w`` [C, 1, 3, 3], padding
    1) of NCHW ``x``: cuDNN's forward, the port's own gradients
    (``nn/resnet.py::_conv``)."""
    return resnet._conv(x, w, stride=stride, groups=x.shape[1])


def _mbconv(x, p, stride: int, bn):
    """One MBConv on NCHW ``x`` -> (output, the block's params after every
    ``bn``)."""
    with profiling.span("backbone:mbconv", trace=False):
        new = dict(p)
        h, new["pre_norm"] = bn(x, p["pre_norm"])
        h, new["bn_a"] = bn(resnet._conv(h, p["conv_a"]["w"]), p["bn_a"])
        h = F.gelu(h)
        h, new["bn_b"] = bn(depthwise_conv(h, p["conv_b"]["w"], stride), p["bn_b"])
        h = F.gelu(h)
        s = torch.sigmoid(_1x1(F.silu(_1x1(torch.mean(h, dim=(2, 3)), p["se"]["fc1"])),
                               p["se"]["fc2"]))
        h = resnet._conv(h * s[:, :, None, None], p["conv_c"]["w"], p["conv_c"]["b"])
        if "proj" in p:
            r = _pool(x) if stride == 2 else x
            r = resnet._conv(r, p["proj"]["w"], p["proj"]["b"])
        else:
            r = x
        return r + h, new


def _recomputed(fn, *args):
    """``fn(*args)`` keeping only its inputs for the backward, which runs
    its forward again (counter ``backbone:recomputed``)."""
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] > 1:
            profiling.count("backbone:recomputed")
        return fn(*a)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).contiguous()


def _forward(params, x, a: MaxVitArch, bn, recompute: bool):
    """NHWC x -> (embeddings, params after every ``bn``)."""
    maps = stage_maps(a, x.shape[1])
    new: Dict[str, Any] = dict(params)
    st = params["stem"]
    h, bn_a = bn(resnet._conv(x.permute(0, 3, 1, 2), st["conv_a"]["w"], stride=2), st["bn_a"])
    h = resnet._conv(F.gelu(h), st["conv_b"]["w"], st["conv_b"]["b"])
    new["stem"] = dict(st, bn_a=bn_a)
    m = a.partition
    new["stages"] = []
    for res, C, stage in zip(maps, a.widths, params["stages"]):
        heads, layers = C // a.head_dim, []
        for j, layer in enumerate(stage):
            stride = 2 if j == 0 else 1
            if recompute:
                h, mb = _recomputed(lambda t, p, s=stride: _mbconv(t, p, s, bn), h,
                                    layer["mbconv"])
            else:
                h, mb = _mbconv(h, layer["mbconv"], stride, bn)
            t = _nhwc(h)
            if t.shape[1] != res:
                raise ValueError(f"a stage expects a {res}x{res} map, got {tuple(t.shape[1:3])}")
            t = swin._block(t, layer["window"], heads, m, 0, None, swin.WINDOWS)
            t = swin._block(t, layer["grid"], heads, m, 0, None, GRID)
            h = t.permute(0, 3, 1, 2)
            layers.append(dict(layer, mbconv=mb))
        new["stages"].append(layers)
    emb = swin._ln(torch.mean(t, dim=(1, 2)), params["norm"])
    return emb, new


def maxvit_apply_train(params, x, arch: Arch = "maxvit_t", momentum: float = 0.1,
                       sample_weight=None, group=None):
    """Train-mode forward of NHWC ``x`` -> (embeddings [n, 512], params with
    the running statistics moved). Every BN is ``weighted_bn.bn_train``:
    the statistics of the images whose ``sample_weight`` is 1. Under
    autograd each MBConv is recomputed in the backward (the module's
    memory rule)."""
    if group is not None:
        raise ValueError("MaxViT has no data-parallel step (group)")

    def bn(y, p):
        return weighted_bn.bn_train(y, p, momentum, BN_EPS, sample_weight)

    return _forward(params, x, _arch(arch), bn, torch.is_grad_enabled())


def maxvit_apply(params, x, arch: Arch = "maxvit_t"):
    """Inference: every BN from its running statistics, without autograd."""
    with torch.no_grad():
        return _forward(params, x, _arch(arch), _bn_eval, False)[0]
