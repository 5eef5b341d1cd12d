"""Functional Swin-T, the MIL fine-tune's transformer slice backbone (Liu et
al. 2021, "Swin Transformer: Hierarchical Vision Transformer using Shifted
Windows", arXiv:2103.14030, sections 3.1-3.3, Table 1).

Swin-T: 4x4 patches embedded to C = 96 and layer-normed, four stages of
{2, 2, 6, 2} blocks at widths {96, 192, 384, 768} with {3, 6, 12, 24}
heads (head dim 32), each stage after the first entered by a patch merging
(2x2 neighbours concatenated, LN(4C), a 4C -> 2C linear without bias),
then a final LN and the mean over tokens: a 768-wide embedding. A block is
pre-norm: ``x + MSA(LN(x))``, then ``x + MLP(LN(x))`` (ratio 4, exact
GELU). Its attention is within windows of M x M = 7 x 7 tokens, plain in
even blocks and shifted in odd ones: the map is rolled by -floor(M / 2)
before the windows are cut and rolled back after, and the windows that the
roll stitched together from distant regions carry an additive mask of
-100.0 between the regions, as the official code uses. A stage whose
resolution is at most M has one window of its whole map and no shift
(stage 4 at 224^2: 7 x 7). Scores are ``(q * head_dim^-0.5) k^T`` plus a
learned relative position bias, a (2M - 1)^2 x heads table per block
indexed by the two tokens' offset. qkv has a bias; LN eps is 1e-5.

Parameters are nested dicts and lists that mirror the official
state_dict's names (``layers.0.blocks.1.attn.qkv.weight`` is
``p["layers"][0]["blocks"][1]["attn"]["qkv"]["weight"]``), linears in
torch's [out, in] layout. ``convert_official_state_dict`` reads a
``swin_tiny_patch4_window7_224`` checkpoint. The tree holds no running
statistics: LayerNorm has no batch statistic, so training and evaluation
are the same function (``swin_apply_train`` and ``swin_apply``), a
batch's padded rows cannot change another row's embedding, and nothing is
merged after a step.

Where the port departs from the official module, and why:

- Stochastic depth is 0 (the ImageNet recipe's 0.2 is a pre-training
  regulariser; the fine-tune's configuration sets none for the ResNets
  either). Every dropout is 0, as Swin-T's own.
- The relative position bias is the table times a constant one-hot matrix
  ``[M^4, (2M - 1)^2]`` in place of an indexed gather. Each row has one 1,
  so the forward value is the gathered one, exactly; the gather's
  backward is an accumulating ``index_put``, whose CUDA kernel adds with
  atomics (``utils/determinism_checks.py::ATOMIC_ATEN_OPS``), where the
  one-hot's is one product and the step gives the same bits on every run.
- The patch embedding (a 4x4, stride-4 convolution) is a product of each
  patch's 48 values with the kernel as a [96, 48] matrix: the same sum in
  another order. Its weight gradient is then a product too (cuDNN's
  convolution backward adds with atomics) and its input gets none.
- The bias and the mask are summed before they are added to the scores
  (the official code adds one, then the other): the same values except
  where the mask is -100.0, whose weights the softmax takes to 0 either way.
- The resolution of each stage is read from the input, not fixed at
  construction; a stage's map must split into whole windows. The bias
  tables' size is fixed at ``init_swin`` by ``image_size``.
- Blocks keep their activations for the backward pass, as the ResNet's
  (the rule and its reason: ``nn/resnet.py``): at 256 images of 224^2 the
  step keeps about 30 GB of activations, within one card.

Host spans and counters (``utils/profiling.py``): each block's partition,
attention and reverse, its shift included, run in span
``backbone:window_attention`` (no range: it encloses device work and is no
function the benchmark wraps), and counter ``backbone:windows`` adds the
window attentions each block runs, images times windows. ``_block`` takes
the partition as an argument (``Partition``: how the map is cut into
groups of M^2 tokens and joined again, and the span and counter it runs
in), Swin's windows by default; MaxViT's block attention is the same
unshifted block, and its grid attention another partition
(``nn/maxvit.py``).
"""
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from pd_fusion_torch.utils import profiling

LN_EPS = 1e-5
MASK_VALUE = -100.0
INIT_STD = 0.02


class SwinArch(NamedTuple):
    patch: int
    embed_dim: int
    depths: Tuple[int, ...]
    heads: Tuple[int, ...]
    window: int
    mlp_ratio: int


ARCHS: Dict[str, SwinArch] = {
    "swin_t": SwinArch(patch=4, embed_dim=96, depths=(2, 2, 6, 2), heads=(3, 6, 12, 24),
                       window=7, mlp_ratio=4),
}

Arch = Union[str, SwinArch]


def is_swin(arch) -> bool:
    return isinstance(arch, SwinArch) or arch in ARCHS


def _arch(arch: Arch) -> SwinArch:
    return ARCHS[arch] if isinstance(arch, str) else arch


def emb_dim(arch: Arch) -> int:
    a = _arch(arch)
    return a.embed_dim * 2 ** (len(a.depths) - 1)


def stage_windows(arch: Arch, image_size: int) -> List[Tuple[int, int, int]]:
    """(resolution, window, shift) of each stage at ``image_size``^2: the
    window is the whole map where the map is no larger than M, and then
    nothing is shifted."""
    a = _arch(arch)
    res = image_size // a.patch
    out = []
    for i in range(len(a.depths)):
        if res <= a.window:
            out.append((res, res, 0))
        else:
            if res % a.window:
                raise ValueError(f"a {res}x{res} map does not split into {a.window}x{a.window} "
                                 f"windows (input {image_size}^2)")
            out.append((res, a.window, a.window // 2))
        res //= 2
    return out


# ---- init, loading ------------------------------------------------------
def _normal(gen, *shape):
    """timm's ``trunc_normal_(std=0.02)``, cut at +-2 (absolute), as the
    official init has it."""
    return torch.nn.init.trunc_normal_(torch.empty(*shape), std=INIT_STD, generator=gen)


def _ln_init(c):
    return {"weight": torch.ones(c), "bias": torch.zeros(c)}


def _linear_init(gen, cin, cout, bias=True):
    p = {"weight": _normal(gen, cout, cin)}
    if bias:
        p["bias"] = torch.zeros(cout)
    return p


def init_swin(gen: torch.Generator, arch: Arch = "swin_t", image_size: int = 224) -> Dict:
    """Seeded init (CPU tensors) as the official ``_init_weights``: linears
    and the bias tables truncated-normal with std 0.02 and zero biases, LNs
    at identity; the patch embedding's convolution keeps torch's default
    (uniform in +-1/sqrt(fan_in), weight and bias)."""
    a = _arch(arch)
    C, P = a.embed_dim, a.patch
    bound = 1.0 / np.sqrt(3 * P * P)
    proj = {"weight": (torch.rand(C, 3, P, P, generator=gen) * 2 - 1) * bound,
            "bias": (torch.rand(C, generator=gen) * 2 - 1) * bound}
    params: Dict[str, Any] = {"patch_embed": {"proj": proj, "norm": _ln_init(C)}, "layers": []}
    for i, ((_, window, _), depth, heads) in enumerate(zip(stage_windows(a, image_size),
                                                           a.depths, a.heads)):
        blocks = []
        for _ in range(depth):
            hidden = C * a.mlp_ratio
            blocks.append({
                "norm1": _ln_init(C),
                "attn": {"qkv": _linear_init(gen, C, 3 * C), "proj": _linear_init(gen, C, C),
                         "relative_position_bias_table": _normal(gen, (2 * window - 1) ** 2,
                                                                 heads)},
                "norm2": _ln_init(C),
                "mlp": {"fc1": _linear_init(gen, C, hidden), "fc2": _linear_init(gen, hidden, C)},
            })
        layer: Dict[str, Any] = {"blocks": blocks}
        if i + 1 < len(a.depths):
            layer["downsample"] = {"norm": _ln_init(4 * C),
                                   "reduction": _linear_init(gen, 4 * C, 2 * C, bias=False)}
            C *= 2
        params["layers"].append(layer)
    params["norm"] = _ln_init(C)
    return params


# the official checkpoint's buffers, which the port derives, and its classifier
_DERIVED = ("relative_position_index", "attn_mask", "head.")


def _insert(tree, parts, value):
    """Put ``value`` at a dotted name's place: a numeric part indexes a list."""
    node = tree
    for part, nxt in zip(parts[:-1], parts[1:]):
        child = [] if nxt.isdigit() else {}
        if isinstance(node, list):
            i = int(part)
            node.extend([None] * (i + 1 - len(node)))
            node[i] = child if node[i] is None else node[i]
            node = node[i]
        else:
            node = node.setdefault(part, child)
    node[parts[-1]] = value


def convert_official_state_dict(sd: Dict[str, Any], arch: Arch = "swin_t") -> Dict:
    """An official Swin state_dict (``swin_tiny_patch4_window7_224``'s key
    layout, or that layout under a ``"model"`` key; tensors or numpy arrays)
    -> the port's tree, float32 CPU tensors. The relative position indices
    and attention masks are derived, not read; the classifier is dropped."""
    sd = sd.get("model", sd)

    def arr(v):
        a = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        return torch.from_numpy(np.array(a, np.float32, order="C"))  # a writable copy

    tree: Dict[str, Any] = {}
    for name, v in sd.items():
        if not any(d in name for d in _DERIVED):
            _insert(tree, name.split("."), arr(v))
    a = _arch(arch)
    if [len(layer["blocks"]) for layer in tree["layers"]] != list(a.depths):
        raise ValueError(f"the state_dict's stages are not {arch}'s {a.depths}")
    return tree


def load_backbone(arch: Arch = "swin_t", weights_path=None, seed: int = 0,
                  image_size: int = 224):
    """Backbone params (CPU tensors) from an official checkpoint (``.pth``,
    read with ``weights_only=True``, or ``.npz``) when ``weights_path`` is
    given, else the seeded init. -> (params, emb_dim, pretrained)."""
    if weights_path is not None:
        p = str(weights_path)
        if p.endswith(".npz"):
            with np.load(p) as data:
                sd = {k: data[k] for k in data.files}
        else:
            sd = torch.load(p, map_location="cpu", weights_only=True)
        return convert_official_state_dict(sd, arch), emb_dim(arch), True
    return init_swin(torch.Generator().manual_seed(int(seed)), arch, image_size), \
        emb_dim(arch), False


# ---- constants of a window size ----------------------------------------
_CONSTANTS: Dict[Tuple, torch.Tensor] = {}


def relative_position_index(window: int) -> torch.Tensor:
    """[M^2, M^2] long: the bias table's row for each pair of a window's
    tokens, as the official ``relative_position_index``."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def _one_hot(window: int, device, dtype) -> torch.Tensor:
    """[M^4, (2M - 1)^2]: row ``i * M^2 + j`` holds one 1, at the table row
    of tokens i and j (cached per window, device and dtype)."""
    key = ("one_hot", window, str(device), dtype)
    t = _CONSTANTS.get(key)
    if t is None:
        idx = relative_position_index(window).reshape(-1)
        t = F.one_hot(idx, (2 * window - 1) ** 2).to(device=device, dtype=dtype)
        _CONSTANTS[key] = t
    return t


def shift_mask(res: int, window: int, shift: int, device=None,
               dtype=torch.float32) -> Optional[torch.Tensor]:
    """[nW, M^2, M^2] additive mask of a shifted stage (None unshifted): 0
    between tokens of one region of the rolled map, -100.0 across regions."""
    if not shift:
        return None
    key = ("mask", res, window, shift, str(device), dtype)
    t = _CONSTANTS.get(key)
    if t is None:
        region = torch.zeros(res, res)
        cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
        n = 0
        for h in cuts:
            for w in cuts:
                region[h, w] = n
                n += 1
        r = _partition(region[None, :, :, None], window)[..., 0]  # [nW, M^2]
        t = torch.where(r[:, None, :] != r[:, :, None], MASK_VALUE, 0.0)
        t = _CONSTANTS[key] = t.to(device=device, dtype=dtype)
    return t


# ---- the network --------------------------------------------------------
def _ln(x, p):
    return F.layer_norm(x, (x.shape[-1],), p["weight"], p["bias"], LN_EPS)


def _linear(x, p):
    return F.linear(x, p["weight"], p.get("bias"))


def _partition(x, window: int):
    """[n, H, W, C] -> [n * nW, M^2, C], windows in row-major order per image."""
    n, H, W, C = x.shape
    return (x.view(n, H // window, window, W // window, window, C).permute(0, 1, 3, 2, 4, 5)
            .reshape(-1, window * window, C))


def _reverse(windows, window: int, n: int, H: int, W: int):
    """Inverse of ``_partition``: [n * nW, M^2, C] -> [n, H, W, C]."""
    C = windows.shape[-1]
    return (windows.view(n, H // window, W // window, window, window, C)
            .permute(0, 1, 3, 2, 4, 5).reshape(n, H, W, C))


def attention_bias(table, window: int, mask=None):
    """The additive term of a block's scores: the relative position bias
    (the table through the one-hot matrix) plus the shift mask -> [1 or nW,
    heads, M^2, M^2]."""
    N = window * window
    bias = (_one_hot(window, table.device, table.dtype) @ table).view(N, N, -1).permute(2, 0, 1)
    return bias[None] if mask is None else mask[:, None] + bias[None]


def window_attention(q, k, v, table, window: int, mask=None):
    """Scaled dot-product attention within windows: q, k, v [n * nW, heads,
    M^2, d], ``table`` the block's [(2M - 1)^2, heads] bias table, ``mask``
    the stage's [nW, M^2, M^2] shift mask or None -> [n * nW, heads, M^2, d]."""
    B_, heads, N, d = q.shape
    add = attention_bias(table, window, mask)
    s = (q * d ** -0.5) @ k.transpose(-2, -1)
    s = (s.view(-1, add.shape[0], heads, N, N) + add).view(B_, heads, N, N)
    return torch.softmax(s, dim=-1) @ v


class Partition(NamedTuple):
    """How a block cuts its map into groups of M^2 tokens that attend to one
    another, and the host span and counter its attention runs in."""
    cut: Callable  # ([n, H, W, C], M) -> [n * G, M^2, C]
    join: Callable  # ([n * G, M^2, C], M, n, H, W) -> [n, H, W, C]
    span: str
    counter: str


WINDOWS = Partition(_partition, _reverse, "backbone:window_attention", "backbone:windows")


def _block(x, p, heads: int, window: int, shift: int, mask, part: Partition = WINDOWS):
    """One Swin block on [n, H, W, C] (``shift`` 0: W-MSA, else SW-MSA).
    ``part``: the partition into groups of ``window``^2 tokens, Swin's
    windows unless another is given (MaxViT's grid, ``nn/maxvit.py``)."""
    n, H, W, C = x.shape
    h = _ln(x, p["norm1"])
    with profiling.span(part.span, trace=False):
        if shift:
            h = torch.roll(h, (-shift, -shift), (1, 2))
        win = part.cut(h, window)
        B_, N = win.shape[:2]
        profiling.count(part.counter, B_)
        qkv = _linear(win, p["attn"]["qkv"]).view(B_, N, 3, heads, C // heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        o = window_attention(qkv[0], qkv[1], qkv[2], p["attn"]["relative_position_bias_table"],
                             window, mask)
        h = _linear(o.transpose(1, 2).reshape(B_, N, C), p["attn"]["proj"])
        h = part.join(h, window, n, H, W)
        if shift:
            h = torch.roll(h, (shift, shift), (1, 2))
    x = x + h
    return x + _linear(F.gelu(_linear(_ln(x, p["norm2"]), p["mlp"]["fc1"])), p["mlp"]["fc2"])


def _merge(x, p):
    """Patch merging: [n, H, W, C] -> [n, H/2, W/2, 2C]; the 4C vector is the
    official ``cat([x0, x1, x2, x3])`` of the (row, column) offsets (0, 0),
    (1, 0), (0, 1), (1, 1)."""
    n, H, W, C = x.shape
    x = x.view(n, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
    return _linear(_ln(x.reshape(n, H // 2, W // 2, 4 * C), p["norm"]), p["reduction"])


def _patch_embed(x, p, patch: int):
    """NHWC [n, H, W, c] -> [n, H/P, W/P, C]: each P x P patch's values,
    ordered (row, column, channel), times the convolution's kernel as a
    matrix, then LN."""
    n, H, W, c = x.shape
    t = (x.reshape(n, H // patch, patch, W // patch, patch, c).permute(0, 1, 3, 2, 4, 5)
         .reshape(n, H // patch, W // patch, patch * patch * c))
    w = p["proj"]["weight"]
    t = F.linear(t, w.permute(0, 2, 3, 1).reshape(w.shape[0], -1), p["proj"]["bias"])
    return _ln(t, p["norm"])


def swin_apply_train(params, x, arch: Arch = "swin_t"):
    """x [n, H, W, 3] (NHWC) -> embeddings [n, emb_dim]: the final LN's
    tokens averaged. Differentiable in ``params``; no state moves."""
    a = _arch(arch)
    h = _patch_embed(x, params["patch_embed"], a.patch)
    for i, ((res, window, shift), layer, heads) in enumerate(
            zip(stage_windows(a, x.shape[1]), params["layers"], a.heads)):
        if h.shape[1] != res or h.shape[2] != res:
            raise ValueError(f"stage {i + 1} expects a {res}x{res} map, got {tuple(h.shape[1:3])}")
        mask = shift_mask(res, window, shift, h.device, h.dtype)
        for j, block in enumerate(layer["blocks"]):
            h = _block(h, block, heads, window, shift if j % 2 else 0, mask if j % 2 else None)
        if "downsample" in layer:
            h = _merge(h, layer["downsample"])
    return torch.mean(_ln(h, params["norm"]), dim=(1, 2))


def swin_apply(params, x, arch: Arch = "swin_t"):
    """Inference: ``swin_apply_train`` without autograd (no dropout, no
    running statistics: the same function)."""
    with torch.no_grad():
        return swin_apply_train(params, x, arch)
