"""The Swin Transformer as published (Liu et al. 2021, arXiv:2103.14030,
sections 3.1-3.3 and Table 1; the official module's forward), in plain
PyTorch over NCHW float32 input.

Parameters are a flat dict under the official state_dict's names
(``patch_embed.proj.weight``, ``layers.0.blocks.1.attn.qkv.weight``, ...).
The patch embedding is a PxP, stride-P convolution and a LayerNorm; a
block is ``x + W-MSA(LN(x))`` or, in odd blocks, the same on a map rolled
by -floor(M/2) with an additive mask between the rolled regions, then
``x + MLP(LN(x))`` (exact GELU); the relative position bias is gathered
from its table by index, as the paper writes it; patch merging is the
``cat`` of the four 2x2 offsets, LN and a linear without bias; the
embedding is the final LN's tokens averaged. No dropout and no stochastic
depth. A network's table is its configuration's ``architecture`` block
(``arch_from``).
"""
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F


class Arch(NamedTuple):
    patch: int
    embed_dim: int
    depths: Tuple[int, ...]
    heads: Tuple[int, ...]
    window: int
    mlp_ratio: int
    mask_value: float
    eps: float


def arch_from(architecture: Dict) -> Arch:
    """A configuration's ``architecture`` block -> the table."""
    a = architecture
    return Arch(int(a["patch_size"]), int(a["embed_dim"]), tuple(a["stage_blocks"]),
                tuple(a["num_heads"]), int(a["window_size"]), int(a["mlp_ratio"]),
                float(a["mask_value"]), float(a["norm_eps"]))


def emb_dim(a: Arch) -> int:
    return a.embed_dim * 2 ** (len(a.depths) - 1)


def stages(a: Arch, size: int) -> List[Tuple[int, int, int, int]]:
    """(resolution, width, window, shift) of each stage: a map no larger
    than the window is one window, unshifted (the official rule)."""
    res, C, out = size // a.patch, a.embed_dim, []
    for _ in a.depths:
        window = min(res, a.window)
        out.append((res, C, window, 0 if res <= a.window else a.window // 2))
        res, C = res // 2, C * 2
    return out


def param_shapes(a: Arch, size: int) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, in the official order."""
    P, C = a.patch, a.embed_dim
    out = {"patch_embed.proj.weight": (C, 3, P, P), "patch_embed.proj.bias": (C,),
           "patch_embed.norm.weight": (C,), "patch_embed.norm.bias": (C,)}
    for i, ((_, C, window, _), depth, heads) in enumerate(zip(stages(a, size), a.depths,
                                                              a.heads)):
        for j in range(depth):
            pre = f"layers.{i}.blocks.{j}."
            hidden = C * a.mlp_ratio
            out.update({
                pre + "norm1.weight": (C,), pre + "norm1.bias": (C,),
                pre + "attn.relative_position_bias_table": ((2 * window - 1) ** 2, heads),
                pre + "attn.qkv.weight": (3 * C, C), pre + "attn.qkv.bias": (3 * C,),
                pre + "attn.proj.weight": (C, C), pre + "attn.proj.bias": (C,),
                pre + "norm2.weight": (C,), pre + "norm2.bias": (C,),
                pre + "mlp.fc1.weight": (hidden, C), pre + "mlp.fc1.bias": (hidden,),
                pre + "mlp.fc2.weight": (C, hidden), pre + "mlp.fc2.bias": (C,)})
        if i + 1 < len(a.depths):
            pre = f"layers.{i}.downsample."
            out.update({pre + "reduction.weight": (2 * C, 4 * C), pre + "norm.weight": (4 * C,),
                        pre + "norm.bias": (4 * C,)})
    C = emb_dim(a)
    out.update({"norm.weight": (C,), "norm.bias": (C,)})
    return out


def window_partition(x, window: int):
    """[B, H, W, C] -> [B * nW, window, window, C]."""
    B, H, W, C = x.shape
    x = x.view(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window, window, C)


def window_reverse(windows, window: int, H: int, W: int):
    B = windows.shape[0] // (H * W // window // window)
    x = windows.view(B, H // window, W // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, H, W, -1)


def relative_position_index(window: int):
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def attn_mask(res: int, window: int, shift: int, value: float, device):
    img = torch.zeros(1, res, res, 1, device=device)
    cnt = 0
    for h in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for w in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[:, h, w, :] = cnt
            cnt += 1
    m = window_partition(img, window).view(-1, window * window)
    m = m.unsqueeze(1) - m.unsqueeze(2)
    return m.masked_fill(m != 0, value).masked_fill(m == 0, 0.0)


def _ln(x, p, name, eps):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], eps)


def attention(p, pre, x, heads: int, window: int, mask):
    """Window attention of ``x`` [B * nW, N, C]."""
    B_, N, C = x.shape
    qkv = F.linear(x, p[pre + "qkv.weight"], p[pre + "qkv.bias"])
    qkv = qkv.reshape(B_, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (C // heads) ** -0.5
    attn = q @ k.transpose(-2, -1)
    idx = relative_position_index(window).to(x.device)
    bias = p[pre + "relative_position_bias_table"][idx.view(-1)].view(N, N, -1)
    attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
    if mask is not None:
        nW = mask.shape[0]
        attn = attn.view(B_ // nW, nW, heads, N, N) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, N, N)
    attn = torch.softmax(attn, dim=-1)
    x = (attn @ v).transpose(1, 2).reshape(B_, N, C)
    return F.linear(x, p[pre + "proj.weight"], p[pre + "proj.bias"])


def block(p, pre, x, res: int, heads: int, window: int, shift: int, a: Arch):
    """One block on tokens [B, res * res, C]."""
    B, L, C = x.shape
    shortcut = x
    x = _ln(x, p, pre + "norm1", a.eps).view(B, res, res, C)
    mask = attn_mask(res, window, shift, a.mask_value, x.device) if shift else None
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    w = window_partition(x, window).view(-1, window * window, C)
    w = attention(p, pre + "attn.", w, heads, window, mask).view(-1, window, window, C)
    x = window_reverse(w, window, res, res)
    if shift:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    x = shortcut + x.view(B, L, C)
    h = _ln(x, p, pre + "norm2", a.eps)
    h = F.gelu(F.linear(h, p[pre + "mlp.fc1.weight"], p[pre + "mlp.fc1.bias"]))
    return x + F.linear(h, p[pre + "mlp.fc2.weight"], p[pre + "mlp.fc2.bias"])


def patch_merging(p, pre, x, res: int, eps: float):
    B, L, C = x.shape
    x = x.view(B, res, res, C)
    x0, x1 = x[:, 0::2, 0::2, :], x[:, 1::2, 0::2, :]
    x2, x3 = x[:, 0::2, 1::2, :], x[:, 1::2, 1::2, :]
    x = torch.cat([x0, x1, x2, x3], -1).view(B, -1, 4 * C)
    return F.linear(_ln(x, p, pre + "norm", eps), p[pre + "reduction.weight"])


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, a: Arch):
    """x [N, 3, H, W] -> embeddings [N, emb_dim]."""
    table = stages(a, x.shape[-1])
    x = F.conv2d(x, p["patch_embed.proj.weight"], p["patch_embed.proj.bias"], stride=a.patch)
    x = _ln(x.flatten(2).transpose(1, 2), p, "patch_embed.norm", a.eps)
    for i, ((res, _, window, shift), depth, heads) in enumerate(zip(table, a.depths, a.heads)):
        for j in range(depth):
            x = block(p, f"layers.{i}.blocks.{j}.", x, res, heads, window,
                      shift if j % 2 else 0, a)
        if i + 1 < len(a.depths):
            x = patch_merging(p, f"layers.{i}.downsample.", x, res, a.eps)
    return _ln(x, p, "norm", a.eps).mean(dim=1)
