"""Model FLOPs of the MaxViT cell's work, from the published table
(``reference/maxvit.py``'s ``Arch``), counted as ``flops.py`` counts the
ResNet's and ``flops_swin.py`` the Swin's.

A convolution is ``2 * Cin / groups * Cout * k^2 * Ho * Wo`` an image, a
linear ``2 * in * out`` a row. An MBConv (C_in -> C, mid = 4C, se = C/4,
input side r, output side r/s) is its 1x1 expansion at r, the 3x3
depthwise convolution at r/s (``2 * 9 * mid`` a position), the
squeeze-excitation's two 1x1s on one position, the 1x1 projection at r/s
and, where there is one, the shortcut's 1x1 at r/s. An attention layer at
T tokens of width C in groups of N = P^2 is ``24 T C^2`` in its linears
(qkv 6, the projection 2, the MLP 16) and ``4 T N C`` in its two products.
A training step counts the forward F, the weight gradients and the data
gradients (each product's two operands' gradients for the attention's):
``3F - F_stem`` an image, less the first convolution's data gradient (its
input, the augmented slices, needs none), and three forwards for the
head's linears. The recompute of the MBConvs is not counted (model FLOPs,
not the hardware's); neither are the bias, softmax, the norms, GELU, the
pool or the residual adds.
"""
from typing import List, Tuple

from benchmark import flops
from benchmark.reference import maxvit


def mbconvs(a: maxvit.Arch, size: int) -> List[Tuple[int, int, int, int]]:
    """Each MBConv's depthwise convolution: (mid channels, input side,
    output side, stride)."""
    out = []
    for res, _, C, depth in maxvit.stages(a, size):
        for j in range(depth):
            s = 2 if j == 0 else 1
            out.append((C * a.expansion, res * s, res, s))
    return out


def backbone_forward(a: maxvit.Arch, size: int) -> Tuple[int, int]:
    """-> (FLOPs of one image's forward, of which the first convolution's)."""
    r = (size + 1) // 2
    stem = 2 * 3 * a.stem * 9 * r * r
    total = stem + 2 * a.stem * a.stem * 9 * r * r
    N = a.partition ** 2
    for res, cin, C, depth in maxvit.stages(a, size):
        mid, se = C * a.expansion, int(C * a.squeeze)
        for j in range(depth):
            c_in, s = (cin, 2) if j == 0 else (C, 1)
            r_in, T = res * s, res * res
            total += 2 * c_in * mid * r_in * r_in + 2 * 9 * mid * T + 2 * 2 * mid * se
            total += 2 * mid * C * T + (2 * c_in * C * T if j == 0 else 0)
            total += 2 * (24 * T * C * C + 4 * T * N * C)  # block and grid attention
    return total, stem


def train_step(a: maxvit.Arch, size: int, B: int, L: int, H: int, A: int) -> int:
    f, stem = backbone_forward(a, size)
    return B * L * (3 * f - stem) + 3 * B * flops.head_forward(maxvit.emb_dim(a), H, A, L)


def backbone_train(a: maxvit.Arch, size: int, n: int) -> int:
    f, stem = backbone_forward(a, size)
    return n * (3 * f - stem)


def predict_pass(a: maxvit.Arch, size: int, B: int, L: int, H: int, A: int) -> int:
    f, _ = backbone_forward(a, size)
    return B * L * f + B * flops.head_forward(maxvit.emb_dim(a), H, A, L)


def depthwise(a: maxvit.Arch, size: int, n: int) -> List[Tuple[int, int]]:
    """Each MBConv's depthwise 3x3 convolution over ``n`` images, forward
    and both gradients -> [(FLOPs, unavoidable bytes)]: three times the
    forward's ``2 * 9 * mid`` a position; x, y and w, and each one's
    gradient, read or written once (float32)."""
    out = []
    for mid, r_in, r_out, _ in mbconvs(a, size):
        work = 3 * 2 * 9 * mid * r_out * r_out * n
        moved = 4 * 2 * (n * mid * r_in * r_in + n * mid * r_out * r_out + 9 * mid)
        out.append((work, moved))
    return out


def attention(a: maxvit.Arch, size: int, n: int) -> List[Tuple[int, int]]:
    """Each block's two attention layers (block, then grid) over ``n``
    images, forward and backward -> [(FLOPs, unavoidable bytes)], as
    ``flops_swin.window_attention`` counts a window's: the two products
    forward and their four gradient products (``3 * 4 T N C`` an image);
    q, k, v and the output, and each one's gradient, read or written once
    (``8 T C`` float32 values an image), and the layer's bias table and its
    gradient."""
    out = []
    N = a.partition ** 2
    for res, _, C, depth in maxvit.stages(a, size):
        T, heads = res * res, C // a.head_dim
        work = 3 * 4 * T * N * C * n
        moved = 4 * (8 * T * C * n + 2 * (2 * a.partition - 1) ** 2 * heads)
        out += [(work, moved)] * (2 * depth)
    return out
