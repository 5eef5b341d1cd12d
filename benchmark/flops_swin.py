"""Model FLOPs of the Swin cells' work, from the published table
(``reference/swin.py``'s ``Arch``), counted as ``flops.py`` counts the
ResNet's.

A linear is ``2 * in * out`` FLOPs a token; the patch embedding (a PxP,
stride-P convolution) ``2 * 3P^2 * C`` a patch; a window's attention
``2 * 2 * N^2 * d`` a head (``q k^T`` and the weights times ``v``, N =
M^2 tokens of head dim d), so ``4 * N * C`` a token. A block at T tokens
of width C is ``24 T C^2`` in its linears (qkv 6, the projection 2, the
MLP 16) and ``4 T N C`` in its attention; a patch merging ``4 T C^2`` (T
its input's tokens). A training step counts the forward F, the weight
gradients and the data gradients (each product's two operands' gradients
for the attention's), less the patch embedding's data gradient (its input,
the augmented slices, needs none): ``3F - F_embed`` an image, and three
forwards for the head's linears. The relative position bias, the mask,
softmax, LayerNorm, GELU and the residual adds are not counted.
"""
from typing import List, Tuple

from benchmark import flops
from benchmark.reference import swin


def backbone_forward(a: swin.Arch, size: int) -> Tuple[int, int]:
    """-> (FLOPs of one image's forward, of which the patch embedding's)."""
    embed = 2 * 3 * a.patch * a.patch * a.embed_dim * (size // a.patch) ** 2
    total = embed
    table = swin.stages(a, size)
    for i, ((res, C, window, _), depth) in enumerate(zip(table, a.depths)):
        T, N = res * res, window * window
        total += depth * (2 * (3 + 1 + 2 * a.mlp_ratio) * T * C * C + 4 * T * N * C)
        if i + 1 < len(table):
            total += 4 * T * C * C
    return total, embed


def train_step(a: swin.Arch, size: int, B: int, L: int, H: int, A: int) -> int:
    f, embed = backbone_forward(a, size)
    return B * L * (3 * f - embed) + 3 * B * flops.head_forward(swin.emb_dim(a), H, A, L)


def backbone_train(a: swin.Arch, size: int, n: int) -> int:
    f, embed = backbone_forward(a, size)
    return n * (3 * f - embed)


def predict_pass(a: swin.Arch, size: int, B: int, L: int, H: int, A: int) -> int:
    f, _ = backbone_forward(a, size)
    return B * L * f + B * flops.head_forward(swin.emb_dim(a), H, A, L)


def window_attention(a: swin.Arch, size: int, n: int) -> List[Tuple[int, int]]:
    """Each block's window attention over ``n`` images, forward and
    backward -> [(FLOPs, unavoidable bytes)]: the two products forward and
    their four gradient products (``3 * 4 T N C`` an image); q, k, v and the
    output, and each one's gradient, read or written once (``8 T C``
    float32 values an image), and the bias table and its gradient."""
    out = []
    for (res, C, window, _), depth, heads in zip(swin.stages(a, size), a.depths, a.heads):
        T, N = res * res, window * window
        work = 3 * 4 * T * N * C * n
        moved = 4 * (8 * T * C * n + 2 * (2 * window - 1) ** 2 * heads)
        out += [(work, moved)] * depth
    return out
