"""3-D convolutional autoencoder for volume embeddings (port of
``pd_fusion/nn/cnn3d.py``).

Encoder: 3 x [Conv3d(k3, pad 1) + ReLU + MaxPool3d(2)], channels 1 -> 8 ->
16 -> 32, then a linear bottleneck to ``embedding_dim``; decoder: a linear
layer back to the bottleneck's volume and 3 x ConvTranspose3d(k2, stride
2), ReLU after the first two. Trained on the MSE of the reconstruction
with Adam; the bottleneck is the embedding.

Layout: NCDHW, torch's. Parameters are a dict of layers, each ``{"w",
"b"}``: conv weights ``(cout, cin, kd, kh, kw)``, transposed-conv weights
``(cin, cout, kd, kh, kw)``, linear weights ``(in, out)`` as in the JAX
package. ``params_from_jax`` carries a JAX pytree (DHWIO) over:

- a convolution's weight is permuted, with no flip;
- ``lax.conv_transpose(transpose_kernel=False)`` is the gradient-free
  "fractionally strided" convolution with the kernel as given, which is
  ``conv_transpose3d`` of the kernel flipped in all three spatial axes;
- the JAX package flattens the bottleneck channels-last (NDHWC) and
  reshapes the decoder's input to ``(n, d/8, h/8, w/8, 32)``; here the
  bottleneck is permuted to channels-last before the flatten and back
  after the reshape, so the ``fc``/``fc_dec`` weights and the embeddings
  are the JAX package's, untouched.

Training (``train_cnn3d``) steps each batch as it is formed: per epoch a
permutation, padded with index 0 at weight 0 to whole batches, and the
loss ``sum(per_volume_mse * w) / max-safe(sum(w))``, as the JAX scan.
The permutations are given (``perms``, one per epoch: the tests feed the
JAX package's draws) or drawn by ``torch.randperm`` from an explicit
generator on the volumes' device. Adam is optax's (``nn/ft_optim.py``:
betas 0.9/0.999, eps 1e-8 outside the bias-corrected square root).

Data parallelism (``group=``; the JAX builder shards the volume batch
over a data mesh, the counterpart of the upstream ``nn.DataParallel``):
``volumes`` holds this rank's contiguous share of the rows, every rank
draws the same global permutation, each rank steps the batch's rows it
owns (the others' loss terms are theirs) over the batch's global weight,
and the gradients are summed over the group before the Adam step. The
embeddings are gathered in row order on every rank.

No hand kernel: the JAX module reaches no Pallas kernel (XLA
convolutions, reduce-window and optax), so the convolutions are torch's
(TF32 off, ``utils/device.py``). Their forward and data gradients are
cuDNN's; their weight gradients are written as batched matrix products
(``_Conv3x3``, ``_Deconv2``): on an H100 cuDNN's float32 weight-gradient
kernel takes over nine tenths of a step at 64^3, and a step through it is
4.5-10x slower (PERF.md). The products sum the same
terms in another order.
"""
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pd_fusion_torch.nn import ft_optim
from pd_fusion_torch.parallel.distributed import all_reduce_grads, gather_rows, row_span

ENCODER = (("enc1", 1, 8), ("enc2", 8, 16), ("enc3", 16, 32))
DECODER = (("dec1", 32, 16), ("dec2", 16, 8), ("dec3", 8, 1))
LAYERS = ("enc1", "enc2", "enc3", "fc", "fc_dec", "dec1", "dec2", "dec3")


def ae_enc_shape(input_shape: Tuple[int, int, int]) -> Tuple[int, int, int, int]:
    """The bottleneck volume (d/8, h/8, w/8, 32), channels last."""
    d, h, w = input_shape
    return (d // 8, h // 8, w // 8, 32)


def _uniform(g, shape, bound, device):
    return (torch.rand(shape, generator=g, dtype=torch.float32) * 2.0 - 1.0).mul_(bound).to(device)


def cnn3d_init(generator: torch.Generator, input_shape=(96, 96, 96), embedding_dim=128,
               device=None) -> Dict:
    """Uniform(+-sqrt(1/fan_in)) weights and biases, the JAX package's init
    law, drawn from ``generator`` (a CPU generator: the same draws on any
    device)."""
    enc_dim = int(np.prod(ae_enc_shape(input_shape)))
    params = {}
    for name, cin, cout in ENCODER:
        bound = math.sqrt(1.0 / (27 * cin))
        params[name] = {"w": _uniform(generator, (cout, cin, 3, 3, 3), bound, device),
                        "b": _uniform(generator, (cout,), bound, device)}
    for name, fan_in, fan_out in (("fc", enc_dim, embedding_dim),
                                  ("fc_dec", embedding_dim, enc_dim)):
        bound = math.sqrt(1.0 / fan_in)
        params[name] = {"w": _uniform(generator, (fan_in, fan_out), bound, device),
                        "b": _uniform(generator, (fan_out,), bound, device)}
    for name, cin, cout in DECODER:
        bound = math.sqrt(1.0 / (8 * cin))
        params[name] = {"w": _uniform(generator, (cin, cout, 2, 2, 2), bound, device),
                        "b": _uniform(generator, (cout,), bound, device)}
    return params


def params_from_jax(np_params: Dict, device=None) -> Dict:
    """A JAX ``cnn3d_init`` pytree (numpy leaves, DHWIO kernels) -> the
    port's parameters."""
    def t(a):
        return torch.tensor(np.array(a, dtype=np.float32, copy=True), device=device)

    out = {}
    for name in LAYERS:
        w = np.asarray(np_params[name]["w"])
        if name.startswith("enc"):
            w = w.transpose(4, 3, 0, 1, 2)
        elif name.startswith("dec"):
            w = w[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
        out[name] = {"w": t(w), "b": t(np_params[name]["b"])}
    return out


def params_to(params: Dict, device) -> Dict:
    return {k: {kk: v.to(device) for kk, v in layer.items()} for k, layer in params.items()}


def leaves(params: Dict) -> List[torch.Tensor]:
    """The parameters in a fixed order (``LAYERS``, then w, b)."""
    return [params[name][k] for name in LAYERS for k in ("w", "b")]


def from_leaves(flat: Sequence[torch.Tensor]) -> Dict:
    return {name: {"w": flat[2 * i], "b": flat[2 * i + 1]} for i, name in enumerate(LAYERS)}


def _patches(x: torch.Tensor) -> torch.Tensor:
    """[B, C, D, H, W] -> [B, C * 27, D * H * W]: the 27 shifts of the
    1-padded input, channel-major as a (cout, cin, 3, 3, 3) weight is."""
    B, C, D, H, W = x.shape
    xp = F.pad(x, (1, 1, 1, 1, 1, 1))
    cols = torch.stack([xp[:, :, i:i + D, j:j + H, k:k + W]
                        for i in range(3) for j in range(3) for k in range(3)], 2)
    return cols.reshape(B, C * 27, D * H * W)


def _batched_outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over the batch of a [B, M, V] @ b [B, N, V]^T -> [M, N]. With a
    small output (M * N < 1024: the first layer's 8 x 27, the last
    decoder's 8 x 8) one product per volume leaves most of the card idle
    on its V-long sums, so V is cut into up to 32 chunks, each a product
    of its own."""
    B, M, V = a.shape
    N = b.shape[1]
    c = math.gcd(V, 32) if M * N < 1024 else 1
    a = a.reshape(B, M, c, V // c).transpose(1, 2)
    b = b.reshape(B, N, c, V // c).transpose(1, 2)
    return torch.matmul(a, b.transpose(-1, -2)).sum((0, 1))


class _Conv3x3(torch.autograd.Function):
    """Conv3d(k3, pad 1): forward and data gradient by cuDNN, weight
    gradient as sum over the batch of grad [cout, V] @ patches^T [V, cin*27]."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return F.conv3d(x, w, b, padding=1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        B, co = g.shape[:2]
        gx = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv3d_input(x.shape, w, g, padding=1)
        gw = _batched_outer(g.reshape(B, co, -1), _patches(x))
        return gx, gw.reshape(w.shape), g.sum((0, 2, 3, 4))


class _Deconv2(torch.autograd.Function):
    """ConvTranspose3d(k2, stride 2): every input voxel maps to its own
    2x2x2 output block. Forward by cuDNN, data gradient the strided
    Conv3d, weight gradient sum over the batch of x [cin, V] @ the grad's
    blocks [V, cout*8]."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return F.conv_transpose3d(x, w, b, stride=2)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        B, ci, d, h, wd = x.shape
        co = g.shape[1]
        gx = F.conv3d(g, w, stride=2) if ctx.needs_input_grad[0] else None
        blocks = g.reshape(B, co, d, 2, h, 2, wd, 2).permute(0, 1, 3, 5, 7, 2, 4, 6)
        gw = _batched_outer(x.reshape(B, ci, -1), blocks.reshape(B, co * 8, -1))
        return gx, gw.reshape(w.shape), g.sum((0, 2, 3, 4))


def cnn3d_apply(params: Dict, x: torch.Tensor, input_shape):
    """x [N, 1, D, H, W] -> (reconstruction [N, 1, D, H, W], embedding [N, E])."""
    z = x
    for name, _, _ in ENCODER:
        z = F.max_pool3d(F.relu(_Conv3x3.apply(z, params[name]["w"], params[name]["b"])), 2)
    n = z.shape[0]
    d, h, w, c = ae_enc_shape(tuple(input_shape))
    emb = z.permute(0, 2, 3, 4, 1).reshape(n, -1) @ params["fc"]["w"] + params["fc"]["b"]
    r = emb @ params["fc_dec"]["w"] + params["fc_dec"]["b"]
    r = r.reshape(n, d, h, w, c).permute(0, 4, 1, 2, 3)
    for i, (name, _, _) in enumerate(DECODER):
        r = _Deconv2.apply(r, params[name]["w"], params[name]["b"])
        if i < len(DECODER) - 1:
            r = F.relu(r)
    return r, emb


def recon_loss(params: Dict, xb: torch.Tensor, wb: torch.Tensor, input_shape,
               total=None) -> torch.Tensor:
    """Weighted mean over the batch of each volume's reconstruction MSE; a
    batch of weight 0 gives 0, not 0/0. ``total`` replaces ``sum(wb)`` (the
    whole batch's weight, for one rank's rows of it)."""
    recon, _ = cnn3d_apply(params, xb, input_shape)
    per = torch.mean((recon - xb) ** 2, dim=(1, 2, 3, 4))
    t = torch.sum(wb) if total is None else torch.as_tensor(total, dtype=per.dtype,
                                                            device=per.device)
    return torch.sum(per * wb) / torch.where(t > 0, t, torch.ones_like(t))


def init_opt(params: Dict) -> Dict:
    return ft_optim.init_group(leaves(params))


def train_step(params: Dict, opt: Dict, xb: torch.Tensor, wb: torch.Tensor, lr: float,
               input_shape, group=None, total=None):
    """One Adam step on one batch. ``opt`` is updated in place. -> (new
    params, the batch's loss before the step). With ``group``: ``xb`` is
    this rank's rows of the batch, ``total`` the batch's weight, and the
    gradients are summed over the group."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss = recon_loss(from_leaves(flat), xb, wb, input_shape, total)
    grads = torch.autograd.grad(loss, flat)
    if group is not None:
        grads = all_reduce_grads(grads, group)
    with torch.no_grad():
        new = ft_optim.adam_update([p.detach() for p in flat], list(grads), opt, lr)
    return from_leaves(new), loss.detach()


def epoch_batches(perm: torch.Tensor, batch_size: int):
    """A permutation of n -> (indices [n_batches, batch_size], weights
    [n_batches, batch_size]): padded with index 0 at weight 0."""
    n = perm.numel()
    n_batches = -(-n // batch_size)
    pad = n_batches * batch_size - n
    idx = torch.cat([perm.long(), perm.new_zeros(pad, dtype=torch.long)])
    w = torch.cat([torch.ones(n, device=perm.device), torch.zeros(pad, device=perm.device)])
    return idx.reshape(n_batches, batch_size), w.reshape(n_batches, batch_size)


def train_cnn3d(params: Dict, volumes: torch.Tensor, lr: float, input_shape, epochs: int,
                batch_size: int, generator: Optional[torch.Generator] = None,
                perms: Optional[Sequence] = None, group=None) -> Dict:
    """MSE reconstruction training on ``volumes`` [N, 1, D, H, W]. Each
    epoch's permutation is ``perms[e]`` when given, else
    ``torch.randperm(N, generator=generator)`` on the volumes' device.
    With ``group``: ``volumes`` is this rank's share and N the group's."""
    dev = volumes.device
    lo, n = row_span(volumes.shape[0], group)
    opt = init_opt(params)
    for e in range(epochs):
        if perms is not None:
            perm = torch.as_tensor(np.array(perms[e]), device=dev)
        else:
            perm = torch.randperm(n, generator=generator, device=dev)
        idx, w = epoch_batches(perm, batch_size)
        for b in range(idx.shape[0]):
            if group is None:
                params, _ = train_step(params, opt, volumes[idx[b]], w[b], lr, input_shape)
                continue
            rows = idx[b].cpu()
            own = ((rows >= lo) & (rows < lo + volumes.shape[0]) & (w[b].cpu() > 0)).nonzero()
            own = own[:, 0]
            # a rank with no row of the batch steps row 0 at weight 0
            local = rows[own] - lo if own.numel() else torch.zeros(1, dtype=torch.long)
            wb = w[b][own.to(dev)] if own.numel() else torch.zeros(1, device=dev)
            params, _ = train_step(params, opt, volumes[local.to(dev)], wb, lr, input_shape,
                                   group, total=float(w[b].sum()))
    return params


def cnn3d_embed(params: Dict, volumes: torch.Tensor, input_shape, group=None) -> torch.Tensor:
    """[N, 1, D, H, W] -> embeddings [N, E], one forward. With ``group``:
    this rank's share of the rows in, every rank's embeddings out, in row
    order."""
    with torch.no_grad():
        emb = cnn3d_apply(params, volumes, input_shape)[1]
    return emb if group is None else gather_rows(emb, group)
