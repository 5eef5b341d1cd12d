"""Train-mode, image-weighted BatchNorm with its residual add and ReLU, as
one ``torch.autograd.Function``: the hand-written kernels
``csrc/weighted_bn.cu`` on the card and a plain PyTorch version on the CPU.

For x [N, C, H, W], image weights w [N] (0/1, or None for all 1), gamma,
beta and the running statistics:

- ``n = sum(w) * H * W``, ``mean = sum(w * x) / n``, ``var = sum(w * (x -
  mean)^2) / n`` (the biased variance normalizes);
- ``y = relu?((x - mean) * rsqrt(var + eps) * gamma + beta [+ identity])``
  over every image, weighted or not;
- the running mean and variance move by ``(1 - momentum) * running +
  momentum * stat``, the variance's by the unbiased ``var * n / max(n - 1,
  1)``; both are outputs, detached.

The backward is written out (``gz = gy * [y > 0]`` under the ReLU, ``xh =
(x - mean) * inv``): ``dbeta = sum(gz)``, ``dgamma = sum(gz * xh)`` over
every row, ``dx = gamma * inv * (gz - (w / n) * dbeta - xh * (w / n) *
dgamma)``, and ``didentity = gz``.

On a CUDA tensor each direction is three kernel launches (the
source note gives the bound and the design); on a CPU tensor it is
``forward_plain`` / ``backward_plain``, the same arithmetic in torch ops. A
CUDA tensor launches the kernels or raises: there is no fallback.
``launch_kernel_forward`` and ``launch_kernel_backward`` take float32
[N, C, H, W] tensors in channels-last memory (the layout of the
backbone's activations) starting on 16 bytes, with ``C % 4 == 0``, and
raise on anything else; ``WeightedBN`` hands them a channels-last copy of
a tensor of another layout (autograd's gradient of a mean over H and W is
a broadcast). With no gradient wanted (the frozen step) autograd records
no node, so the Function runs its forward alone and keeps nothing for a
backward.

``launch_counts`` counts kernel launches ("kernel") and calls of the plain
version ("plain"); while tracing is on, the program counters
``backbone:bn_kernel`` and ``backbone:bn_plain`` count the calls, forward
or backward (``utils/profiling.py``). The kernels are compiled with
``nvcc`` at first use into ``build/kernels/``, as K1 is
(``ops/attention_pool.py::build_library``), and bound with ``ctypes``.
"""
import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from pd_fusion_torch.ops.attention_pool import build_library
from pd_fusion_torch.utils import profiling

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "weighted_bn.cu"

THREADS = 256  # a reduction or apply block (csrc/weighted_bn.cu::kThreads)
MAX_LANES = 64  # threads along C, four channels each: 256 channels a block
UNROLL = 4  # rows a thread loads before it adds any (kUnroll)
# Tiles are sized so that the grid is about one wave: 8 blocks of 256
# threads on each of an H100's 132 SMs. A constant, so a shape tiles the
# same way, and sums in the same order, on every card.
TARGET_BLOCKS = 8 * 132
MAX_ELEMENTS = 2**31 - 1  # the kernels index rows and tiles with 32-bit ints

launch_counts = {"kernel": 0, "plain": 0}
_lib = {}


class LaunchConfig(NamedTuple):
    lanes: int  # threads along C, four channels each
    row_lanes: int  # THREADS // lanes
    chunks: int  # blocks along C (grid y)
    tiles: int  # blocks along the rows (grid x)
    rows_per_tile: int


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=256)
def launch_config(R: int, C: int) -> LaunchConfig:
    """The kernels' tiling of a [R = N * H * W, C] activation."""
    if R < 1 or C < 4 or C % 4:
        raise ValueError(
            f"weighted_bn: needs rows >= 1 and C a positive multiple of 4; got {(R, C)}")
    lanes = min(_next_pow2(C // 4), MAX_LANES)
    row_lanes = THREADS // lanes
    chunks = -(-(C // 4) // lanes)
    step = row_lanes * UNROLL
    rows = -(-max(1, -(-R // max(1, TARGET_BLOCKS // chunks))) // step) * step
    return LaunchConfig(lanes, row_lanes, chunks, -(-R // rows), rows)


def _bcast(t):
    return t[:, None, None]


def forward_plain(x, gamma, beta, w, identity, relu, running_mean, running_var, momentum, eps):
    """The plain PyTorch version -> (y, stats = [mean (C), inv (C), n],
    new running mean, new running variance)."""
    launch_counts["plain"] += 1
    profiling.count("backbone:bn_plain")
    N, C, H, W = x.shape
    if w is None:
        mean = torch.mean(x, dim=(0, 2, 3))
        var = torch.var(x, dim=(0, 2, 3), correction=0)
        n = N * H * W
        unbiased = var * (n / max(n - 1, 1))
        n = torch.full((1,), float(n), dtype=x.dtype, device=x.device)
    else:
        wb = w[:, None, None, None]
        n = torch.sum(w) * (H * W)
        mean = torch.sum(x * wb, dim=(0, 2, 3)) / n
        var = torch.sum(torch.square(x - _bcast(mean)) * wb, dim=(0, 2, 3)) / n
        unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
    inv = torch.rsqrt(var + eps)
    y = (x - _bcast(mean)) * _bcast(inv * gamma) + _bcast(beta)
    if identity is not None:
        y = y + identity
    if relu:
        y = torch.relu(y)
    new_mean = (1.0 - momentum) * running_mean + momentum * mean
    new_var = (1.0 - momentum) * running_var + momentum * unbiased
    return y, torch.cat([mean, inv, n.reshape(1)]), new_mean, new_var


def backward_plain(gy, x, y, stats, gamma, w, relu, has_identity):
    """The plain backward -> (dx, dgamma, dbeta, didentity); didentity is
    None without ``has_identity``."""
    launch_counts["plain"] += 1
    profiling.count("backbone:bn_plain")
    C = x.shape[1]
    mean, inv, n = stats[:C], stats[C:2 * C], stats[2 * C]
    gz = torch.where(y > 0, gy, 0.0) if relu else gy
    xh = (x - _bcast(mean)) * _bcast(inv)
    dbeta = torch.sum(gz, dim=(0, 2, 3))
    dgamma = torch.sum(gz * xh, dim=(0, 2, 3))
    wn = (1.0 / n) if w is None else (w / n)[:, None, None, None]
    dx = _bcast(gamma * inv) * (gz - wn * _bcast(dbeta) - xh * (wn * _bcast(dgamma)))
    return dx, dgamma, dbeta, (gz if has_identity else None)


def _library():
    if "lib" not in _lib:
        lib = ctypes.CDLL(str(build_library(SOURCE)))
        lib.wbn_forward.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.wbn_backward.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.wbn_forward.restype = lib.wbn_backward.restype = ctypes.c_int
        _lib["lib"] = lib
    return _lib["lib"]


def takes(t) -> bool:
    """``t`` is laid out as the kernels read it: channels-last memory
    starting on 16 bytes."""
    return t.is_contiguous(memory_format=torch.channels_last) and t.data_ptr() % 16 == 0


def _check_activation(name, t, like):
    if t.dtype != torch.float32:
        raise TypeError(f"weighted_bn: {name} must be float32, got {t.dtype}")
    if t.device.type != "cuda" or t.device != like.device:
        raise ValueError(f"weighted_bn: {name} must be on the CUDA device of x; got {t.device}")
    if t.shape != like.shape:
        raise ValueError(f"weighted_bn: {name} has shape {tuple(t.shape)}, x {tuple(like.shape)}")
    if not takes(t):
        raise ValueError(f"weighted_bn: {name} must be channels-last on 16 bytes; strides "
                         f"{t.stride()}, address {t.data_ptr()}")


def _check_vector(name, t, n, like):
    if (t.dtype != torch.float32 or t.device != like.device or t.shape != (n,)
            or t.stride() != (1,)):
        raise ValueError(f"weighted_bn: {name} must be a contiguous float32 [{n}] on {like.device}; "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_x(x):
    if x.dim() != 4:
        raise ValueError(f"weighted_bn: x must be [N, C, H, W]; got {tuple(x.shape)}")
    _check_activation("x", x, x)
    if x.numel() > MAX_ELEMENTS:
        raise ValueError(f"weighted_bn: {tuple(x.shape)} is too large for 32-bit row indices")
    return launch_config(x.shape[0] * x.shape[2] * x.shape[3], x.shape[1])


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_kernel_forward(x, gamma, beta, w, identity, relu, running_mean, running_var,
                          momentum, eps):
    """The forward's three launches on checked CUDA tensors -> as
    ``forward_plain``."""
    cfg = _check_x(x)
    N, C, H, W = x.shape
    if identity is not None:
        _check_activation("identity", identity, x)
    for name, t in (("gamma", gamma), ("beta", beta), ("running_mean", running_mean),
                    ("running_var", running_var)):
        _check_vector(name, t, C, x)
    if w is not None:
        _check_vector("w", w, N, x)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    part = torch.empty(cfg.tiles * (3 * C + 1), dtype=torch.float32, device=x.device)
    stats = torch.empty(2 * C + 1, dtype=torch.float32, device=x.device)
    new_mean, new_var = torch.empty_like(running_mean), torch.empty_like(running_var)
    with torch.cuda.device(x.device):
        err = _library().wbn_forward(
            x.data_ptr(), _ptr(w), _ptr(identity), gamma.data_ptr(), beta.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(), 1.0 - momentum, momentum, eps,
            y.data_ptr(), part.data_ptr(), stats.data_ptr(), new_mean.data_ptr(),
            new_var.data_ptr(), N * H * W, C, H * W, cfg.lanes, cfg.chunks, cfg.tiles,
            cfg.rows_per_tile, int(relu), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"weighted_bn forward launch failed: CUDA error {err} ({cfg})")
    launch_counts["kernel"] += 3
    profiling.count("backbone:bn_kernel")
    return y, stats, new_mean, new_var


def launch_kernel_backward(gy, x, y, stats, gamma, w, relu, has_identity):
    """The backward's three launches on checked CUDA tensors -> as
    ``backward_plain``."""
    cfg = _check_x(x)
    N, C, H, W = x.shape
    _check_activation("gy", gy, x)
    if relu:
        _check_activation("y", y, x)
    _check_vector("stats", stats, 2 * C + 1, x)
    _check_vector("gamma", gamma, C, x)
    if w is not None:
        _check_vector("w", w, N, x)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    did = torch.empty_like(x, memory_format=torch.channels_last) if has_identity else None
    dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(gamma)
    part = torch.empty(2 * cfg.tiles * C, dtype=torch.float32, device=x.device)
    coef = torch.empty(3 * C, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().wbn_backward(
            gy.data_ptr(), _ptr(y), x.data_ptr(), _ptr(w), stats.data_ptr(),
            gamma.data_ptr(), _ptr(dx), _ptr(did), dgamma.data_ptr(), dbeta.data_ptr(),
            part.data_ptr(), coef.data_ptr(), N * H * W, C, H * W, cfg.lanes, cfg.chunks,
            cfg.tiles, cfg.rows_per_tile, int(relu), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"weighted_bn backward launch failed: CUDA error {err} ({cfg})")
    launch_counts["kernel"] += 3
    profiling.count("backbone:bn_kernel")
    return dx, dgamma, dbeta, did


def _taken(t):
    """``t`` as the kernels take it: itself, or a channels-last copy."""
    return t if t is None or takes(t) else t.clone(memory_format=torch.channels_last)


def _forward(x, gamma, beta, w, identity, relu, running_mean, running_var, momentum, eps):
    if x.device.type == "cuda":
        return launch_kernel_forward(_taken(x), gamma.contiguous(), beta.contiguous(), w,
                                     _taken(identity), relu, running_mean.contiguous(),
                                     running_var.contiguous(), momentum, eps)
    if x.device.type == "cpu":
        return forward_plain(x, gamma, beta, w, identity, relu, running_mean, running_var,
                             momentum, eps)
    raise ValueError(f"weighted_bn: unsupported device {x.device}")


class WeightedBN(torch.autograd.Function):
    """(x, gamma, beta, identity or None, w or None, running mean, running
    variance, momentum, eps, relu) -> (y, new running mean, new running
    variance); differentiable in x, gamma, beta and the identity."""

    @staticmethod
    def forward(ctx, x, gamma, beta, identity, w, running_mean, running_var, momentum, eps, relu):
        y, stats, new_mean, new_var = _forward(x, gamma, beta, w, identity, relu, running_mean,
                                               running_var, momentum, eps)
        ctx.relu, ctx.has_identity = relu, identity is not None
        ctx.save_for_backward(x, y if relu else None, stats, gamma, w)
        ctx.mark_non_differentiable(new_mean, new_var)
        return y, new_mean, new_var

    @staticmethod
    def backward(ctx, gy, _g_mean, _g_var):
        x, y, stats, gamma, w = ctx.saved_tensors
        if x.device.type == "cuda":
            dx, dgamma, dbeta, did = launch_kernel_backward(
                _taken(gy), _taken(x), _taken(y), stats, gamma.contiguous(), w, ctx.relu,
                ctx.has_identity)
        else:
            dx, dgamma, dbeta, did = backward_plain(gy, x, y, stats, gamma, w, ctx.relu,
                                                    ctx.has_identity)
        return dx, dgamma, dbeta, did, None, None, None, None, None, None


def bn_train(x, p, momentum, eps, w=None, identity=None, relu=False):
    """Train-mode weighted BN of ``x`` with BN params ``p`` (``gamma``,
    ``beta``, ``mean``, ``var``), then ``+ identity`` and ReLU if asked ->
    (output, ``p`` with the new running statistics), through
    ``WeightedBN``."""
    if w is not None:
        w = w.to(dtype=x.dtype).contiguous()
    y, new_mean, new_var = WeightedBN.apply(x, p["gamma"], p["beta"], identity, w, p["mean"],
                                            p["var"], momentum, eps, relu)
    return y, dict(p, mean=new_mean, var=new_var)
