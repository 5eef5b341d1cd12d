"""Masked-softmax attention pooling for MIL: the CUDA kernel K1 and its
plain PyTorch version (port of ``pd_fusion/ops/pallas_mil.py``).

Per bag: ``masked = where(mask > 0, score, -1e9)``, ``w = softmax(masked)``
(max-subtracted), ``pooled = sum_l w_l * h_l``. ``attention_pool`` is a
``torch.autograd.Function``:
- forward: on a CUDA tensor, the hand-written kernel
  ``csrc/attention_pool.cu`` (it replaces the Pallas TPU kernel
  ``_attention_pool_kernel``; its source note gives the bound); on a CPU
  tensor, ``attention_pool_reference``, which mirrors ``_xla_pool``. A
  CUDA tensor launches the kernel or raises: there is no fallback.
- backward: plain torch ops, term for term ``_pool_bwd`` (the JAX
  package's backward is XLA, not a kernel): ``g_w = g_pooled . h +
  g_w_direct``, ``g_scores = w * (g_w - sum(w * g_w))``, ``g_h = w (x)
  g_pooled``, no mask gradient.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use, into
``build/kernels/`` keyed on a hash of the source and flags, and bound with
``ctypes``. ``launch_counts`` counts kernel launches ("kernel") and calls
of the plain version ("plain"), so a run can show which one it went
through.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from pd_fusion_torch.paths import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "attention_pool.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
MASKED_SCORE = -1e9

launch_counts = {"kernel": 0, "plain": 0}
_lib = {}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def attention_pool_reference(scores, mask, h):
    """Plain PyTorch version (mirrors ``_xla_pool``): ([B,H] pooled, [B,L] weights)."""
    launch_counts["plain"] += 1
    masked = torch.where(mask > 0, scores, MASKED_SCORE)
    weights = torch.softmax(masked, dim=1)
    pooled = torch.einsum("bl,blh->bh", weights, h)
    return pooled, weights


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def build_library() -> Path:
    """Compile ``csrc/attention_pool.cu`` into a shared library (cached by
    a hash of the source and flags). The compiler's output (``-Xptxas=-v``:
    registers, shared memory, spills) is kept beside it as ``.log``."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"attention_pool_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCE}:\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


def _forward_fn():
    if "fwd" not in _lib:
        lib = ctypes.CDLL(str(build_library()))
        fn = lib.attention_pool_forward
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib["handle"], _lib["fwd"] = lib, fn
    return _lib["fwd"]


def _check_inputs(scores, mask, h):
    if scores.dim() != 2 or mask.shape != scores.shape:
        raise ValueError(f"scores and mask must be [B, L]; got {tuple(scores.shape)}, {tuple(mask.shape)}")
    if h.dim() != 3 or h.shape[:2] != scores.shape:
        raise ValueError(f"h must be [B, L, H] matching scores; got {tuple(h.shape)}")
    if scores.shape[1] < 1 or h.shape[2] < 1:
        raise ValueError(f"attention_pool needs L >= 1 and H >= 1; got {tuple(h.shape)}")
    for name, t in (("scores", scores), ("mask", mask), ("h", h)):
        if t.dtype != torch.float32:
            raise TypeError(f"attention_pool: {name} must be float32, got {t.dtype}")
        if t.device != scores.device:
            raise ValueError(f"attention_pool: {name} is on {t.device}, scores on {scores.device}")
        if not t.is_contiguous():
            raise ValueError(f"attention_pool: {name} must be contiguous")
    if max(h.shape) >= 2**31:
        raise ValueError(f"attention_pool: dimension too large for the kernel: {tuple(h.shape)}")


def _launch_kernel(scores, mask, h):
    B, L = scores.shape
    H = h.shape[2]
    pooled = torch.empty((B, H), dtype=torch.float32, device=scores.device)
    weights = torch.empty((B, L), dtype=torch.float32, device=scores.device)
    if B == 0:
        return pooled, weights
    fn = _forward_fn()
    with torch.cuda.device(scores.device):
        err = fn(
            scores.data_ptr(), mask.data_ptr(), h.data_ptr(), pooled.data_ptr(),
            weights.data_ptr(), B, L, H, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_pool kernel launch failed: CUDA error {err}")
    launch_counts["kernel"] += 1
    return pooled, weights


def attention_pool_forward(scores, mask, h):
    """Forward only: the kernel for CUDA tensors, the plain version for
    CPU tensors; anything else raises."""
    _check_inputs(scores, mask, h)
    if scores.device.type == "cuda":
        return _launch_kernel(scores, mask, h)
    if scores.device.type == "cpu":
        return attention_pool_reference(scores, mask, h)
    raise ValueError(f"attention_pool: unsupported device {scores.device}")


class AttentionPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, mask, h):
        pooled, weights = attention_pool_forward(scores, mask, h)
        ctx.save_for_backward(weights, h)
        return pooled, weights

    @staticmethod
    def backward(ctx, g_pooled, g_weights_direct):
        weights, h = ctx.saved_tensors
        g_w = torch.einsum("bh,blh->bl", g_pooled, h) + g_weights_direct
        dot = torch.sum(weights * g_w, dim=1, keepdim=True)
        g_scores = weights * (g_w - dot)
        g_h = torch.einsum("bl,bh->blh", weights, g_pooled)
        return g_scores, None, g_h


def attention_pool(scores, mask, h):
    """[B,L] scores, [B,L] mask, [B,L,H] instances -> ([B,H] pooled,
    [B,L] attention weights), differentiable in scores and h."""
    return AttentionPool.apply(scores, mask, h)
