"""Masked-softmax attention pooling for MIL: the CUDA kernel K1 and its
plain PyTorch version (port of ``pd_fusion/ops/pallas_mil.py``).

Per bag: ``masked = where(mask > 0, score, -1e9)``, ``w = softmax(masked)``
(max-subtracted), ``pooled = sum_l w_l * h_l``. ``attention_pool`` is a
``torch.autograd.Function``:
- forward: on a CUDA tensor, the hand-written kernel
  ``csrc/attention_pool.cu`` (it replaces the Pallas TPU kernel
  ``_attention_pool_kernel``; its source note gives the bound and the
  design), launched with the values of ``launch_config``; on a CPU
  tensor, ``attention_pool_reference``, which mirrors ``_xla_pool``. A
  CUDA tensor launches the kernel or raises: there is no fallback. An
  ``h`` whose rows do not start on 16 bytes takes the kernel's scalar
  path, not the plain version.
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
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

from pd_fusion_torch.paths import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "attention_pool.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
MASKED_SCORE = -1e9

# What one block may have on an H100 (sm_90), and the kernel's own limits.
SMEM_LIMIT = 232_448
THREADS_LIMIT = 1024
GRID_Y_LIMIT = 65_535
WARPS = 4  # per block, each on its own columns (the kernel's __launch_bounds__: 256 threads)

# Launch policy (timed on an H100 by chip_smoke.py; PERF.md). CHUNK:
# columns per block, narrowed (down to MIN_CHUNK) while the grid has fewer
# than MIN_BLOCKS blocks. A block's h tile of up to WHOLE_TILE_BYTES and
# STAGE_ROWS rows is copied in one go; a larger one is staged through two
# buffers of up to STAGE_BYTES and STAGE_ROWS rows each.
CHUNK = 64
MIN_CHUNK = 16
MIN_BLOCKS = 64
WHOLE_TILE_BYTES = 96 * 1024
STAGE_BYTES = 32 * 1024
STAGE_ROWS = 256  # each warp keeps a stage's weights in shared memory
PATHS = {"scalar": 0, "vec4": 1}  # csrc/attention_pool.cu::Path

launch_counts = {"kernel": 0, "plain": 0}
_lib = {}
_configured_devices = set()


class LaunchConfig(NamedTuple):
    grid: tuple  # (B, column chunks): one block per bag and chunk
    block: int  # threads
    smem_bytes: int  # dynamic shared memory
    path: str  # "scalar" or "vec4" (16-byte cp.async, float4)
    chunk: int  # columns per block
    stage_rows: int  # rows per shared-memory buffer
    n_buffers: int  # 1: the tile whole; 2: staged in a loop over L


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=256)
def launch_config(B: int, L: int, H: int, aligned: bool) -> LaunchConfig:
    """The launch values of K1 for ``h`` of shape [B, L, H]; ``aligned``:
    ``h``'s pointer is on 16 bytes. The float4 path needs that and
    ``H % 4 == 0``; otherwise the path is "scalar"."""
    if min(B, L, H) < 1:
        raise ValueError(f"launch_config needs B, L, H >= 1; got {(B, L, H)}")
    path = "vec4" if aligned and H % 4 == 0 else "scalar"
    vec = 4 if path == "vec4" else 1
    chunk = min(CHUNK, vec * _next_pow2(-(-H // vec)))
    while chunk > MIN_CHUNK and B * -(-H // chunk) < MIN_BLOCKS:
        chunk //= 2
    warps = min(WARPS, chunk // vec)  # each on an equal power-of-two share of the column vectors
    row_bytes = 4 * chunk
    if L <= min(STAGE_ROWS, WHOLE_TILE_BYTES // row_bytes):
        stage_rows, n_buffers = L, 1
    else:
        stage_rows, n_buffers = min(STAGE_ROWS, STAGE_BYTES // row_bytes), 2
    # the kernel's layout: each warp's weights (padded to 16 bytes), h's buffers
    smem = 16 * -(-warps * stage_rows // 4) + n_buffers * stage_rows * row_bytes
    grid = (B, -(-H // chunk))
    if grid[0] >= 2**31 or grid[1] > GRID_Y_LIMIT:
        raise ValueError(f"attention_pool: grid {grid} too large for {(B, L, H)}")
    return LaunchConfig(grid, 32 * warps, smem, path, chunk, stage_rows, n_buffers)


def is_aligned(h: torch.Tensor) -> bool:
    """``h``'s first element lies on a 16-byte boundary."""
    return h.data_ptr() % 16 == 0


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


def build_library(source: Path = SOURCE) -> Path:
    """Compile ``source`` (by default ``csrc/attention_pool.cu``) into a
    shared library, cached by a hash of the source and flags. The
    compiler's output (``-Xptxas=-v``: registers, shared memory, spills) is
    kept beside it as ``.log``."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source}:\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


def _library():
    if "lib" not in _lib:
        lib = ctypes.CDLL(str(build_library()))
        lib.attention_pool_forward.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        lib.attention_pool_forward.restype = ctypes.c_int
        lib.attention_pool_configure.restype = ctypes.c_int
        _lib["lib"] = lib
    return _lib["lib"]


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


def launch_kernel(scores, mask, h):
    """One launch of K1 on CUDA tensors (checked by the caller), with the
    values of ``launch_config`` for the shapes and ``h``'s alignment.
    -> ([B,H] pooled, [B,L] weights)."""
    B, L = scores.shape
    H = h.shape[2]
    pooled = torch.empty((B, H), dtype=torch.float32, device=scores.device)
    weights = torch.empty((B, L), dtype=torch.float32, device=scores.device)
    if B == 0:
        return pooled, weights
    cfg = launch_config(B, L, H, is_aligned(h))
    lib = _library()
    with torch.cuda.device(scores.device):
        device = torch.cuda.current_device()
        if device not in _configured_devices:
            err = lib.attention_pool_configure()
            if err != 0:
                raise RuntimeError(f"attention_pool: configuring the kernel: CUDA error {err}")
            _configured_devices.add(device)
        err = lib.attention_pool_forward(
            scores.data_ptr(), mask.data_ptr(), h.data_ptr(), pooled.data_ptr(),
            weights.data_ptr(), L, H, *cfg.grid, cfg.block, cfg.smem_bytes, PATHS[cfg.path],
            cfg.chunk, cfg.stage_rows, cfg.n_buffers,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_pool kernel launch failed: CUDA error {err} ({cfg})")
    launch_counts["kernel"] += 1
    return pooled, weights


def attention_pool_forward(scores, mask, h):
    """Forward only: the kernel for CUDA tensors, the plain version for
    CPU tensors; anything else raises."""
    _check_inputs(scores, mask, h)
    if scores.device.type == "cuda":
        return launch_kernel(scores, mask, h)
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
