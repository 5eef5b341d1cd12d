"""The mean-pooled ResNet slice embedding of a NIfTI volume in plain PyTorch
and numpy, float32, from the file: the reference of the ``embed_build``
cells.

Written from the method, not from the program: the NIfTI-1 single-file
layout (the 348-byte header: ``dim`` at byte 40, ``datatype`` at 70,
``vox_offset`` at 108, ``scl_slope`` and ``scl_inter`` at 112 and 116;
the voxels in Fortran order, x fastest; gzip when the name ends in
``.gz``), the stored values scaled by ``slope * v + inter`` where the
header asks (a slope that is neither 0 nor 1, or an intercept); an
align-corners trilinear resize to the target shape
(``F.interpolate(mode="trilinear", align_corners=True)``); a 1-99
percentile clip over the positive voxels (linear interpolation between
order statistics, numpy's default) and the map to [0, 1] by ``(v - lo) /
(hi - lo + 1e-6)``; ``count`` slices along the axis at
``linspace(first, last, count)`` truncated to integers over the extent of
slices that hold a positive voxel; the ImageNet resize and
normalization of ``reference/mil_ft.py``; the ResNet of
``reference/resnet.py`` in evaluation (running statistics, no fold); the
mean over a volume's slices.
"""
import gzip
import struct
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import resnet
from benchmark.reference.mil_ft import imagenet_batch

_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
           256: np.int8, 512: np.uint16, 768: np.uint32}


def read_nifti(path) -> np.ndarray:
    """A single-file NIfTI-1 -> float32 [dim1, dim2, dim3] (index x, y, z)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    endian = "<" if struct.unpack("<i", raw[:4])[0] == 348 else ">"
    dims = struct.unpack(endian + "8h", raw[40:56])
    code = struct.unpack(endian + "h", raw[70:72])[0]
    offset = int(struct.unpack(endian + "f", raw[108:112])[0])
    slope, inter = struct.unpack(endian + "2f", raw[112:120])
    shape = tuple(int(d) for d in dims[1:1 + dims[0]])
    dtype = np.dtype(_DTYPES[code]).newbyteorder(endian)
    vol = np.frombuffer(raw, dtype, count=int(np.prod(shape)), offset=offset)
    vol = vol.reshape(shape, order="F").astype(np.float32)
    if np.isfinite(slope) and slope not in (0.0, 1.0):
        vol = vol * np.float32(slope) + np.float32(inter if np.isfinite(inter) else 0.0)
    elif np.isfinite(inter) and inter != 0.0:
        vol = vol + np.float32(inter)
    return vol


def prep(path, target_shape: Sequence[int], axis: int, count: int, device) -> torch.Tensor:
    """One volume -> its ``count`` normalized slices [count, h, w] on ``device``."""
    vol = torch.as_tensor(read_nifti(path), device=device)
    vol = F.interpolate(vol[None, None], size=tuple(int(t) for t in target_shape),
                        mode="trilinear", align_corners=True)[0, 0]
    positive = vol[vol > 0]
    if positive.numel():
        lo, hi = torch.quantile(positive, torch.tensor([0.01, 0.99], device=device))
    else:
        lo, hi = vol.min(), vol.max()
    vol = (torch.clamp(vol, lo, hi) - lo) / (hi - lo + 1e-6)
    other = tuple(d for d in range(3) if d != axis)
    held = torch.nonzero(torch.any(vol > 0, dim=other))[:, 0]
    first, last = (int(held[0]), int(held[-1])) if held.numel() else (0, vol.shape[axis] - 1)
    index = torch.as_tensor(np.linspace(first, last, count).astype(int), device=device)
    return torch.movedim(torch.index_select(vol, axis, index), axis, 0).contiguous()


@torch.no_grad()
def embed(bp, slices: torch.Tensor, arch: str, size: int, mean, std,
          used: int = None) -> torch.Tensor:
    """[count, h, w] slices -> the mean over the first ``used`` (all by
    default) slices' embeddings [emb]."""
    x = imagenet_batch(slices, size, mean, std)
    emb, _ = resnet.forward(bp, x, arch, train=False)
    return emb[:used].mean(dim=0)
