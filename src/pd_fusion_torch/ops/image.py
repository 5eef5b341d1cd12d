"""Image ops of the embed path as torch functions (port of
``pd_fusion/ops/image.py``): resampling, normalization, slicing,
augmentation. Each runs on the device of its input tensor; the JAX
package runs them as XLA, so the port has them as torch ops.

Numerical contracts, as in the JAX package:
- ``resize3d``: ``scipy.ndimage.zoom(order=1)``'s align-corners grid,
  three separable 1-D gathers and lerps; the grid is ``jnp.linspace``'s
  float32 formula (``stop * (k / (n - 1))``, endpoint appended).
- ``resize2d_halfpix``: bilinear with half-pixel centres and edge clamp
  (``F.interpolate(mode='bilinear', align_corners=False)``), written as
  the JAX function's clamp and lerp, not as ``F.interpolate``.
- ``percentile_normalize``: the 1-99% clip over the nonzero mask by one
  sort, with ``_masked_percentile``'s exact integer rank arithmetic.
- ``select_slice_indices``/``take_slices``: nonzero-extent indices as
  ``lo + floor(k * (hi - lo) / (n - 1))`` in exact integers; the count
  is kept and indices may repeat.
- ``affine2d_batch``: rotation about the centre + translation, bilinear
  by an explicit four-tap gather, 0 for any source coordinate outside
  ``[0, size - 1]`` with no blend at the border (scipy
  ``mode='constant'``); ``F.grid_sample`` blends there, so it is not used.
"""
from typing import Tuple

import torch


def _linspace_f32(stop: float, n: int, device) -> torch.Tensor:
    """``jnp.linspace(0.0, stop, n)`` in float32, operation for operation."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    div = torch.tensor(float(n - 1), dtype=torch.float32, device=device)
    step = torch.arange(n - 1, dtype=torch.float32, device=device) / div
    stop_t = torch.tensor(stop, dtype=torch.float32, device=device)
    return torch.cat([stop_t * step, stop_t[None]])


def _lerp_axis(x: torch.Tensor, axis: int, i0, i1, t) -> torch.Tensor:
    shape = [1] * x.ndim
    shape[axis] = t.numel()
    t = t.to(x.dtype).reshape(shape)
    a = torch.index_select(x, axis, i0)
    b = torch.index_select(x, axis, i1)
    return a * (1.0 - t) + b * t


def _resize_axis_ac(x: torch.Tensor, axis: int, out_len: int) -> torch.Tensor:
    """Align-corners linear resize along one axis (scipy zoom order=1)."""
    in_len = x.shape[axis]
    if in_len == out_len:
        return x
    if in_len == 1:
        return torch.repeat_interleave(x, out_len, dim=axis)
    pos = _linspace_f32(in_len - 1.0, out_len, x.device)
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, in_len - 2)
    return _lerp_axis(x, axis, i0, i0 + 1, pos - i0)


def resize3d(vol: torch.Tensor, target_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Trilinear volume resize with scipy-zoom grid semantics, over the last
    three axes ([..., D, H, W]: one volume or a batch). Integer inputs are
    promoted to float32 first (a lerp weight cast to an integer type would
    make it nearest-neighbour)."""
    if not vol.is_floating_point():
        vol = vol.to(torch.float32)
    out = vol
    for axis in range(3):
        out = _resize_axis_ac(out, vol.ndim - 3 + axis, int(target_shape[axis]))
    return out


def _resize_axis_halfpix(x: torch.Tensor, axis: int, out_len: int) -> torch.Tensor:
    """Half-pixel-centres linear resize (torch bilinear align_corners=False)."""
    in_len = x.shape[axis]
    if in_len == out_len:
        return x
    scale = torch.tensor(in_len / out_len, dtype=torch.float32, device=x.device)
    pos = (torch.arange(out_len, dtype=torch.float32, device=x.device) + 0.5) * scale - 0.5
    pos = torch.clamp(pos, 0.0, in_len - 1.0)
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, max(in_len - 2, 0))
    return _lerp_axis(x, axis, i0, torch.clamp(i0 + 1, max=in_len - 1), pos - i0)


def resize2d_halfpix(imgs: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """imgs [..., H, W] -> [..., size0, size1], torch-bilinear semantics."""
    if not imgs.is_floating_point():
        imgs = imgs.to(torch.float32)
    out = _resize_axis_halfpix(imgs, imgs.ndim - 2, int(size[0]))
    return _resize_axis_halfpix(out, out.ndim - 1, int(size[1]))


def _masked_percentile(sorted_vals: torch.Tensor, count: torch.Tensor, q: int) -> torch.Tensor:
    """Percentile with numpy 'linear' interpolation over the first ``count``
    entries of each ascending-sorted row (``sorted_vals`` [..., N],
    ``count`` an integer tensor of shape [...]), ``q`` an INTEGER
    percentile. The fractional rank ``(count - 1) * q / 100`` is
    taken in exact integers, split as the JAX function splits it to stay
    inside int32 (a float32 rank has an ulp of 0.5 and more at 2^24 voxels
    and picked off-by-one indices against ``np.percentile``). The integer
    floor equals numpy's float64 index for every q used here: fl64(q/100)
    rounds up for q in {1, 10, 50, 90, 99}, so integer ranks stay exact,
    and other ranks lie at least 1/100 from an integer."""
    k = count - 1
    a = k // 100
    r = k - a * 100
    rq = r * q
    lo = a * q + rq // 100
    rem = rq - (rq // 100) * 100
    t = rem.to(sorted_vals.dtype) * 0.01  # XLA's rewrite of the JAX function's / 100.0
    hi = torch.where(rem > 0, lo + 1, lo)

    def at(i):
        return torch.take_along_dim(sorted_vals, i[..., None].long(), dim=-1)[..., 0]

    below, above = at(lo), at(hi)
    if sorted_vals.dtype != torch.float32:
        return below * (1.0 - t) + above * t
    # XLA's CPU backend contracts the JAX function's a * (1 - t) + b * t into
    # fma(b, t, a * (1 - t)). b * t of two float32s is exact in float64, so
    # one rounding of the float64 sum gives the fma's float32 (a double
    # rounding could differ only on an exact halfway case), on any device.
    return ((below * (1.0 - t)).double() + above.double() * t.double()).float()


def percentile_normalize(vol: torch.Tensor) -> torch.Tensor:
    """1-99 percentile clip over the nonzero mask -> [0, 1]. Falls back to
    the global min/max when the volume has no positive voxel."""
    flat = vol.reshape(-1)
    mask = flat > 0
    count = torch.sum(mask)
    big = torch.finfo(flat.dtype).max
    sorted_masked = torch.sort(torch.where(mask, flat, big)).values
    cnt_i = torch.clamp(count, min=1).to(torch.int32)
    lo_m = _masked_percentile(sorted_masked, cnt_i, 1)
    hi_m = _masked_percentile(sorted_masked, cnt_i, 99)
    lo = torch.where(count > 0, lo_m, torch.min(flat))
    hi = torch.where(count > 0, hi_m, torch.max(flat))
    out = torch.clamp(vol, lo, hi)
    return ((out - lo) / (hi - lo + 1e-6)).to(torch.float32)


def select_slice_indices(vol: torch.Tensor, axis: int, slice_count: int) -> torch.Tensor:
    """Nonzero-extent indices along ``axis``, ``lo + floor(k * (hi - lo) /
    (n - 1))`` in exact integers (int32). A float32 ``lo + (hi - lo) *
    linspace(0, 1, n)`` truncates wrongly at many realistic (extent,
    count) pairs, e.g. extent 92 at count 24: 92 * fl32(6/23) = 23.999998.
    The host prep (``pipeline.select_slices_host`` and the native gather)
    truncates numpy's float64 ``np.linspace`` instead, as the JAX package's
    host prep does; the two differ only at counts above 48."""
    other = tuple(i for i in range(3) if i != axis)
    nonzero = torch.amax(vol > 0, dim=other)
    n = vol.shape[axis]
    idx = torch.arange(n, device=vol.device)
    any_nz = torch.any(nonzero)
    lo = torch.where(any_nz, torch.min(torch.where(nonzero, idx, n)), 0)
    hi = torch.where(any_nz, torch.max(torch.where(nonzero, idx, -1)), n - 1)
    if slice_count == 1:
        return lo.to(torch.int32)[None]
    k = torch.arange(slice_count, dtype=torch.int32, device=vol.device)
    d = (hi - lo).to(torch.int32)
    return (lo.to(torch.int32) + torch.div(k * d, slice_count - 1, rounding_mode="floor")).to(
        torch.int32)


def take_slices(vol: torch.Tensor, axis: int, slice_count: int) -> torch.Tensor:
    """-> [slice_count, H, W] 2-D slices along ``axis``, slice dim first."""
    indices = select_slice_indices(vol, axis, slice_count).to(torch.int64)
    out = torch.index_select(vol, axis, indices)
    if axis == 0:
        return out
    if axis == 1:
        return out.permute(1, 0, 2)
    return out.permute(2, 0, 1)


def affine2d_subjects(slices: torch.Tensor, angle_deg: torch.Tensor,
                      translate: torch.Tensor) -> torch.Tensor:
    """``affine2d_batch`` for a batch of subjects at once: slices [B, N, H,
    W], angle_deg [B], translate [B, 2] (pixels) -> [B, N, H, W], subject
    b's slices moved by its own angle and translation."""
    B, _, h, w = slices.shape
    dev, f32 = slices.device, torch.float32
    theta = torch.deg2rad(angle_deg.to(f32))
    c, s = torch.cos(theta), torch.sin(theta)
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)  # [B, 2, 2]
    center = torch.tensor([h, w], dtype=f32, device=dev) / 2.0
    rot_center = rot[:, :, 0] * center[0] + rot[:, :, 1] * center[1]  # [B, 2]
    offset = center - rot_center + translate.to(f32)

    ii = torch.arange(h, dtype=f32, device=dev)[:, None].expand(h, w)
    jj = torch.arange(w, dtype=f32, device=dev)[None, :].expand(h, w)

    def coord(r):  # source coordinate [B, h, w] along output axis r
        return (rot[:, r, 0, None, None] * ii + rot[:, r, 1, None, None] * jj
                + offset[:, r, None, None])

    src_i, src_j = coord(0), coord(1)
    i0 = torch.floor(src_i).to(torch.int64)
    j0 = torch.floor(src_j).to(torch.int64)
    ti = (src_i - i0)[:, None]
    tj = (src_j - j0)[:, None]
    flat = slices.reshape(B, slices.shape[1], h * w)

    def gather(ia, ja):
        valid = ((ia >= 0) & (ia < h) & (ja >= 0) & (ja < w))[:, None]
        lin = (torch.clamp(ia, 0, h - 1) * w + torch.clamp(ja, 0, w - 1)).reshape(B, 1, h * w)
        vals = torch.gather(flat, 2, lin.expand(-1, flat.shape[1], -1)).reshape(slices.shape)
        return torch.where(valid, vals, 0.0)

    # scipy mode='constant' gives cval for ANY coordinate outside [0, size-1]
    in_bounds = ((src_i >= 0) & (src_i <= h - 1) & (src_j >= 0) & (src_j <= w - 1))[:, None]
    val = (gather(i0, j0) * (1 - ti) * (1 - tj)
           + gather(i0, j0 + 1) * (1 - ti) * tj
           + gather(i0 + 1, j0) * ti * (1 - tj)
           + gather(i0 + 1, j0 + 1) * ti * tj)
    return torch.where(in_bounds, val, 0.0)


def affine2d_batch(slices: torch.Tensor, angle_deg, translate) -> torch.Tensor:
    """Rotate about the image centre + translate, bilinear, zero-padded.

    slices [N, H, W]; angle_deg a scalar; translate [2] (pixels). scipy
    ``affine_transform``'s convention: output coordinate o samples the
    input at ``rot @ o + offset``, ``offset = center - rot @ center +
    translate``."""
    angle = torch.as_tensor(angle_deg, dtype=torch.float32, device=slices.device).reshape(1)
    shift = torch.as_tensor(translate, dtype=torch.float32, device=slices.device).reshape(1, 2)
    return affine2d_subjects(slices[None], angle, shift)[0]


def slices_to_imagenet_batch(slices: torch.Tensor, input_size: int, mean: torch.Tensor,
                             std: torch.Tensor) -> torch.Tensor:
    """[N, H, W] grayscale slices -> [N, input_size, input_size, 3] NHWC
    ImageNet-normalized ResNet input: half-pixel bilinear resize, the
    channel repeated, per-channel mean/std. (NHWC is the JAX package's
    layout; ``permute(0, 3, 1, 2)`` of it is a channels-last NCHW view.)"""
    x = resize2d_halfpix(slices, (input_size, input_size))
    x = x[..., None].expand(*x.shape, 3)
    return (x - mean.reshape(1, 1, 1, 3)) / std.reshape(1, 1, 1, 3)


def zscore_volume(vol: torch.Tensor) -> torch.Tensor:
    """Z-score over the whole volume (population standard deviation)."""
    mu = torch.mean(vol)
    sd = torch.std(vol, correction=0)
    return ((vol - mu) / (sd + 1e-6)).to(torch.float32)
