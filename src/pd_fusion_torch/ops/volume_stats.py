"""Simple 3-D statistics features of a batch of volumes, as torch ops (port
of ``pd_fusion/ops/volume_stats.py::simple_volume_features``, which the
JAX package vmaps over batches of prefetched volumes).

Per volume, over the nonzero mask (every voxel when the volume has none):
mean, population std, min, max, median, p10, p90; a ``hist_bins``-bin
density histogram of the values clipped to [p1, p99]; the volume resized
to ``grid_size``^3 (``ops/image.py::resize3d``), flattened; with
``extra_stats`` also skewness, excess kurtosis and the histogram's
entropy. The arithmetic is the JAX function's, step for step:

- the masked min/max and the sort put ``finfo(float32).max`` in place of
  the voxels outside the mask; the percentiles are ``_masked_percentile``'s
  exact integer ranks over the first ``count`` sorted values;
- the variance and the higher moments are two-pass, around the mean;
- a degenerate range (p99 <= p1, a constant or mask-like volume) widens to
  [p1 - 0.5, p99 + 0.5] as ``np.histogram`` does, and the bin width is
  floored at ``finfo(float32).tiny``;
- the bin index is ``(clipped - lo) / width`` by a true division,
  truncated to int32 and clamped to the last bin;
- as the JAX function is compiled: XLA turns its divisions by a constant
  (``/ 100.0`` in the percentile, ``/ hist_bins`` in the bin width) into
  multiplies by the float32 reciprocal, and its CPU backend rounds the
  percentile's interpolation once (an fma). The port writes both, so the
  order statistics and the histogram equal the JAX function's bit for
  bit, and the card's equal the CPU's.

The histogram counts are integers here, not the JAX function's
scatter-add of 0/1 float weights: each voxel's bin is compared with every
bin and the matches summed, so no atomics and no sum order come in, on the
card or the CPU. As float32 the counts equal the float scatter-add's
exactly while a bin holds fewer than 2^24 voxels (a 96^3 volume has
884,736).

No hand kernel: the JAX function reaches no Pallas kernel (a sort, a
scatter-add, reductions and the resize, which XLA compiles).
"""
import torch

from pd_fusion_torch.ops.image import _masked_percentile, resize3d


def n_features(hist_bins: int = 10, grid_size: int = 8, extra_stats: bool = False) -> int:
    """Width of one volume's feature vector."""
    return 7 + hist_bins + grid_size**3 + (3 if extra_stats else 0)


def simple_volume_features(vols: torch.Tensor, hist_bins: int = 10, grid_size: int = 8,
                           extra_stats: bool = False) -> torch.Tensor:
    """``vols`` [B, D, H, W] (or one volume [D, H, W]) float32 -> [B,
    ``n_features``] (or [``n_features``]) float32, on ``vols``' device."""
    single = vols.ndim == 3
    if single:
        vols = vols[None]
    if not vols.is_floating_point():
        vols = vols.to(torch.float32)
    B = vols.shape[0]
    flat = vols.reshape(B, -1)
    mask = flat > 0
    m = mask | (mask.sum(1) == 0)[:, None]  # an empty mask uses every voxel
    cnt_i = m.sum(1).to(torch.int32)
    cnt = cnt_i.to(flat.dtype)
    mw = m.to(flat.dtype)

    mean = torch.sum(flat * mw, 1) / cnt
    dev = flat - mean[:, None]
    sq = dev * dev
    var = torch.sum(sq * mw, 1) / cnt  # population variance, numpy's .std()
    std = torch.sqrt(var)
    big = torch.finfo(flat.dtype).max
    vmin = torch.amin(torch.where(m, flat, big), 1)
    vmax = torch.amax(torch.where(m, flat, -big), 1)

    sorted_masked = torch.sort(torch.where(m, flat, big), dim=1).values
    median, p10, p90, lo, hi = (_masked_percentile(sorted_masked, cnt_i, q)
                                for q in (50, 10, 90, 1, 99))

    degen = hi <= lo
    lo_e = torch.where(degen, lo - 0.5, lo)
    hi_e = torch.where(degen, hi + 0.5, hi)
    clipped = torch.minimum(torch.maximum(flat, lo[:, None]), hi[:, None])
    width = torch.clamp((hi_e - lo_e) * (1.0 / hist_bins), min=torch.finfo(flat.dtype).tiny)
    idx = torch.clamp(((clipped - lo_e[:, None]) / width[:, None]).to(torch.int32), 0,
                      hist_bins - 1)
    idx = torch.where(m, idx, hist_bins)  # voxels outside the mask fall in no bin
    bins = torch.arange(hist_bins, dtype=torch.int32, device=flat.device)
    counts = torch.sum(idx[:, :, None] == bins, 1)
    hist = counts.to(flat.dtype) / (cnt * width)[:, None]

    grid = resize3d(vols, (grid_size,) * 3).reshape(B, -1)
    parts = [torch.stack([mean, std, vmin, vmax, median, p10, p90], 1), hist, grid]
    if extra_stats:
        m3 = torch.sum(sq * dev * mw, 1) / cnt
        m4 = torch.sum(sq * sq * mw, 1) / cnt
        ok = std > 0
        s2 = std * std  # the powers as jnp's integer_pow multiplies them
        safe3 = torch.where(ok, s2 * std, 1.0)
        safe4 = torch.where(ok, s2 * s2, 1.0)
        skew = torch.where(ok, m3 / safe3, 0.0)
        kurt = torch.where(ok, m4 / safe4 - 3.0, 0.0)
        h = hist + 1e-12
        ent = -torch.sum(h * torch.log(h), 1)
        parts.append(torch.stack([skew, kurt, ent], 1))
    out = torch.cat(parts, 1).to(torch.float32)
    return out[0] if single else out
