"""Checks of the simple 3-D statistics (``ops/volume_stats.py``), shared by
the CPU tests (the port against the JAX function), the ``cuda``-marked
tests and ``chip_smoke.py`` (the card against the CPU).

Tolerances, feature by feature (the layout of ``simple_volume_features``:
mean, std, min, max, median, p10, p90, histogram, grid, then skewness,
kurtosis and entropy with ``extra_stats``):

- min, max, median, p10, p90 and the histogram: equal. They are a sort,
  exact integer ranks, one float32 interpolation, a true division and
  integer counts, computed alike on every device;
- mean and std: rtol ``MOMENT_RTOL`` (sums over up to 96^3 voxels taken in
  other orders);
- the grid: rtol ``MOMENT_RTOL`` plus ``GRID_ATOL_REL`` of the volume's
  largest magnitude (``resize3d``'s bound against the JAX function: XLA's
  float32 division puts some grid positions one ulp off);
- skewness and kurtosis: rtol ``MOMENT_RTOL`` plus ``SHAPE_ATOL``: they are
  dimensionless, of order 1, and their third and fourth central moments
  cancel in the sum, so a value near 0 carries the sums' absolute error;
- entropy: rtol ``MOMENT_RTOL``.
"""
from typing import Dict

import numpy as np
import torch

from pd_fusion_torch.ops.volume_stats import simple_volume_features

MOMENT_RTOL = 1e-5
GRID_ATOL_REL = 4e-6
SHAPE_ATOL = 1e-5
# the feature config of configs/data_openneuro_ds001907.yaml
CONFIG = {"hist_bins": 10, "grid_size": 8}


def check_features(got: np.ndarray, want: np.ndarray, hist_bins: int, grid_size: int,
                   extra_stats: bool, scale: float) -> Dict[str, float]:
    """``got`` and ``want`` [B, F] (or [F]) against the tolerances above;
    raises ``AssertionError`` on a miss. -> the largest error of each group
    (absolute; 0.0 where equality is required)."""
    got, want = np.atleast_2d(got), np.atleast_2d(want)
    g = grid_size**3
    hist = slice(7, 7 + hist_bins)
    grid = slice(7 + hist_bins, 7 + hist_bins + g)
    np.testing.assert_array_equal(got[:, 2:7], want[:, 2:7], err_msg="order statistics")
    np.testing.assert_array_equal(got[:, hist], want[:, hist], err_msg="histogram")
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=MOMENT_RTOL, err_msg="mean, std")
    np.testing.assert_allclose(got[:, grid], want[:, grid], rtol=MOMENT_RTOL,
                               atol=GRID_ATOL_REL * scale, err_msg="grid")
    errs = {"order_stats": 0.0, "histogram": 0.0,
            "moments": float(np.abs(got[:, :2] - want[:, :2]).max()),
            "grid": float(np.abs(got[:, grid] - want[:, grid]).max())}
    if extra_stats:
        extra = slice(7 + hist_bins + g, None)
        np.testing.assert_allclose(got[:, extra][:, :2], want[:, extra][:, :2], rtol=MOMENT_RTOL,
                                   atol=SHAPE_ATOL, err_msg="skewness, kurtosis")
        np.testing.assert_allclose(got[:, extra][:, 2], want[:, extra][:, 2], rtol=MOMENT_RTOL,
                                   err_msg="entropy")
        errs["extra"] = float(np.abs(got[:, extra] - want[:, extra]).max())
    return errs


def compare_card_with_cpu(vols: np.ndarray, device, hist_bins: int = CONFIG["hist_bins"],
                          grid_size: int = CONFIG["grid_size"]) -> Dict[str, Dict[str, float]]:
    """One batch ``vols`` [B, D, H, W] float32 through the function on
    ``device`` and on the CPU, with ``extra_stats`` off and on. ->
    ``{"extra_off": errs, "extra_on": errs}``."""
    scale = float(np.abs(vols).max())
    out = {}
    for extra in (False, True):
        want = simple_volume_features(torch.from_numpy(vols), hist_bins, grid_size, extra)
        got = simple_volume_features(torch.from_numpy(vols).to(device), hist_bins, grid_size,
                                     extra)
        out[f"extra_{'on' if extra else 'off'}"] = check_features(
            got.cpu().numpy(), want.numpy(), hist_bins, grid_size, extra, scale)
    return out
