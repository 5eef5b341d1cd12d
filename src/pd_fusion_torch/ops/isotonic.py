"""Isotonic regression fit + piecewise-linear transform on the device
(port of ``pd_fusion/ops/isotonic.py``).

Reproduces scikit-learn's ``IsotonicRegression(out_of_bounds="clip")``
(the calibration wrapper's host fit, ``models/calibrate.py``) as torch
ops without data-dependent control flow, so the calibrated CV tail
(isotonic fit, transform, metrics) runs on the card.

The fit uses the closed-form max-min characterisation of isotonic least
squares instead of the sequential pool-adjacent-violators walk:

    yhat_i = max_{j<=i} min_{k>=i} weighted_mean(y_j..y_k)

lowered as one O(n^2) broadcast of range means from prefix sums plus a
suffix-min / prefix-max. Tie handling matches scikit-learn's
``_make_unique`` (weighted mean of y over duplicate x); the transform
matches its ``interp1d(kind="linear")`` over the fitted knots, clipped to
the training range.

The folds are a leading batch axis: ``xc``, ``yc``, ``valid`` are [K, n]
and ``t`` is [K, m] (or all 1-D for one fit). Each [K, n, n] buffer holds
K * n^2 elements (671 MB in float32 at n = 4096, K = 10); callers take
the host fit above ``MAX_DEVICE_N``.
"""
import torch

# n^2 buffers above this get large (and the host PAV is O(n log n)):
# callers should take a host path beyond it.
MAX_DEVICE_N = 4096


def _segment_sum(values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-row sums of ``values`` [K, n] into ``ids`` [K, n] (ids < n)."""
    return torch.zeros_like(values).scatter_add_(1, ids, values)


def isotonic_fit_transform(xc, yc, valid, t):
    """Fit isotonic regression on (xc, yc) where ``valid`` is True, and
    return the calibrated values of ``t`` (linear interpolation between
    fitted knots, clipped to the training range), per fold."""
    single = xc.dim() == 1
    if single:
        xc, yc, valid, t = xc[None], yc[None], valid[None], t[None]
    K, n = xc.shape
    dt = torch.promote_types(xc.dtype, torch.float32)
    dev = xc.device
    xc = xc.to(dt)
    yc = yc.to(dt)
    valid = valid.to(torch.bool)
    w = valid.to(dt)
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    ar = torch.arange(n, device=dev)

    # sort by x with invalid entries last (stable, as jnp.argsort)
    xs_key = torch.where(valid, xc, inf)
    order = torch.argsort(xs_key, dim=1, stable=True)
    xs = xs_key.gather(1, order)
    ys = torch.where(valid, yc, 0.0).gather(1, order)
    ws = w.gather(1, order)

    # duplicate-x segments (scikit-learn _make_unique: weighted mean of y)
    new_seg = torch.cat([torch.ones((K, 1), dtype=torch.bool, device=dev),
                         xs[:, 1:] != xs[:, :-1]], dim=1)
    gid = torch.cumsum(new_seg, dim=1) - 1
    ysum = _segment_sum(ws * ys, gid)
    wsum = _segment_sum(ws, gid)
    # unique x per segment (+inf for empty trailing segments)
    xseg = torch.full_like(xs, float("inf")).scatter_reduce(1, gid, xs, "amin",
                                                            include_self=False)
    seg_valid = wsum > 0

    # range means from prefix sums: mean(j..k) = (Sy[k]-Sy[j-1])/(Sw[k]-Sw[j-1])
    Sy = torch.cumsum(ysum, dim=1)
    Sw = torch.cumsum(wsum, dim=1)
    zero = torch.zeros((K, 1), dtype=dt, device=dev)
    Syb = torch.cat([zero, Sy[:, :-1]], dim=1)  # Sy[j-1]
    Swb = torch.cat([zero, Sw[:, :-1]], dim=1)
    num = Sy[:, None, :] - Syb[:, :, None]  # [K, j, k]
    den = Sw[:, None, :] - Swb[:, :, None]
    jk_ok = (ar[:, None] <= ar[None, :]) & (den > 0)
    means = torch.where(jk_ok, num / torch.where(jk_ok, den, 1.0), inf)
    del num, den, jk_ok

    # yhat_i = max_{j<=i, j real} min_{k>=i} means[j, k]
    suff_min = torch.cummin(means.flip(2), dim=2).values.flip(2)  # A[j, i]
    del means
    rows = torch.where(seg_valid[:, :, None], suff_min, -inf)
    del suff_min
    yhat_seg = torch.diagonal(torch.cummax(rows, dim=1).values, dim1=1, dim2=2)
    del rows

    # Tie repair: members of one PAV block are mathematically equal, but the
    # per-index max-min evaluation can differ by an ulp between neighbours,
    # while scikit-learn assigns the block mean EXACTLY to every member (and
    # the tie-exact AUC/ECE downstream see those ties). Blocks are recovered
    # as monotone runs (gap <= tol is "same block") and each block's exact
    # weighted mean is broadcast to all its members.
    tol = torch.tensor(1e-7, dtype=dt, device=dev) * (1.0 + yhat_seg.abs())
    prev = torch.cat([torch.full((K, 1), float("-inf"), dtype=dt, device=dev),
                      yhat_seg[:, :-1]], dim=1)
    new_blk = (ar == 0)[None, :] | (yhat_seg > prev + tol)
    bid = torch.cumsum(new_blk, dim=1) - 1
    b_ysum = _segment_sum(ysum, bid)
    b_wsum = _segment_sum(wsum, bid)
    yhat_seg = (b_ysum / torch.where(b_wsum > 0, b_wsum, 1.0)).gather(1, bid)

    # knots: (xseg, yhat_seg) over valid segments; pad knots sit at +inf
    # with the last real fitted value so interp beyond x_max is flat
    n_seg = seg_valid.sum(dim=1)
    last = torch.clamp(n_seg - 1, min=0)[:, None]
    y_last = yhat_seg.gather(1, last)
    x_max = xseg.gather(1, last)
    x_min = xseg[:, :1]
    yknot = torch.where(seg_valid, yhat_seg, y_last)

    tclip = torch.minimum(torch.maximum(t.to(dt), x_min), x_max)
    # scipy interp1d._call_linear operation for operation: LEFT-side
    # searchsorted, then slope = dy/dx and slope*(t-x_lo) + y_lo. A t that
    # equals a ramp-boundary knot goes through the LEFT interval, whose
    # float32 lerp rounds to y_hi +- 1 ulp: a value distinct from the flat
    # block's, as scikit-learn gives it.
    idx = torch.searchsorted(xseg.contiguous(), tclip.contiguous(), right=False)
    idx = torch.clamp(torch.clamp(idx, min=1), max=n - 1)
    lo = torch.remainder(idx - 1, n)  # n == 1: index -1 wraps, as in the JAX function
    x_lo = xseg.gather(1, lo)
    x_hi = xseg.gather(1, idx)
    y_lo = yknot.gather(1, lo)
    y_hi = yknot.gather(1, idx)
    dx = x_hi - x_lo
    slope = (y_hi - y_lo) / torch.where(dx > 0, dx, 1.0)
    # The product and the add are separate ops and so are rounded
    # separately, as scipy does; a fused multiply-add (addcmul, lerp, a
    # compiled kernel) would land a knot-exact ramp value back ON the flat
    # block's value and create a tie scikit-learn does not have. The select
    # also zeroes the single-knot case (dx == 0: a constant map).
    prod = torch.where(dx > 0, slope * (tclip - x_lo), 0.0)
    out = prod + y_lo
    return out[0] if single else out
