"""Device isotonic (``ops/isotonic.py``) against the port's host fit, the
plain version (``models/calibrate.py::IsotonicRegression``, scikit-learn's
steps in numpy/scipy): the one copy of the check that
``tests/test_torch_port_cuda.py``, the CPU tests and ``chip_smoke.py`` run.

The sets are those of the JAX package's isotonic tests: twelve random
ones, every other one tie-heavy (x rounded to two decimals), transformed
at the training x and at fresh points; twelve more with quantized x and
points outside [0, 1]. The device fit must give the host fit's tie
classes exactly (the calibrated metrics are tie-exact), and every value
equal to the host's or within one float32 ulp of the range [0, 1]
(``ULP``, 2^-23: a block mean one ulp off, and the ramp values
interpolated from it, as the JAX package's test allows).
"""
import numpy as np
import torch

from pd_fusion_torch.models.calibrate import IsotonicRegression
from pd_fusion_torch.ops.isotonic import isotonic_fit_transform

ULP = float(np.spacing(np.float32(1.0)))  # 1.19e-7


def bitexact_sets():
    """The twelve (x, y, t) sets of the JAX package's bitwise test."""
    for seed in range(12):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(3, 300))
        x = (np.round(rng.random(n), 2) if seed % 2 else rng.random(n)).astype(np.float32)
        y = (rng.random(n) < x).astype(np.float32)
        yield x, y, np.concatenate([x, rng.random(2 * n).astype(np.float32)])


def random_sets():
    """Quantized x (duplicate groups), t partly outside the fitted range."""
    for seed in range(4):
        for n in (5, 37, 200):
            rng = np.random.default_rng(seed)
            x = np.round(rng.random(n).astype(np.float32), 2)
            y = (rng.random(n) < x).astype(np.float32)
            t = np.concatenate([rng.random(3 * n).astype(np.float32), [-1.0, 0.0, 1.0, 2.0]])
            yield x, y, t.astype(np.float32)


def host_fit_transform(x, y, t) -> np.ndarray:
    return IsotonicRegression().fit(x, y).transform(t).astype(np.float32)


def device_fit_transform(x, y, t, device, n_pad=0) -> np.ndarray:
    """One fit on ``device``, with ``n_pad`` invalid lanes of garbage."""
    n = len(x) + n_pad
    xc = np.linspace(-5, 5, n).astype(np.float32)
    yc = np.full(n, 7.0, np.float32)
    valid = np.zeros(n, bool)
    xc[: len(x)], yc[: len(x)], valid[: len(x)] = x, y, True
    out = isotonic_fit_transform(*(torch.as_tensor(a, device=device) for a in (xc, yc, valid, t)))
    return out.cpu().numpy()


def same_tie_classes(a, b) -> bool:
    """Whether ``a`` and ``b`` split their indices into the same classes of
    equal values."""
    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    pairs = len(set(zip(ia.ravel().tolist(), ib.ravel().tolist())))
    return pairs == ia.max() + 1 == ib.max() + 1


def check_set(x, y, t, device) -> bool:
    """Device against host on one set; raises on a tie-class difference
    or a value more than one ulp away. -> whether all values are equal."""
    got = device_fit_transform(x, y, t, device)
    want = host_fit_transform(x, y, t)
    if not same_tie_classes(got, want):
        raise AssertionError(f"device isotonic (n={len(x)}) changes the host fit's tie classes")
    if not np.all(np.abs(got - want) <= ULP):
        raise AssertionError(f"device isotonic (n={len(x)}) is more than {ULP:.3e} from the host "
                             f"fit: max abs err {np.abs(got - want).max():.3e}")
    return bool(np.array_equal(got, want))


def check_all(device) -> tuple:
    """Every set of both families. -> (sets, sets bitwise equal)."""
    sets = list(bitexact_sets()) + list(random_sets())
    return len(sets), sum(check_set(x, y, t, device) for x, y, t in sets)


def fold_batched_inputs(K, n, seed=0, device="cpu"):
    """[K, n] calibration probs, labels and validity (about 10% padding)
    and [K, 6n] points to transform: a fold-batched calibrated CV's
    shapes."""
    rng = np.random.default_rng(seed)
    xc = rng.random((K, n)).astype(np.float32)
    yc = (rng.random((K, n)) < xc).astype(np.float32)
    valid = np.ones((K, n), bool)
    valid[:, n - n // 10:] = False
    t = rng.random((K, 6 * n)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (xc, yc, valid, t))
