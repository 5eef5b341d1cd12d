"""The port's metrics (pd_fusion_torch/ops/metrics.py, utils/metrics.py)
against the JAX package's, on the same numpy inputs. Tolerance 1e-6
absolute: f32 sums taken in another order."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pd_fusion.ops import metrics as J
from pd_fusion.utils.metrics import compute_metrics as jax_compute_metrics
from pd_fusion_torch.ops import metrics as T
from pd_fusion_torch.utils.metrics import compute_metrics

ATOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")


def _case(kind, seed):
    rng = np.random.RandomState(seed)
    n = 57
    y = rng.randint(0, 2, n).astype(np.float32)
    if kind == "random":
        p = rng.rand(n).astype(np.float32)
    elif kind == "ties":
        p = (rng.randint(0, 4, n) / 4.0).astype(np.float32)
    elif kind == "boundary":  # exactly on the ECE bin edges, 0 and 1 included
        p = (rng.randint(0, 11, n) / np.float32(10.0)).astype(np.float32)
    elif kind == "single_class":
        p = rng.rand(n).astype(np.float32)
        y = np.ones(n, np.float32)
    else:
        raise ValueError(kind)
    w = (rng.rand(n) > 0.2).astype(np.float32)
    return y, p, w


KINDS = ["random", "ties", "boundary", "single_class"]
FUNCS = ["roc_auc", "average_precision", "brier_score", "balanced_accuracy", "f1_score",
         "expected_calibration_error"]


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", FUNCS)
def test_metric_matches_jax(name, kind, weighted):
    y, p, w = _case(kind, seed=len(name) + KINDS.index(kind))
    jw = jnp.asarray(w) if weighted else None
    tw = torch.from_numpy(w) if weighted else None
    want = np.asarray(getattr(J, name)(jnp.asarray(y), jnp.asarray(p), jw))
    got = getattr(T, name)(torch.from_numpy(y), torch.from_numpy(p), tw).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # a degenerate input gives NaN in both, never a guarded finite value
    assert np.isnan(got) == np.isnan(want)


@pytest.mark.parametrize("kind", KINDS)
def test_binary_metrics_and_risk_coverage_match_jax(kind):
    y, p, w = _case(kind, seed=11)
    want = J.binary_metrics(jnp.asarray(y), jnp.asarray(p), jnp.asarray(w))
    got = T.binary_metrics(torch.from_numpy(y), torch.from_numpy(p), torch.from_numpy(w))
    assert list(got) == list(T.METRIC_NAMES) == list(J.METRIC_NAMES)
    for k in T.METRIC_NAMES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0)
    # risk-coverage keeps the reversed-stable tie order
    np.testing.assert_allclose(
        T.risk_coverage(torch.from_numpy(y), torch.from_numpy(p)).numpy(),
        np.asarray(J.risk_coverage(jnp.asarray(y), jnp.asarray(p))), atol=ATOL, rtol=0,
    )


def test_ece_bin_bounds_are_the_jax_packages():
    for n_bins in (5, 10, 15):
        np.testing.assert_array_equal(T._lower_bin_bounds_f32(n_bins), J._lower_bin_bounds_f32(n_bins))


def test_pack_unpack_layout_equals_jax():
    rng = np.random.RandomState(3)
    md = {k: rng.rand(2, 3).astype(np.float32) for k in J.METRIC_NAMES}
    probs = rng.rand(2, 3, 4).astype(np.float32)
    want = np.asarray(J.pack_metrics_and_probs({k: jnp.asarray(v) for k, v in md.items()},
                                               jnp.asarray(probs)))
    got = T.pack_metrics_and_probs({k: torch.from_numpy(v) for k, v in md.items()},
                                   torch.from_numpy(probs)).numpy()
    np.testing.assert_array_equal(got, want)
    md2, probs2 = T.unpack_metrics_and_probs(got, (2, 3), (2, 3, 4))
    for k in J.METRIC_NAMES:
        np.testing.assert_array_equal(md2[k], md[k])
    np.testing.assert_array_equal(probs2, probs)


def test_compute_metrics_matches_jax_and_raises_on_one_class():
    y, p, _ = _case("ties", seed=4)
    want = jax_compute_metrics(y.astype(int), p)
    got = compute_metrics(y.astype(int), p)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=ATOL)
    with pytest.raises(ValueError):
        compute_metrics(np.ones(5), np.linspace(0, 1, 5))
