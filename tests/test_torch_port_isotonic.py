"""The port's device isotonic fit (``pd_fusion_torch/ops/isotonic.py``)
against the JAX package's (``pd_fusion/ops/isotonic.py``) and against
scikit-learn's ``IsotonicRegression(out_of_bounds="clip")``, on the cases
of ``tests/test_isotonic_device.py``.

Tolerances: bitwise on at least as many of the twelve sets of
``test_bitexact_on_cpu_mostly`` as the JAX function, never more than
1.2e-7 from scikit-learn there (one float32 ulp of [0, 1]); 3e-6 from
scikit-learn on the quantized random sets, as the JAX test states;
padding lanes, fold batching and the all-in-one fit bit for bit.
"""
import numpy as np
import pytest
import torch
from sklearn.isotonic import IsotonicRegression

from pd_fusion.ops.isotonic import isotonic_fit_transform as jax_fit_transform
from pd_fusion_torch.ops import isotonic_checks as checks
from pd_fusion_torch.ops.isotonic import isotonic_fit_transform
from test_torch_port_jax_draws import one_cpu_thread


@pytest.fixture(autouse=True)
def _one_thread():
    with one_cpu_thread():
        yield


def _oracle(x, y, t):
    return IsotonicRegression(out_of_bounds="clip").fit(x, y).transform(t)


def _port(x, y, t, n_pad=0):
    return checks.device_fit_transform(np.asarray(x, np.float32), np.asarray(y, np.float32),
                                       np.asarray(t, np.float32), "cpu", n_pad)


def _jax(x, y, t):
    import jax

    n = len(x)
    return np.asarray(jax.jit(jax_fit_transform)(
        np.asarray(x, np.float32), np.asarray(y, np.float32), np.ones(n, bool),
        np.asarray(t, np.float32)))


def test_bitwise_on_at_least_as_many_sets_as_the_jax_function():
    n_port = n_jax = 0
    for x, y, t in checks.bitexact_sets():
        ref = _oracle(x, y, t).astype(np.float32)
        port, jx = _port(x, y, t), _jax(x, y, t)
        n_port += int(np.array_equal(port, ref))
        n_jax += int(np.array_equal(jx, ref))
        assert np.abs(port - ref).max() <= 1.2e-7
        assert checks.same_tie_classes(port, ref)
        np.testing.assert_array_equal(port, jx)  # the same float32 operations
    assert n_port >= n_jax >= 9, (n_port, n_jax)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [5, 37, 200])
def test_matches_sklearn_and_jax_on_random_sets(seed, n):
    rng = np.random.default_rng(seed)
    x = np.round(rng.random(n).astype(np.float32), 2)  # duplicate-x groups
    y = (rng.random(n) < x).astype(np.float32)
    t = np.concatenate([rng.random(3 * n).astype(np.float32), [-1.0, 0.0, 1.0, 2.0]])
    got = _port(x, y, t, n_pad=11)
    np.testing.assert_allclose(got, _oracle(x, y, t), atol=3e-6)
    np.testing.assert_array_equal(got, _jax(x, y, t))


def test_host_fit_sets_agree_with_the_plain_version():
    """The shared check the card runs, here on the CPU: identical tie
    classes, within one ulp of [0, 1], against the port's host fit."""
    n_sets, n_equal = checks.check_all("cpu")
    assert n_sets == 24 and n_equal >= 20, n_equal


def test_padding_is_inert():
    rng = np.random.default_rng(7)
    x = rng.random(40).astype(np.float32)
    y = (rng.random(40) < 0.5).astype(np.float32)
    t = rng.random(60).astype(np.float32)
    np.testing.assert_array_equal(_port(x, y, t, 0), _port(x, y, t, 64))


def test_degenerate_cases():
    t = np.array([-1.0, 0.1, 0.5, 0.9, 2.0], np.float32)
    cases = [(np.array([0.4]), np.array([1.0])),  # one point: a constant map
             (np.full(9, 0.3), np.array([0, 1, 1, 0, 1, 0, 0, 1, 1]))]  # one x: mean(y)
    x = np.linspace(0.1, 0.9, 12)
    cases += [(x, np.full(12, c)) for c in (0.0, 1.0)]  # single-class labels
    cases.append((x, 1.0 - (x > 0.5)))  # anti-monotone: one block
    for x, y in cases:
        got = _port(x, y, t)
        np.testing.assert_allclose(got, _oracle(x, y, t), atol=3e-6)
        np.testing.assert_array_equal(got, _jax(x, y, t))


def test_output_is_monotone_and_clipped():
    rng = np.random.default_rng(3)
    x = rng.random(80).astype(np.float32)
    y = (rng.random(80) < x).astype(np.float32)
    t = np.sort(rng.random(500).astype(np.float32) * 1.4 - 0.2)
    out = _port(x, y, t)
    assert np.all(np.diff(out) >= -1e-7)
    assert out.min() >= 0.0 and out.max() <= 1.0


def test_fold_batched_equals_a_loop_and_the_jax_vmap():
    import jax

    xc, yc, valid, t = checks.fold_batched_inputs(4, 50, seed=11)
    batched = isotonic_fit_transform(xc, yc, valid, t).numpy()
    want = np.asarray(jax.jit(jax.vmap(jax_fit_transform))(
        xc.numpy(), yc.numpy(), valid.numpy(), t.numpy()))
    np.testing.assert_array_equal(batched, want)
    for k in range(4):
        one = isotonic_fit_transform(xc[k], yc[k], valid[k], t[k]).numpy()
        np.testing.assert_array_equal(batched[k], one)
        v = valid[k].numpy()
        np.testing.assert_allclose(batched[k], _oracle(xc[k].numpy()[v], yc[k].numpy()[v],
                                                       t[k].numpy()), atol=3e-6)


def test_adjacent_blocks_separated_by_1e6_stay_distinct():
    """Two PAV blocks whose means differ by about 1e-6 stay two blocks: the
    tie-repair tolerance (1e-7 relative) does not merge them."""
    gap = np.float32(0.5 + 1e-6) - np.float32(0.5)
    assert 0 < gap < 1.5e-6
    x = np.asarray([0.2, 0.4, 0.6, 0.8], np.float32)
    y = np.asarray([0.1, 0.5, np.float32(0.5) + gap, 0.9], np.float32)
    got = _port(x, y, x)
    np.testing.assert_allclose(got, _oracle(x, y, x), atol=1e-7)
    assert got[2] > got[1], (got[1], got[2])


def test_knot_exact_ramp_value_is_not_fused_onto_the_flat_block():
    """A t equal to a ramp-boundary knot goes through scipy's left interval,
    whose separately rounded lerp lands one ulp off the flat block's value:
    a value distinct from the block's, as scikit-learn gives it (a fused
    multiply-add would make a tie scikit-learn does not have)."""
    for x, y, t in checks.bitexact_sets():
        got, want = _port(x, y, t), _oracle(x, y, t).astype(np.float32)
        assert len(np.unique(got)) == len(np.unique(want))


def test_single_fit_accepts_one_dimensional_inputs():
    x = torch.tensor([0.1, 0.4, 0.4, 0.8])
    y = torch.tensor([0.0, 1.0, 0.0, 1.0])
    out = isotonic_fit_transform(x, y, torch.ones(4, dtype=torch.bool), x)
    assert out.shape == (4,)
    np.testing.assert_allclose(out.numpy(), _oracle(x.numpy(), y.numpy(), x.numpy()), atol=1e-7)
