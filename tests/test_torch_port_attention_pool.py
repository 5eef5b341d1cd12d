"""Kernel K1's module (pd_fusion_torch/ops/attention_pool.py) against the
JAX package's attention pool (pd_fusion/ops/pallas_mil.py).

On the CPU the wrapper takes the plain version; the CUDA kernel itself is
held against it on the card by tests/test_torch_port_cuda.py (which imports
no JAX, so it runs where JAX is not installed) and by chip_smoke.py.
Tolerances: pooled 1e-5 and weights 1e-6 absolute (f32
sums taken in another order); gradients 1e-5."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pd_fusion.ops.pallas_mil import _pallas_pool, _xla_pool, attention_pool as jax_pool
from pd_fusion_torch.ops import attention_pool as ap


def _inputs(B, L, H, seed, all_masked=()):
    rng = np.random.RandomState(seed)
    scores = rng.randn(B, L).astype(np.float32)
    mask = (rng.rand(B, L) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    for b in all_masked:
        mask[b] = 0.0
    h = rng.randn(B, L, H).astype(np.float32)
    return scores, mask, h


def _torch(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def test_plain_matches_jax_pallas_kernel_in_interpret_mode():
    scores, mask, h = _inputs(4, 16, 128, seed=0)
    p_jax, w_jax = _pallas_pool(jnp.asarray(scores), jnp.asarray(mask), jnp.asarray(h))
    p, w = ap.attention_pool_reference(*_torch(scores, mask, h))
    np.testing.assert_allclose(p.numpy(), np.asarray(p_jax), atol=1e-5, rtol=0)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_jax), atol=1e-6, rtol=0)


@pytest.mark.parametrize(
    "B,L,H,all_masked",
    [(5, 13, 100, (2,)), (3, 1, 1, ()), (2, 7, 33, (0, 1)), (16, 48, 256, (0,))],
)
def test_wrapper_matches_jax_xla_pool_on_tails_and_all_masked_bags(B, L, H, all_masked):
    scores, mask, h = _inputs(B, L, H, seed=B * L + H, all_masked=all_masked)
    p_jax, w_jax = _xla_pool(jnp.asarray(scores), jnp.asarray(mask), jnp.asarray(h))
    p, w = ap.attention_pool_forward(*_torch(scores, mask, h))
    np.testing.assert_allclose(p.numpy(), np.asarray(p_jax), atol=1e-5, rtol=0)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_jax), atol=1e-6, rtol=0)
    for b in all_masked:  # an all-masked bag pools to the uniform mean (-1e9, not -inf)
        np.testing.assert_allclose(w.numpy()[b], np.full(L, 1.0 / L), atol=1e-6)
        np.testing.assert_allclose(p.numpy()[b], h[b].mean(0), atol=1e-5)


@pytest.mark.parametrize("all_masked", [(), (1,)])
def test_autograd_function_matches_jax_custom_vjp(all_masked):
    B, L, H = 3, 12, 20
    scores, mask, h = _inputs(B, L, H, seed=5, all_masked=all_masked)
    rng = np.random.RandomState(6)
    gp = rng.randn(B, H).astype(np.float32)
    gw = rng.randn(B, L).astype(np.float32)

    def f_jax(s, hh):
        pooled, weights = jax_pool(s, jnp.asarray(mask), hh)
        return jnp.sum(pooled * gp) + jnp.sum(weights * gw)

    gs_jax, gh_jax = jax.grad(f_jax, argnums=(0, 1))(jnp.asarray(scores), jnp.asarray(h))

    s, m, hh = _torch(scores, mask, h)
    s.requires_grad_(True)
    hh.requires_grad_(True)
    pooled, weights = ap.attention_pool(s, m, hh)
    (torch.sum(pooled * torch.from_numpy(gp)) + torch.sum(weights * torch.from_numpy(gw))).backward()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(gs_jax), atol=1e-5, rtol=0)
    np.testing.assert_allclose(hh.grad.numpy(), np.asarray(gh_jax), atol=1e-5, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_count_it():
    ap.reset_launch_counts()
    ap.attention_pool(*_torch(*_inputs(2, 8, 16, seed=1)))
    assert ap.launch_counts == {"kernel": 0, "plain": 1}


@pytest.mark.parametrize(
    "mutate, err",
    [
        (lambda s, m, h: (s.double(), m, h), TypeError),
        (lambda s, m, h: (s, m, h[:, :, ::2]), ValueError),
        (lambda s, m, h: (s, m[:, :-1], h), ValueError),
        (lambda s, m, h: (s[:, :0], m[:, :0], h[:, :0]), ValueError),
    ],
    ids=["dtype", "non-contiguous", "shape", "empty-bag"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(mutate, err):
    s, m, h = _torch(*_inputs(2, 8, 16, seed=2))
    with pytest.raises(err):
        ap.attention_pool_forward(*mutate(s, m, h))
