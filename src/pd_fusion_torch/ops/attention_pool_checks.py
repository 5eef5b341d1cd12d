"""K1 against its plain PyTorch version on the card: the one copy of the
check that ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py`` both run.

Tolerances (f32 sums taken in another order): pooled and gradients 1e-5
absolute + relative, attention weights 1e-6 absolute.
"""
import torch

from pd_fusion_torch.ops import attention_pool as ap

POOL_ATOL = POOL_RTOL = 1e-5
WEIGHTS_ATOL = 1e-6

# (B, L, H, all-masked bags): the MIL CV slice's training step (B=16) and
# evaluation width (B=80) at L=48, H=256; a tail shape; a bag of one; bags
# that are all masked
SHAPES = [(16, 48, 256, (0,)), (80, 48, 256, (0, 79)), (5, 13, 100, (2,)), (3, 1, 1, ()),
          (4, 48, 256, (0, 1, 2, 3))]


def pool_inputs(B, L, H, all_masked, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    scores = torch.randn(B, L, generator=g, device=device)
    mask = (torch.rand(B, L, generator=g, device=device) > 0.3).float()
    mask[:, 0] = 1.0
    mask[list(all_masked)] = 0.0
    h = torch.relu(torch.randn(B, L, H, generator=g, device=device))
    return scores, mask, h


def check_forward(B, L, H, all_masked, seed, device="cuda") -> float:
    """One kernel launch against the plain version; an all-masked bag must
    give uniform weights and the mean of its instances. -> max abs error."""
    s, m, h = pool_inputs(B, L, H, all_masked, seed, device)
    before = dict(ap.launch_counts)
    pooled, weights = ap.attention_pool_forward(s, m, h)
    if ap.launch_counts != {"kernel": before["kernel"] + 1, "plain": before["plain"]}:
        raise AssertionError(f"expected one kernel launch; counts {before} -> {ap.launch_counts}")
    want_p, want_w = ap.attention_pool_reference(s, m, h)
    torch.cuda.synchronize()
    torch.testing.assert_close(pooled, want_p, atol=POOL_ATOL, rtol=POOL_RTOL)
    torch.testing.assert_close(weights, want_w, atol=WEIGHTS_ATOL, rtol=0)
    for b in all_masked:  # -1e9, not -inf: the uniform mean
        torch.testing.assert_close(weights[b], torch.full_like(weights[b], 1.0 / L),
                                   atol=WEIGHTS_ATOL, rtol=0)
        torch.testing.assert_close(pooled[b], h[b].mean(0), atol=POOL_ATOL, rtol=POOL_RTOL)
    return max(float((pooled - want_p).abs().max()), float((weights - want_w).abs().max()))


def check_gradient(B, L, H, all_masked, seed, device="cuda") -> float:
    """Gradients in scores and h through the ``autograd.Function`` (kernel
    forward) against autograd of the plain version. -> max abs error."""
    s, m, h = pool_inputs(B, L, H, all_masked, seed, device)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    gp = torch.randn(B, H, generator=g, device=device)
    gw = torch.randn(B, L, generator=g, device=device)
    grads = []
    for fn in (ap.attention_pool, ap.attention_pool_reference):
        ss, hh = s.clone().requires_grad_(True), h.clone().requires_grad_(True)
        pooled, weights = fn(ss, m, hh)
        ((pooled * gp).sum() + (weights * gw).sum()).backward()
        grads.append((ss.grad, hh.grad))
    # On an all-masked bag the custom backward (the JAX package's _pool_bwd)
    # gives g_scores = w * (g_w - sum(w * g_w)) with w = 1/L, while autograd
    # through the plain version's `where` gives 0 there.
    for b in all_masked:
        w = torch.full((L,), 1.0 / L, device=device)
        g_w = h[b] @ gp[b] + gw[b]
        grads[1][0][b] = w * (g_w - (w * g_w).sum())
    torch.cuda.synchronize()
    errs = []
    for got, want in zip(grads[0], grads[1]):
        torch.testing.assert_close(got, want, atol=POOL_ATOL, rtol=POOL_RTOL)
        errs.append(float((got - want).abs().max()))
    return max(errs)
