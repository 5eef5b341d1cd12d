"""K1 against its plain PyTorch version on the card: the one copy of the
check that ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py`` both run.

Tolerances (f32 sums taken in another order): pooled and gradients 1e-5
absolute + relative, attention weights 1e-6 absolute.
"""
import torch

from pd_fusion_torch.ops import attention_pool as ap

POOL_ATOL = POOL_RTOL = 1e-5
WEIGHTS_ATOL = 1e-6

# (B, L, H, all-masked bags, h offset in floats): the MIL CV slice's
# training step (B=16) and evaluation width (B=80) at L=48, H=256; the
# MIL fine-tune (B=4, L=64) and the 3-axis bags (B=16, L=72); a bag long
# enough to be staged (L=4096); tails of H (100 takes float4, 97 the scalar
# path); a bag of one; bags that are all masked; and an h that starts 4 bytes
# past a 16-byte boundary (the scalar path at the training shape).
SHAPES = [(16, 48, 256, (0,), 0), (80, 48, 256, (0, 79), 0), (5, 13, 100, (2,), 0),
          (3, 1, 1, (), 0), (4, 48, 256, (0, 1, 2, 3), 0), (4, 64, 256, (1,), 0),
          (16, 72, 256, (3,), 0), (2, 4096, 256, (1,), 0), (5, 13, 97, (4,), 0),
          (16, 48, 256, (2,), 1)]


def offset_leaf(h, h_offset):
    """A 1-D leaf whose elements ``[h_offset:]`` hold ``h``: viewed as
    [B, L, H] it starts ``4 * h_offset`` bytes past the allocation."""
    buf = torch.zeros(h.numel() + h_offset, device=h.device)
    buf[h_offset:] = h.reshape(-1)
    return buf


def pool_inputs(B, L, H, all_masked, seed, device, h_offset=0):
    g = torch.Generator(device=device).manual_seed(seed)
    scores = torch.randn(B, L, generator=g, device=device)
    mask = (torch.rand(B, L, generator=g, device=device) > 0.3).float()
    mask[:, 0] = 1.0
    mask[list(all_masked)] = 0.0
    h = torch.relu(torch.randn(B, L, H, generator=g, device=device))
    if h_offset:
        h = offset_leaf(h, h_offset)[h_offset:].view(B, L, H)
    return scores, mask, h


def check_forward(B, L, H, all_masked, seed, device="cuda", h_offset=0) -> float:
    """One kernel launch against the plain version; an all-masked bag must give uniform weights
    and the mean of its instances. -> max abs error."""
    s, m, h = pool_inputs(B, L, H, all_masked, seed, device, h_offset)
    if ap.is_aligned(h) != (h_offset % 4 == 0):
        raise AssertionError(f"h at offset {h_offset} floats: is_aligned {ap.is_aligned(h)}")
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


def check_gradient(B, L, H, all_masked, seed, device="cuda", h_offset=0) -> float:
    """Gradients in scores and h through the ``autograd.Function`` (kernel
    forward) against autograd of the plain version. -> max abs error."""
    s, m, h = pool_inputs(B, L, H, all_masked, seed, device, h_offset)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    gp = torch.randn(B, H, generator=g, device=device)
    gw = torch.randn(B, L, generator=g, device=device)
    grads = []
    for fn in (ap.attention_pool, ap.attention_pool_reference):
        ss = s.clone().requires_grad_(True)
        leaf = offset_leaf(h, h_offset).requires_grad_(True)  # keeps h's alignment
        pooled, weights = fn(ss, m, leaf[h_offset:].view(B, L, H))
        ((pooled * gp).sum() + (weights * gw).sum()).backward()
        grads.append((ss.grad, leaf.grad[h_offset:].view(B, L, H)))
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
