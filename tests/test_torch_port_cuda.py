"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here carries the ``cuda`` marker and skips without a CUDA
device: a hand-written kernel has no CPU mode. The module imports no JAX,
so it also runs on a GPU machine without it:

    python -m pytest tests/test_torch_port_cuda.py -q

The checks and their tolerances live in
``pd_fusion_torch/ops/attention_pool_checks.py`` (kernel K1) and
``pd_fusion_torch/nn/trainer_checks.py`` (the fold-batched tabular
trainer and the MLP forward, card against CPU), which ``chip_smoke.py``
runs too.
"""
import pytest
import torch

from pd_fusion_torch.nn import trainer_checks
from pd_fusion_torch.ops import attention_pool as ap
from pd_fusion_torch.ops import attention_pool_checks as checks

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("B,L,H,all_masked,h_offset", checks.SHAPES)
def test_kernel_forward_matches_plain(cuda, B, L, H, all_masked, h_offset):
    checks.check_forward(B, L, H, all_masked, seed=B + L + H, device=cuda, h_offset=h_offset)


@pytest.mark.parametrize("B,L,H,all_masked,h_offset", checks.SHAPES)
def test_kernel_gradient_matches_autograd_of_plain(cuda, B, L, H, all_masked, h_offset):
    checks.check_gradient(B, L, H, all_masked, seed=7, device=cuda, h_offset=h_offset)


def test_mil_head_on_the_card_matches_the_cpu(cuda):
    from pd_fusion_torch.nn.mil import mil_apply, mil_init

    params = mil_init(torch.Generator().manual_seed(0), 64, 32, 16, True)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(6, 13, 64, generator=g)
    m = (torch.rand(6, 13, generator=g) > 0.3).float()
    m[2] = 0.0
    want = mil_apply(params, x, m, gated=True)
    on_card = {k: {kk: v.to(cuda) for kk, v in layer.items()} for k, layer in params.items()}
    before = ap.launch_counts["kernel"]
    got = mil_apply(on_card, x.to(cuda), m.to(cuda), gated=True)
    assert ap.launch_counts["kernel"] == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


def test_mlp_apply_on_the_card_matches_the_cpu(cuda):
    trainer_checks.check_mlp_apply(device=cuda)


@pytest.mark.parametrize("per_sample", [False, True], ids=["per-batch", "per-sample"])
def test_fold_batched_trainer_on_the_card_matches_the_cpu(cuda, per_sample):
    """Two epochs at the bench frame's widths, the same explicit draws."""
    inputs = trainer_checks.trainer_inputs(epochs=2, per_sample=per_sample)
    trainer_checks.compare_card_with_cpu(inputs, trainer_checks.SHORT_ATOL, device=cuda)
