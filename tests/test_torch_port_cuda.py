"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here carries the ``cuda`` marker and skips without a CUDA
device: a hand-written kernel has no CPU mode. The module imports no JAX,
so it also runs on a GPU machine without it:

    python -m pytest tests/test_torch_port_cuda.py -q

The checks and their tolerances live in
``pd_fusion_torch/ops/attention_pool_checks.py`` (kernel K1),
``pd_fusion_torch/nn/trainer_checks.py`` (the fold-batched tabular and
MoE trainers and the MLP forward, card against CPU),
``pd_fusion_torch/ops/isotonic_checks.py`` (device isotonic against the
host fit), ``pd_fusion_torch/nn/gbdt_checks.py`` (GBDT determinism,
fold batching, card against CPU with the split-optimality audit,
TreeSHAP) and ``pd_fusion_torch/imaging/embed_checks.py`` (the ResNet
backbones and the embed pipeline, card against CPU), which
``chip_smoke.py`` runs too.
"""
import pytest
import torch

from pd_fusion_torch.nn import gbdt_checks, trainer_checks
from pd_fusion_torch.ops import attention_pool as ap
from pd_fusion_torch.ops import attention_pool_checks as checks
from pd_fusion_torch.ops import isotonic_checks

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


def test_device_isotonic_on_the_card_matches_the_host_fit(cuda):
    n_sets, _ = isotonic_checks.check_all(cuda)
    assert n_sets == 24


def test_moe_trainer_on_the_card_matches_the_cpu(cuda):
    inputs = trainer_checks.moe_inputs(K=3, n=200)
    trainer_checks.compare_moe_card_with_cpu(inputs, device=cuda, epochs=20)


GBDT_HP = dict(n_rounds=12, depth=4, lr=0.1, lam=0.0, min_child_weight=1e-3,
               min_child_samples=20.0)


def test_gbdt_onehot_fits_on_the_card_are_bit_identical(cuda):
    bins, y, w, base = gbdt_checks.cv_like_inputs(K=3, n=300)
    gbdt_checks.check_two_fits_identical(bins, y, w, base, dict(GBDT_HP, hist_mode="onehot"), cuda)


def test_gbdt_fold_batched_fit_on_the_card_equals_per_fold_fits(cuda):
    bins, y, w, base = gbdt_checks.cv_like_inputs(K=3, n=300)
    assert gbdt_checks.check_fold_batched_equals_per_fold(
        bins, y, w, base, dict(GBDT_HP, hist_mode="onehot"), cuda)


@pytest.mark.parametrize("hist_mode", ["onehot", "scatter"])
def test_gbdt_on_the_card_matches_the_cpu_or_passes_the_audit(cuda, hist_mode):
    bins, y, w, base = gbdt_checks.cv_like_inputs(K=1, n=300)
    gbdt_checks.compare_card_with_cpu(bins[0], y[0], w[0], base[0],
                                      dict(GBDT_HP, hist_mode=hist_mode), cuda)


def test_treeshap_on_the_card_matches_the_cpu(cuda):
    bins, y, w, base = gbdt_checks.cv_like_inputs(K=1, n=300)
    trees = gbdt_checks.fit(bins[0], y[0], w[0], base[0], dict(GBDT_HP, hist_mode="onehot"), cuda)
    gbdt_checks.compare_shap_card_with_cpu(trees, bins[0], base[0], GBDT_HP["depth"], cuda)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_backbone_on_the_card_matches_the_cpu(cuda, arch):
    """Float32 (TF32 off) and bfloat16 against the CPU on 12 slices at 64^2
    (``imaging/embed_checks.py``'s bounds)."""
    import numpy as np

    from pd_fusion_torch.imaging import embed_checks
    from pd_fusion_torch.nn.resnet import load_backbone
    from pd_fusion_torch.utils.device import get_device

    get_device(cuda)  # TF32 off
    params, _, _ = load_backbone(arch, seed=1)
    slices = np.random.RandomState(2).rand(12, 40, 40).astype(np.float32)
    half = np.full(3, 0.5, np.float32)
    embed_checks.compare_card_with_cpu(params, slices, arch, 64, half, half, cuda)


def test_embed_pipeline_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The whole pipeline (native prep, pinned staging, side-stream copies,
    TTA draws) on the card and on the CPU: per-slice 3-axis bags with
    ``tta: 2``, flushes of 4, 4 and 2."""
    import numpy as np

    from pd_fusion_torch.imaging import embed_checks
    from pd_fusion_torch.imaging.pipeline import run_resnet_embedding_pipeline
    from pd_fusion_torch.nn.resnet import load_backbone
    from pd_fusion_torch.utils.device import get_device

    get_device(cuda)
    _, rows, _ = embed_checks.synthetic_t1w_dataset(tmp_path, 5, shape=(30, 34, 28), workers=2)
    params, _, _ = load_backbone("resnet18", seed=0)
    half = np.full(3, 0.5, np.float32)
    out = {}
    for dev in ("cpu", cuda):
        out[str(dev)] = np.stack(run_resnet_embedding_pipeline(
            [r["t1wbrain_path"] for r in rows], [r["subject_id"] for r in rows], params, half,
            half, arch="resnet18", target_shape=(24, 24, 24), axes=[0, 1, 2], counts=[2, 3, 4],
            input_size=48, tta=2, per_slice=True, progress=False, device=dev,
            subjects_per_call=4))
    cpu, card = out["cpu"], out[str(cuda)]
    assert card.shape == (10, 9, 512)
    assert np.abs(card - cpu).max() <= embed_checks.F32_REL * np.abs(cpu).max()
