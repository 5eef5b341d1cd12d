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
TreeSHAP), ``pd_fusion_torch/imaging/embed_checks.py`` (the ResNet
backbones and the embed pipeline, card against CPU) and
``pd_fusion_torch/models/ft_checks.py`` (one MIL fine-tune step at full
width, frozen and not, card against CPU),
``pd_fusion_torch/ops/volume_stats_checks.py`` (the simple 3-D statistics,
card against CPU), ``pd_fusion_torch/nn/cnn3d_checks.py`` (one CNN3D
training step, card against CPU) and
``pd_fusion_torch/analysis/tabular_checks.py`` (the PPMI suites' logistic
fit, AUC screen, permutation probes and stacked GBDT fit) and
``pd_fusion_torch/analysis/sweep_checks.py`` (the bootstrap program, the
stress test's MLP training, the fused sweep against standalone runs) and
``pd_fusion_torch/utils/determinism_checks.py`` (ECE and the repaired
training steps, the same on every run), which ``chip_smoke.py`` runs too.
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


def test_mil_finetune_step_on_the_card_matches_the_cpu(cuda):
    """One fine-tune step (ResNet-50 at 224^2, B=2, L=8, gated head, focal
    loss, a ragged row) with the gate at 0 and at 1, card against CPU
    (``models/ft_checks.py``'s tolerances); K1 carries the head on the card."""
    from pd_fusion_torch.models import ft_checks
    from pd_fusion_torch.utils.device import get_device

    get_device(cuda)  # TF32 off
    before = ap.launch_counts["kernel"]
    errs = ft_checks.compare_card_with_cpu(cuda)
    assert set(errs) == {"gate0", "gate1"}
    assert ap.launch_counts["kernel"] == before + 2


def test_simple_volume_features_on_the_card_match_the_cpu(cuda):
    """A batch of 8 at the feature config's width (96^3, 10 bins, grid 8),
    ``extra_stats`` off and on (``ops/volume_stats_checks.py``: order
    statistics and histogram equal)."""
    import numpy as np

    from pd_fusion_torch.ops import volume_stats_checks

    rng = np.random.default_rng(0)
    vols = (rng.random((8, 96, 96, 96), dtype=np.float32) * 900.0).astype(np.float32)
    vols[:, :12] = 0.0  # background outside the mask
    vols[3] = 0.0  # an empty mask uses every voxel
    vols[5] = 250.0  # a degenerate range
    errs = volume_stats_checks.compare_card_with_cpu(vols, cuda)
    assert set(errs) == {"extra_off", "extra_on"}


def test_cnn3d_step_on_the_card_matches_the_cpu(cuda):
    """One Adam step at the data config's cnn_config (64^3, embedding 64,
    batch 8; ``nn/cnn3d_checks.py``'s tolerances), from one init and batch."""
    from pd_fusion_torch.nn import cnn3d_checks
    from pd_fusion_torch.utils.device import get_device

    get_device(cuda)  # TF32 off
    vols = cnn3d_checks.synthetic_volumes(10, cnn3d_checks.CNN_CONFIG["target_shape"])
    errs = cnn3d_checks.compare_card_with_cpu(vols, cuda)
    assert errs["loss_rel"] <= cnn3d_checks.LOSS_RTOL


def test_balanced_logreg_on_the_card_matches_the_cpu(cuda):
    from pd_fusion_torch.analysis import tabular_checks

    tabular_checks.check_logreg(cuda, shape=(300, 40))


def test_auc_screen_on_the_card_matches_the_cpu(cuda):
    from pd_fusion_torch.analysis import tabular_checks

    tabular_checks.check_auc_screen(cuda)


def test_permutation_screen_on_the_card_matches_the_cpu(cuda):
    from pd_fusion_torch.analysis import tabular_checks

    tabular_checks.check_permutation_screen(cuda, shape=(300, 20))


def test_stacked_gbdt_fit_on_the_card_equals_each_models_own_fit(cuda):
    from pd_fusion_torch.analysis import tabular_checks

    tabular_checks.check_gbdt_stack(cuda, K=3, n=300, f=20, rounds=20)


def test_bootstrap_program_on_the_card_matches_the_cpu(cuda):
    from pd_fusion_torch.analysis import sweep_checks

    sweep_checks.check_bootstrap(cuda)


def test_stress_mlp_training_on_the_card_matches_the_cpu(cuda):
    from pd_fusion_torch.analysis import sweep_checks

    sweep_checks.check_stress_training(cuda, sweep_checks.stress_inputs(n=400, F=60, epochs=5))


@pytest.mark.parametrize("model_type,params,atol", [
    ("fusion_moddrop", {"hidden_dims": [64, 32], "dropout": 0.2, "lr": 0.001, "batch_size": 32,
                        "epochs": 10, "moddrop_rate": 0.3}, trainer_checks.FULL_ATOL[1]),
    ("unimodal_gbdt", {"backend": "device", "n_estimators": 20, "max_depth": 5}, 5e-3),
], ids=["fusion_moddrop", "unimodal_gbdt-device"])
def test_fused_sweep_on_the_card_matches_standalone_runs(cuda, tmp_path, monkeypatch, model_type,
                                                          params, atol):
    """Equal folds (N=500, k=5): the fused S x K stack against each seed's
    standalone run on the card (rounding of S x K against K batch entries;
    the GBDT's exact-gain-tie note of ``tests/test_seed_sweep.py``)."""
    from pd_fusion_torch.analysis import sweep_checks
    from pd_fusion_torch.parallel.seed_sweep import run_multi_seed_cv
    from pd_fusion_torch.utils.io import load_yaml

    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cuda")
    config = load_yaml("configs/quickstart.yaml")
    config.update(model_type=model_type, params=params, modality="clinical")
    data_config = load_yaml("configs/data_ppmi.yaml")
    eval_config = load_yaml("configs/eval_missingness.yaml")
    run_multi_seed_cv(dict(config), data_config, eval_config, seeds=[42, 43], k=5,
                      synthetic=True, sweep_dir=tmp_path)
    gaps = sweep_checks.standalone_gaps(config, data_config, eval_config, [42, 43], 5, tmp_path)
    assert max(gaps.values()) <= atol, gaps


@pytest.mark.parametrize("n,N", [(1000, 1500), (5, 500)], ids=["bootstrap", "bench-frame"])
def test_ece_is_the_same_on_every_run_on_the_card(cuda, n, N):
    """ECE's bin sums in a fixed order: ten calls on the same inputs equal
    bit for bit (``scatter_add`` gave 20 different results of 20 at the
    bootstrap's [1000, 1500])."""
    from pd_fusion_torch.analysis.sweep_checks import bootstrap_inputs
    from pd_fusion_torch.ops.metrics import binary_metrics, expected_calibration_error
    from pd_fusion_torch.utils import determinism_checks

    if n == 1000:
        y, p, w = (*(t.to(cuda) for t in bootstrap_inputs(n, N)), None)
    else:
        y, p, w = (t.to(cuda) for t in determinism_checks.ece_inputs(n, N))
    first = expected_calibration_error(y, p, w)
    metrics = binary_metrics(y, p, w)
    for _ in range(9):
        assert torch.equal(expected_calibration_error(y, p, w), first)
    assert all(torch.equal(v, metrics[k]) for k, v in binary_metrics(y, p, w).items())


def test_cnn3d_step_is_the_same_twice_on_the_card(cuda):
    """The CNN3D step at the data config's width (64^3, embedding 64, batch
    8), its data gradients as forward convolutions: two runs from one state
    equal bit for bit (through cuDNN's backward-data kernel they differed
    by up to 1.49e-08; ``chip_smoke.py`` phase 39)."""
    from pd_fusion_torch.utils import determinism_checks
    from pd_fusion_torch.utils.device import get_device

    get_device(cuda)  # TF32 off
    prog = determinism_checks.program("cnn3d_train_step", cuda)
    twice = determinism_checks.run_twice(prog.fn, prog.make_state)
    assert all(eq for eq, _ in twice.values()), [k for k, (eq, _) in twice.items() if not eq]
