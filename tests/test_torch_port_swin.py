"""Swin-T as the MIL fine-tune's slice backbone (``pd_fusion_torch/nn/swin.py``)
against the benchmark's plain reference (``benchmark/reference/swin.py``,
``mil_ft_swin.py``: the published forward with the bias gathered by
index), on the CPU.

The small network keeps every kind of stage Swin-T has at 224^2: 32^2
inputs in 4x4 patches and windows of 2 give maps of 8, 4, 2 and 1, so the
first two stages are shifted with masked regions, the third's map equals
its window (no shift) and the fourth's is smaller (one window of 1), with
three patch mergings between. Published Swin-T at 224^2 is checked on one
image too.

- Embeddings: float64 to 1e-12 relative (the port's patch GEMM and the
  reference's convolution add in other orders, nothing else differs: the
  one-hot bias is the gathered value exactly), float32 to 1e-5.
- The fine-tune's first step (float32: K1 takes float32 only): the loss to
  rtol 1e-5 and each leaf's gradient to 1e-4 of its L2 norm (float32
  rounding through 8 blocks, LayerNorm and the head); the parameters after
  3 steps, each leaf's change to 1e-3 of its own (Adam moves every weight
  by about lr whatever its gradient's size, so a gradient within rounding
  of 0 could flip a weight's move; leaves whose reference gradient is
  under 1e-3 of the median leaf's are left out, as the benchmark does).
- A TTA-2 ``predict_proba`` from the same draws: probabilities to 1e-5.
- One token perturbed changes a block's output in its own window alone
  (W-MSA), or in its window of the rolled map (SW-MSA), and there, across
  the mask's regions, by e^-100 of a weight at most.
- A Swin step calls no op of ``ATOMIC_ATEN_OPS`` (the reference's gather
  does: ``index_put(accumulate)``).
- ``load_backbone`` reads a checkpoint in the official
  ``swin_tiny_patch4_window7_224`` layout (a synthetic one).
- The CLI's fine-tune (``cli.main run``) on a 2-fold CV of 12 synthetic
  NIfTI subjects with ``backbone`` a Swin.
- On a card (``cuda`` marker): a full-width Swin-T step (2 bags of 8 slices)
  run twice from one state gives the same bits and dispatches no atomic op,
  and the card's embeddings match the CPU's to 1e-5 (float32, TF32 off).

The module imports no JAX: ``python -m pytest tests/test_torch_port_swin.py -q``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pd_fusion_torch.models import mil_attention_finetune as mft
from pd_fusion_torch.nn import ft_optim, swin
from pd_fusion_torch.nn.mil import mil_init
from pd_fusion_torch.nn.resnet import params_to
from pd_fusion_torch.utils import determinism_checks as dc

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from benchmark.drives.train import HEAD_NAMES  # noqa: E402
from benchmark.drives.train_swin import from_program, to_program  # noqa: E402
from benchmark.harness import draws, weights  # noqa: E402
from benchmark.reference import mil_ft, mil_ft_swin  # noqa: E402
from benchmark.reference import swin as ref  # noqa: E402

TINY = swin.SwinArch(patch=4, embed_dim=8, depths=(2, 2, 2, 2), heads=(1, 2, 2, 4), window=2,
                     mlp_ratio=4)
SIZE, HW, L, B, HIDDEN, ATTN = 32, 16, 3, 4, 16, 8
PARAMS = {"backbone": "swin_test", "pretrained": False, "target_shape": [HW, HW, HW],
          "slice_count": L, "input_size": SIZE, "batch_size": B, "epochs": 1,
          "freeze_backbone_epochs": 0, "early_stopping_patience": 0, "hidden_dim": HIDDEN,
          "attn_dim": ATTN, "gated": True, "dropout": 0.2, "train_aug": True,
          "balanced_batches": True, "loss_type": "focal", "focal_gamma": 2.0,
          "focal_alpha": 0.25, "lr": 3e-4, "lr_backbone": 1e-4, "weight_decay": 1e-3,
          "max_grad_norm": 1.0, "tta_inference": 2, "max_rotation_deg": 8.0,
          "max_translation": 0.05, "intensity_scale": 0.15, "intensity_shift": 0.15,
          "noise_std": 0.02}


def _ref_arch(a: swin.SwinArch) -> ref.Arch:
    return ref.Arch(a.patch, a.embed_dim, a.depths, a.heads, a.window, a.mlp_ratio,
                    swin.MASK_VALUE, swin.LN_EPS)


@pytest.fixture(autouse=True)
def _tiny_arch(monkeypatch):
    monkeypatch.setitem(swin.ARCHS, "swin_test", TINY)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed=0, arch=TINY, size=SIZE, spread=0.1):
    """The seeded init with every leaf moved off its init (LayerNorms and
    biases off identity and 0)."""
    p = swin.init_swin(torch.Generator().manual_seed(seed), arch, size)
    gen = torch.Generator().manual_seed(seed + 1)
    return to_program({k: v + spread * torch.randn(v.shape, generator=gen)
                       for k, v in from_program(p).items()})


def test_the_small_size_keeps_every_kind_of_stage():
    assert swin.stage_windows(TINY, SIZE) == [(8, 2, 1), (4, 2, 1), (2, 2, 0), (1, 1, 0)]
    for res in (8, 4):
        assert (swin.shift_mask(res, 2, 1) == swin.MASK_VALUE).any()
    assert swin.stage_windows("swin_t", 224) == [(56, 7, 3), (28, 7, 3), (14, 7, 3), (7, 7, 0)]
    with pytest.raises(ValueError):
        swin.stage_windows("swin_t", 160)  # 40 is no multiple of 7


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)],
                         ids=["float64", "float32"])
def test_embeddings_match_the_reference(dtype, tol):
    p = params_to(_params(), dtype=dtype)
    x = torch.randn(5, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(2), dtype=dtype)
    got = swin.swin_apply_train(p, x, TINY)
    want = ref.forward(from_program(p), x.permute(0, 3, 1, 2), _ref_arch(TINY))
    assert got.shape == (5, swin.emb_dim(TINY)) == (5, 64)
    assert torch.linalg.norm(got - want) <= tol * torch.linalg.norm(want)
    assert torch.equal(swin.swin_apply(p, x, TINY), got.detach())


def test_published_swin_t():
    """Swin-T at 224^2 on one image, and its parameter count: the official
    model's 28,288,354 less its 768 x 1000 classifier and bias."""
    p = swin.init_swin(torch.Generator().manual_seed(0), "swin_t")
    assert sum(t.numel() for t in from_program(p).values()) == 28_288_354 - 769_000
    x = torch.randn(1, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    got = swin.swin_apply(p, x, "swin_t")
    want = ref.forward(from_program(p), x.permute(0, 3, 1, 2), _ref_arch(swin.ARCHS["swin_t"]))
    assert got.shape == (1, 768)
    assert torch.linalg.norm(got - want) <= 1e-5 * torch.linalg.norm(want)


def _inputs(seed=3):
    """A training batch for the program and the same batch for the
    reference, drawn as the benchmark draws it."""
    rng = draws.generator(seed, 0)
    d = {k: torch.as_tensor(v) for k, v in draws.aug(rng, B, L, HW, HW, PARAMS).items()}
    slices = torch.rand(B, L, HW, HW, generator=torch.Generator().manual_seed(seed))
    y = torch.tensor([1.0, 1.0, 0.0, 0.0])
    keep = torch.as_tensor(rng.random((B, L, HIDDEN)) < 0.8)
    ones = torch.ones(B, L)
    program = dict(d, slices=slices, bag_mask=ones, bn_mask=ones, y=y, valid=torch.ones(B),
                   keep=keep)
    reference = dict(d, slices=slices, mask=ones, y=y, valid=torch.ones(B), keep=keep)
    return program, reference


def _program_hyper():
    half = torch.full((3,), 0.5)
    return {"arch": "swin_test", "gated": True, "input_size": SIZE, "mean": half, "std": half,
            "loss_type": "focal", "pos_weight": 1.0, "focal_gamma": 2.0, "focal_alpha": 0.25,
            "head_dropout": PARAMS["dropout"], "lr_backbone": PARAMS["lr_backbone"],
            "lr": PARAMS["lr"], "weight_decay": PARAMS["weight_decay"],
            "max_grad_norm": PARAMS["max_grad_norm"]}


def _start():
    bp = _params(4)
    hp = mil_init(torch.Generator().manual_seed(5), swin.emb_dim(TINY), HIDDEN, ATTN, True)
    return bp, hp


def _names():
    """The program's leaves' order, by the reference's names."""
    return (mft.trainable_leaves(to_program({k: k for k in ref.param_shapes(_ref_arch(TINY),
                                                                            SIZE)})),
            mft.trainable_leaves(weights.to_program_head({k: k for k in HEAD_NAMES})))


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-30))


def test_first_step_and_three_steps_match_the_reference():
    bp, hp = _start()
    batch, ref_batch = _inputs()
    hy, rhy = _program_hyper(), mil_ft.hyper(dict(PARAMS, backbone="swin_test", pretrained=False))
    names_b, names_h = _names()
    rbp, rhp = from_program(bp), weights.from_program_head(hp)

    g_b, g_h, loss, stats = mft.ft_grads(bp, hp, batch, 1.0, hy)
    r_loss, r_grads = mil_ft_swin.loss_and_grads(rbp, rhp, ref_batch, rhy, _ref_arch(TINY))
    assert stats is None
    assert float(loss) == pytest.approx(float(r_loss), rel=1e-5)
    raw = {k: float(torch.linalg.norm(v)) for k, v in r_grads.items()}
    floor = 1e-3 * float(np.median(list(raw.values())))
    for name, g in zip(names_b + names_h, g_b + g_h):
        if raw[name] >= floor:
            assert _rel(g, r_grads[name]) < 1e-4, name
        else:  # a bias under a softmax (below): rounding on both sides
            assert float(torch.linalg.norm(g)) < floor, name

    opt = {"backbone": ft_optim.init_group(mft.trainable_leaves(bp)),
           "head": ft_optim.init_group(mft.trainable_leaves(hp))}
    b, h = bp, hp
    batches = []
    for k in range(3):
        batch, ref_batch = _inputs(3 + k)
        b, h, _ = mft.ft_step(b, h, opt, batch, 1.0, hy)
        batches.append(ref_batch)
    steps = mil_ft_swin.train_steps(rbp, rhp, batches, rhy, _ref_arch(TINY))
    after = {**from_program(b), **weights.from_program_head(h)}
    want = {**steps[-1]["backbone"], **steps[-1]["head"]}
    start = {**rbp, **rhp}
    moved = [k for k in want if raw[k] >= floor]
    # a bias under a softmax takes no gradient: the head's attn_w.b, and the
    # last stage's bias tables (its windows hold one token)
    assert set(want) - set(moved) == {"attn_w.b"} | {
        f"layers.3.blocks.{j}.attn.relative_position_bias_table" for j in (0, 1)}
    for k in moved:
        assert _rel(after[k] - start[k], want[k] - start[k]) < 1e-3, k


def test_tta_predict_matches_the_reference():
    bp, hp = _start()
    bags = [np.random.default_rng(i).random((L, HW, HW), dtype=np.float32) for i in range(6)]
    rngs = draws.CallRngs(11)
    model = mft.MilAttentionFineTuneModel(dict(PARAMS), device="cpu", make_rng=rngs)
    model.backbone_params, model.head_params = bp, hp
    got = model.predict_proba(bags)
    rng = draws.generator(11, 0)

    def aug(B_, L_, h, w):
        return {k: torch.as_tensor(v) for k, v in draws.aug(rng, B_, L_, h, w, PARAMS).items()}

    hy = mil_ft.hyper(dict(PARAMS, backbone="swin_test", pretrained=False))
    want = mil_ft_swin.predict(from_program(bp), weights.from_program_head(hp),
                               [torch.as_tensor(b) for b in bags], aug, hy, _ref_arch(TINY), B, 2)
    assert got.shape == (6,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_train_and_predict_through_the_model(tmp_path):
    """``train`` and ``predict_proba``, the fine-tune CLI's entry points,
    on a Swin backbone: every leaf trains (none is a running statistic),
    and a saved model predicts the same after loading."""
    bags = [np.random.default_rng(i).random((L, HW, HW), dtype=np.float32) for i in range(8)]
    y = np.array([1, 0] * 4, np.float32)
    model = mft.MilAttentionFineTuneModel(dict(PARAMS), device="cpu",
                                          make_rng=draws.CallRngs(5))
    before = {k: v.clone() for k, v in from_program(model.backbone_params).items()}
    model.train(bags, y)
    after = from_program(model.backbone_params)
    assert set(after) == set(before) == set(ref.param_shapes(_ref_arch(TINY), SIZE))
    assert all(not torch.equal(after[k], before[k]) for k in after)
    p = model.predict_proba(bags[:5] + [None])
    assert np.isfinite(p).all() and p[-1] == np.float32(PARAMS.get("missing_prob", 0.5))
    model.save(tmp_path / "m.pkl")
    loaded = mft.MilAttentionFineTuneModel.load(tmp_path / "m.pkl", device="cpu")
    loaded.make_rng, model.make_rng = draws.CallRngs(9), draws.CallRngs(9)
    np.testing.assert_array_equal(loaded.predict_proba(bags), model.predict_proba(bags))


def _rolled(i, j, window, shift, res):
    """Token (i, j)'s window in the rolled map and its region there (the
    official mask's nine regions: the last ``window`` rows and columns cut
    at ``shift``)."""
    r, c = (i - shift) % res, (j - shift) % res
    region = [0 if v < res - window else 1 if v < res - shift else 2 for v in (r, c)]
    return (r // window, c // window), (3 * region[0] + region[1]) if shift else 0


@pytest.mark.parametrize("token", [(0, 0), (3, 4), (5, 7)])
@pytest.mark.parametrize("shift", [0, 1], ids=["W-MSA", "SW-MSA"])
def test_a_token_changes_its_own_windows_alone(token, shift):
    res, window, C, heads = 8, 2, 8, 1
    block = params_to(_params(6)["layers"][0]["blocks"][shift], dtype=torch.float64)
    mask = swin.shift_mask(res, window, shift, dtype=torch.float64)
    x = torch.randn(1, res, res, C, generator=torch.Generator().manual_seed(7),
                    dtype=torch.float64)
    y = x.clone()
    y[0, token[0], token[1]] += torch.randn(C, generator=torch.Generator().manual_seed(8),
                                            dtype=torch.float64)  # not constant: LN takes that out
    change = (swin._block(y, block, heads, window, shift, mask)
              - swin._block(x, block, heads, window, shift, mask)).abs().amax(-1)[0]
    mine, my_region = _rolled(*token, window, shift, res)
    for i in range(res):
        for j in range(res):
            where, region = _rolled(i, j, window, shift, res)
            if (i, j) == token:
                assert change[i, j] > 0.1
            elif where != mine:
                assert change[i, j] == 0.0, (i, j)
            elif region != my_region:
                assert change[i, j] < 1e-30, (i, j)  # weights of e^-100 across the mask
            else:
                assert change[i, j] > 1e-6, (i, j)


def test_a_swin_step_calls_no_atomic_op():
    bp, hp = _start()
    batch, ref_batch = _inputs()
    opt = {"backbone": ft_optim.init_group(mft.trainable_leaves(bp)),
           "head": ft_optim.init_group(mft.trainable_leaves(hp))}
    ops = dc.aten_ops_called(lambda: mft.ft_step(bp, hp, opt, batch, 1.0, _program_hyper()))
    assert not ops & dc.ATOMIC_ATEN_OPS and {"mm", "bmm", "roll"} <= ops
    rhy = mil_ft.hyper(dict(PARAMS, backbone="swin_test", pretrained=False))
    gathered = dc.aten_ops_called(lambda: mil_ft_swin.loss_and_grads(
        from_program(bp), weights.from_program_head(hp), ref_batch, rhy, _ref_arch(TINY)))
    assert "index_put(accumulate)" in gathered  # the indexed bias's backward


def _official_state_dict(seed=0):
    """A synthetic checkpoint in ``swin_tiny_patch4_window7_224``'s layout:
    every parameter under its name and shape, the buffers the official
    module registers (the relative position indices, the shifted blocks'
    masks) and the classifier."""
    a = _ref_arch(swin.ARCHS["swin_t"])
    gen = torch.Generator().manual_seed(seed)
    sd = {k: torch.randn(s, generator=gen) for k, s in ref.param_shapes(a, 224).items()}
    for i, ((res, _, window, shift), depth) in enumerate(zip(ref.stages(a, 224), a.depths)):
        for j in range(depth):
            pre = f"layers.{i}.blocks.{j}."
            sd[pre + "attn.relative_position_index"] = ref.relative_position_index(window)
            if j % 2 and shift:
                sd[pre + "attn_mask"] = ref.attn_mask(res, window, shift, -100.0, "cpu")
    sd["head.weight"], sd["head.bias"] = torch.randn(1000, 768), torch.randn(1000)
    return sd


def test_load_backbone_reads_an_official_checkpoint(tmp_path):
    sd = _official_state_dict()
    path = tmp_path / "swin_tiny_patch4_window7_224.pth"
    torch.save({"model": sd}, path)
    params, dim, pretrained = mft.load_backbone("swin_t", weights_path=path)
    assert dim == 768 and pretrained
    flat = from_program(params)
    assert set(flat) == {k for k in sd if "relative_position_index" not in k
                         and "attn_mask" not in k and not k.startswith("head.")}
    assert all(torch.equal(flat[k], sd[k]) for k in flat)
    model = mft.MilAttentionFineTuneModel({"backbone": "swin_t", "pretrained": True,
                                           "weights_path": str(path)}, device="cpu")
    assert model.pretrained and model.emb_dim == 768
    assert torch.equal(model.backbone_params["layers"][2]["blocks"][5]["attn"]["qkv"]["weight"],
                       sd["layers.2.blocks.5.attn.qkv.weight"])
    small = {k: v.numpy() for k, v in from_program(_params()).items()}
    np.savez(tmp_path / "tiny.npz", **small)
    tiny, dim, _ = swin.load_backbone(TINY, weights_path=tmp_path / "tiny.npz")
    assert dim == 64 and all(np.array_equal(from_program(tiny)[k].numpy(), v)
                             for k, v in small.items())
    with pytest.raises(ValueError):
        swin.convert_official_state_dict(small, "swin_t")  # the stages are not Swin-T's


def test_cli_runs_a_swin_finetune_cv(tmp_path, monkeypatch):
    import pandas as pd
    import yaml

    from pd_fusion_torch import cli
    from pd_fusion_torch.imaging.nifti import write_nifti
    from pd_fusion_torch.paths import ROOT_DIR

    rng = np.random.RandomState(0)
    rows = []
    for i in range(12):
        vol = rng.rand(24, 28, 26).astype(np.float32) * 0.3
        vol[2:22, 2:26, 2:24] += 0.4
        if i % 2:
            vol[8:16, 8:16, 8:16] += 1.5  # PD subjects have a bright blob
        path = tmp_path / f"sub-{i:02d}_T1w.nii.gz"
        write_nifti(path, vol)
        rows.append({"subject_id": f"sub-{i:02d}", "session": 1, "label": i % 2,
                     "t1wbrain_path": str(path)})
    pd.DataFrame(rows).to_csv(tmp_path / "manifest.csv", index=False)
    monkeypatch.setenv("PD_FUSION_DS001907_MANIFEST", str(tmp_path / "manifest.csv"))
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    cfg = yaml.safe_load((ROOT_DIR / "configs/openneuro_ds001907_resnet2d_mil_ft.yaml").read_text())
    cfg["params"].update(PARAMS, epochs=2, freeze_backbone_epochs=1, early_stopping_patience=0)
    cfg["cv_folds"] = 2
    cfg["calibration_split"] = 0.5  # a tenth of 6 training subjects is no split
    cfg["data_config"] = str(ROOT_DIR / cfg["data_config"])
    cfg["eval_config"] = str(ROOT_DIR / cfg["eval_config"])
    (tmp_path / "ft.yaml").write_text(yaml.safe_dump(cfg))
    agg = cli.main(["run", "--config", str(tmp_path / "ft.yaml"), "--output-dir",
                    str(tmp_path / "run")])
    assert np.isfinite(agg["full_observation"]["roc_auc"]["mean"])
    assert (tmp_path / "run" / "preds_fold_2_full_observation.csv").exists()

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step's run-to-run bits exist only on a card")
    from pd_fusion_torch.utils.device import get_device

    return get_device("cuda")  # float32 products stay float32 (TF32 off)


@pytest.mark.cuda
def test_swin_t_on_the_card(cuda):
    from pd_fusion_torch.models import ft_checks

    cpu_params = swin.init_swin(torch.Generator().manual_seed(0), "swin_t")
    bp = params_to(cpu_params, device=cuda)
    hp = mil_init(torch.Generator().manual_seed(1), 768, ft_checks.HIDDEN, ft_checks.ATTN, True,
                  device=cuda)
    hy = dict(ft_checks.hyper(cuda), arch="swin_t")
    batch = {k: torch.as_tensor(v, device=cuda)
             for k, v in ft_checks.step_inputs(2, 8, ft_checks.HW, seed=3).items()}

    def state():
        return (mft._clone(bp), mft._clone(hp),
                {"backbone": ft_optim.init_group(mft.trainable_leaves(bp)),
                 "head": ft_optim.init_group(mft.trainable_leaves(hp))})

    def step(st):
        b, h, loss = mft.ft_step(*st, batch, 1.0, hy)
        return {"backbone": b, "head": h, "loss": loss, "moments": st[2]}

    twice = dc.run_twice(step, state)
    assert all(equal for equal, _ in twice.values()), {k: v for k, v in twice.items() if not v[0]}
    assert not dc.atomic_ops_called(lambda: step(state()))
    x = torch.rand(2, 224, 224, 3, generator=torch.Generator().manual_seed(2)) * 4 - 2
    want = swin.swin_apply(cpu_params, x, "swin_t")
    got = swin.swin_apply(bp, x.to(cuda), "swin_t").cpu()
    assert torch.linalg.norm(got - want) <= 1e-5 * torch.linalg.norm(want)
