"""MaxViT-T as the MIL fine-tune's slice backbone (``pd_fusion_torch/nn/maxvit.py``)
against the benchmark's plain reference (``benchmark/reference/maxvit.py``,
``mil_ft_maxvit.py``: the published forward with ``F.conv2d(groups=)``,
``F.batch_norm`` and the bias gathered by index), on the CPU.

The small network keeps every kind of stage MaxViT-T has at 224^2: 64^2
inputs, a stem to 32^2 and groups of 2 x 2 tokens give maps of 16, 8, 4 and
2, so the grid's groups are spread (8, 4 and 2 apart) in the first three
stages and the last stage's map equals its window (both partitions are the
whole map there); stage 1 has a block with the identity shortcut and
stage 4 two blocks. Published MaxViT-T at 224^2 is checked on one image.

- Embeddings, train-mode (batch statistics, the running statistics moved)
  and inference (running statistics): float64 to 1e-12 relative, float32
  to 1e-5.
- The fine-tune's first step and three steps (float32), at Swin's
  tolerances and for its reasons (``test_torch_port_swin.py``: float32
  rounding through the blocks, BN and the head): the loss to rtol 1e-5,
  the running statistics to 1e-5, each gradient to 1e-4 of its leaf's
  norm; each change after three steps to 1e-3 of its own, running
  statistics included, over the weights whose Adam input keeps its sign
  within the two sides' rounding (Adam moves a weight by about lr
  whatever its input's size; here the decay nearly cancels a few
  gradients), and within 2 lr a step everywhere. Leaves whose reference
  gradient is under 1e-3 of the median leaf's are left out, as the
  benchmark does: the head's ``attn_w.b`` and each MBConv's pre-norm
  shift, whose gradient is 0 exactly, as the BN after the bias-free 1x1
  expansion takes a constant a channel out.
- A TTA-2 ``predict_proba`` from the same draws: probabilities to 1e-5.
- One token perturbed changes block attention's output in its own window
  alone, and grid attention's in its own grid group alone.
- The depthwise convolution's own gradients (``nn/resnet.py::_Conv2d``
  with ``groups``) against ``F.conv2d``'s autograd in float64: strides 1
  and 2, three widths, odd sides, and through the weighted train-mode BN.
- The recomputed MBConvs give the step the bits that keeping them gives:
  the loss, every gradient and the running statistics, moved once; the
  counters count each recompute and every BN call.
- A MaxViT step calls no op of ``ATOMIC_ATEN_OPS`` (the reference's gather
  and convolution backward do).
- ``flops_maxvit``: 5.6 GMAC an image at 224^2 (the paper's), the
  published parameter count (torchvision's 30,919,624 less its
  classifier's two linears), a torchvision-layout checkpoint read by
  ``load_backbone``, ``train`` / ``predict_proba`` / save and load through
  the model, and the CLI's fine-tune CV.
- The ``embed_build`` cell's reference (``benchmark/reference/embed.py``)
  against the program's prep and build on one small volume.
- On a card (``cuda`` marker): published MaxViT-T on one image against the
  reference there, the shortcut pool's gradient against float64 (torch's
  CUDA backward of a channels-last pool is wrong), two unfrozen
  256-image steps from one state equal bit for bit with no atomic op, the
  step's peak under 72 GB, and the fused BN's calls a step.

The module imports no JAX: ``python -m pytest tests/test_torch_port_maxvit.py -q``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pd_fusion_torch.models import mil_attention_finetune as mft
from pd_fusion_torch.nn import ft_optim, maxvit, swin
from pd_fusion_torch.nn.mil import mil_init
from pd_fusion_torch.nn.resnet import params_to
from pd_fusion_torch.ops import weighted_bn
from pd_fusion_torch.utils import determinism_checks as dc
from pd_fusion_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from benchmark import flops_maxvit  # noqa: E402
from benchmark.drives.train import HEAD_NAMES  # noqa: E402
from benchmark.drives.train_maxvit import from_program, to_program  # noqa: E402
from benchmark.harness import draws, weights  # noqa: E402
from benchmark.reference import maxvit as ref  # noqa: E402
from benchmark.reference import mil_ft, mil_ft_maxvit  # noqa: E402

TINY = maxvit.MaxVitArch(stem=8, widths=(8, 16, 32, 64), depths=(2, 1, 1, 2), head_dim=8,
                         partition=2)
SIZE, HW, L, B, HIDDEN, ATTN = 64, 16, 3, 4, 16, 8
N_MBCONV = sum(TINY.depths)
PARAMS = {"backbone": "maxvit_test", "pretrained": False, "target_shape": [HW, HW, HW],
          "slice_count": L, "input_size": SIZE, "batch_size": B, "epochs": 1,
          "freeze_backbone_epochs": 0, "early_stopping_patience": 0, "hidden_dim": HIDDEN,
          "attn_dim": ATTN, "gated": True, "dropout": 0.2, "train_aug": True,
          "balanced_batches": True, "loss_type": "focal", "focal_gamma": 2.0,
          "focal_alpha": 0.25, "lr": 3e-4, "lr_backbone": 1e-4, "weight_decay": 1e-3,
          "max_grad_norm": 1.0, "tta_inference": 2, "max_rotation_deg": 8.0,
          "max_translation": 0.05, "intensity_scale": 0.15, "intensity_shift": 0.15,
          "noise_std": 0.02}
PUBLISHED = ref.Arch(64, (64, 128, 256, 512), (2, 2, 5, 2), 32, 7, 4, 0.25, 4, 1e-3, 1e-5)


def _ref_arch(a: maxvit.MaxVitArch) -> ref.Arch:
    return ref.Arch(a.stem, a.widths, a.depths, a.head_dim, a.partition, a.expansion, a.squeeze,
                    a.mlp_ratio, maxvit.BN_EPS, swin.LN_EPS)


@pytest.fixture(autouse=True)
def _tiny_arch(monkeypatch):
    monkeypatch.setitem(maxvit.ARCHS, "maxvit_test", TINY)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed=0, arch=TINY, spread=0.1):
    """The seeded init with every leaf moved off its init (norms and biases
    off identity and 0, running variances off 1)."""
    p = maxvit.init_maxvit(torch.Generator().manual_seed(seed), arch)
    gen = torch.Generator().manual_seed(seed + 1)
    return to_program({k: v + (spread * torch.randn(v.shape, generator=gen)
                               if not k.endswith("running_var")
                               else 0.5 * torch.rand(v.shape, generator=gen))
                       for k, v in from_program(p, arch).items()}, arch)


def test_the_small_size_keeps_every_kind_of_stage():
    assert maxvit.stage_maps(TINY, SIZE) == [16, 8, 4, 2]
    assert maxvit.stage_maps("maxvit_t", 224) == [56, 28, 14, 7]
    with pytest.raises(ValueError):
        maxvit.stage_maps("maxvit_t", 160)  # 40 is no multiple of 7
    x = torch.arange(16 * 16, dtype=torch.float64).view(1, 16, 16, 1)
    group = maxvit._grid(x, 2)[0, :, 0].long()  # the first group's tokens, 8 apart
    assert group.tolist() == [0, 8, 8 * 16, 8 * 16 + 8]
    assert torch.equal(maxvit._grid_reverse(maxvit._grid(x, 2), 2, 1, 16, 16), x)
    last = torch.randn(3, 2, 2, 5, dtype=torch.float64)  # a map that equals its window
    assert torch.equal(maxvit._grid(last, 2), swin._partition(last, 2))
    assert {k for k, _ in mft._flatten(_params())} >= {"mean", "var", "gamma", "w"}


@pytest.mark.parametrize("train", [False, True], ids=["inference", "train"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)],
                         ids=["float64", "float32"])
def test_embeddings_match_the_reference(dtype, tol, train):
    p = params_to(_params(), dtype=dtype)
    x = torch.randn(5, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(2), dtype=dtype)
    want, stats = ref.forward(from_program(p, TINY), x.permute(0, 3, 1, 2), _ref_arch(TINY),
                              train=train)
    if train:
        got, new = maxvit.maxvit_apply_train(p, x, TINY)
        moved = from_program(new, TINY)
        assert set(stats) == {k for k in moved if k.endswith(("running_mean", "running_var"))}
        for k, v in stats.items():
            assert torch.linalg.norm(moved[k] - v) <= tol * torch.linalg.norm(v), k
    else:
        got = maxvit.maxvit_apply(p, x, TINY)
    assert got.shape == (5, maxvit.emb_dim(TINY)) == (5, 64)
    assert torch.linalg.norm(got - want) <= tol * torch.linalg.norm(want)


def test_published_maxvit_t():
    """MaxViT-T at 224^2 on one image, and its parameter count: torchvision's
    30,919,624 less its classifier's Linear(512, 512) and Linear(512, 1000,
    bias=False)."""
    p = maxvit.init_maxvit(torch.Generator().manual_seed(0), "maxvit_t")
    flat = from_program(p, "maxvit_t")
    assert sum(t.numel() for k, t in flat.items() if "running" not in k) == \
        30_919_624 - 512 * 513 - 512 * 1000 == 30_144_968
    assert set(flat) == set(ref.param_shapes(PUBLISHED)) | set(ref.running_shapes(PUBLISHED))
    assert all(tuple(flat[k].shape) == s for k, s in ref.param_shapes(PUBLISHED).items())
    x = torch.randn(1, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    got = maxvit.maxvit_apply(p, x, "maxvit_t")
    want, _ = ref.forward(flat, x.permute(0, 3, 1, 2), PUBLISHED, train=False)
    assert got.shape == (1, 512)
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
    return {"arch": "maxvit_test", "gated": True, "input_size": SIZE, "mean": half, "std": half,
            "loss_type": "focal", "pos_weight": 1.0, "focal_gamma": 2.0, "focal_alpha": 0.25,
            "head_dropout": PARAMS["dropout"], "lr_backbone": PARAMS["lr_backbone"],
            "lr": PARAMS["lr"], "weight_decay": PARAMS["weight_decay"],
            "max_grad_norm": PARAMS["max_grad_norm"]}


def _start():
    bp = _params(4)
    hp = mil_init(torch.Generator().manual_seed(5), maxvit.emb_dim(TINY), HIDDEN, ATTN, True)
    return bp, hp


def _names():
    """The program's leaves' order, by the reference's names."""
    names = maxvit.torchvision_names(TINY)
    return (mft.trainable_leaves(to_program({k: k for k in names}, TINY)),
            mft.trainable_leaves(weights.to_program_head({k: k for k in HEAD_NAMES})))


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-30))


def _ref_hyper():
    return mil_ft.hyper(dict(PARAMS, backbone="maxvit_test", pretrained=False))


def test_first_step_matches_the_reference():
    bp, hp = _start()
    batch, ref_batch = _inputs()
    names_b, names_h = _names()
    rbp, rhp = from_program(bp, TINY), weights.from_program_head(hp)
    g_b, g_h, loss, stats = mft.ft_grads(bp, hp, batch, 1.0, _program_hyper())
    r_loss, r_grads, r_stats = mil_ft_maxvit.loss_and_grads(rbp, rhp, ref_batch, _ref_hyper(),
                                                            _ref_arch(TINY))
    assert float(loss) == pytest.approx(float(r_loss), rel=1e-5)
    moved = from_program(stats, TINY)
    for k, v in r_stats.items():
        assert _rel(moved[k], v) < 1e-5, k
    raw = {k: float(torch.linalg.norm(v)) for k, v in r_grads.items()}
    floor = 1e-3 * float(np.median(list(raw.values())))
    assert len(names_b) == len(ref.param_shapes(_ref_arch(TINY)))
    # no gradient: the head's attn_w.b (a bias under a softmax), and each
    # MBConv's pre-norm shift (a constant a channel through the bias-free
    # 1x1 expansion, which the next BN's mean takes out)
    assert {k for k in raw if raw[k] < floor} == {"attn_w.b"} | {
        k for k in raw if k.endswith("pre_norm.bias")}
    for name, g in zip(names_b + names_h, g_b + g_h):
        if raw[name] >= floor:
            assert _rel(g, r_grads[name]) < 1e-4, name
        else:  # rounding on both sides
            assert float(torch.linalg.norm(g)) < floor, name


CANCELLED = 5e-3


def test_three_steps_match_the_reference():
    """Three steps: each leaf's change to 1e-3 of its own over the weights
    whose Adam input (the clipped gradient plus the decay, ``taken``) has
    a stable sign on both sides in every step, and within 2 lr a step
    everywhere. Adam moves a weight by about lr whatever its input's size,
    and here the decay term nearly cancels some gradients (stage 2's qkv
    weight: ``-7.3e-5 * clip + 1e-3 * p`` within 1e-5 of 0), so an input
    within the two sides' rounding may flip a move: in float64, where the
    reference's float32 rotation alone differs, that leaf's whole change
    reads 1.2e-3, in float32 3.2e-3, from two of its 768 weights. The
    weights left out must be such cancellations: in some step the
    reference's input is under ``CANCELLED`` of its two terms' size
    (|clip(g)| + |decay * p|; 1.9e-3 at most here, against about 0.1 for
    an input that a percent-sized fault of the program's gradient flips),
    so the filter cannot take a weight out for the size of the program's
    own error."""
    bp, hp = _start()
    hy = _program_hyper()
    names_b, names_h = _names()
    rbp, rhp = from_program(bp, TINY), weights.from_program_head(hp)
    opt = {"backbone": ft_optim.init_group(mft.trainable_leaves(bp)),
           "head": ft_optim.init_group(mft.trainable_leaves(hp))}
    b, h, batches, mus = bp, hp, [], []
    for k in range(3):
        batch, ref_batch = _inputs(3 + k)
        b, h, _ = mft.ft_step(b, h, opt, batch, 1.0, hy)
        batches.append(ref_batch)
        mus.append(dict(zip(names_b + names_h, [m.clone() for m in opt["backbone"]["mu"]
                                                + opt["head"]["mu"]])))
    steps = mil_ft_maxvit.train_steps(rbp, rhp, batches, _ref_hyper(), _ref_arch(TINY))
    beta1 = ft_optim.BETA1
    raw = {k: float(torch.linalg.norm(v)) for k, v in steps[0]["grads"].items()}
    floor = 1e-3 * float(np.median(list(raw.values())))
    after = {**from_program(b, TINY), **weights.from_program_head(h)}
    want = {**steps[-1]["backbone"], **steps[-1]["head"]}
    start = {**rbp, **rhp}
    before = [start] + [{**s["backbone"], **s["head"]} for s in steps[:-1]]
    decay = PARAMS["weight_decay"]
    compared = [k for k in want if raw.get(k, np.inf) >= floor]
    assert {k for k in compared if "running" in k} == set(ref.running_shapes(_ref_arch(TINY)))
    assert set(want) - set(compared) == {"attn_w.b"} | {
        k for k in want if k.endswith("pre_norm.bias")}
    held = total = 0
    for k in compared:
        got, ref_change = after[k] - start[k], want[k] - start[k]
        if k not in raw:  # a running statistic: no Adam
            assert _rel(got, ref_change) < 1e-3, k
            continue
        stable = torch.ones_like(got, dtype=torch.bool)
        cancelled = torch.zeros_like(got, dtype=torch.bool)
        prev = torch.zeros_like(got)
        for t, mu in enumerate(mus):
            taken = (mu[k] - beta1 * prev) / (1 - beta1)
            prev = mu[k]
            want_taken = steps[t]["taken"][k]
            stable &= want_taken.abs() > 2 * (taken - want_taken).abs()
            wd_term = decay * before[t][k]
            cancelled |= want_taken.abs() < CANCELLED * (
                (want_taken - wd_term).abs() + wd_term.abs())
        assert not (~stable & ~cancelled).any(), k
        assert (got - ref_change).abs().max() <= 2 * 3 * PARAMS["lr"], k
        assert _rel(got[stable], ref_change[stable]) < 1e-3, k
        held, total = held + int(stable.sum()), total + stable.numel()
    assert held > 0.999 * total


def test_tta_predict_matches_the_reference():
    bp, hp = _start()
    bags = [np.random.default_rng(i).random((L, HW, HW), dtype=np.float32) for i in range(6)]
    model = mft.MilAttentionFineTuneModel(dict(PARAMS), device="cpu",
                                          make_rng=draws.CallRngs(11))
    model.backbone_params, model.head_params = bp, hp
    got = model.predict_proba(bags)
    rng = draws.generator(11, 0)

    def aug(B_, L_, h, w):
        return {k: torch.as_tensor(v) for k, v in draws.aug(rng, B_, L_, h, w, PARAMS).items()}

    want = mil_ft_maxvit.predict(from_program(bp, TINY), weights.from_program_head(hp),
                                 [torch.as_tensor(b) for b in bags], aug, _ref_hyper(),
                                 _ref_arch(TINY), B, 2)
    assert got.shape == (6,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_train_and_predict_through_the_model(tmp_path):
    """``train`` and ``predict_proba``, the fine-tune CLI's entry points, on a
    MaxViT backbone: every weight trains, the running statistics move, and
    a saved model predicts the same after loading."""
    bags = [np.random.default_rng(i).random((L, HW, HW), dtype=np.float32) for i in range(8)]
    y = np.array([1, 0] * 4, np.float32)
    model = mft.MilAttentionFineTuneModel(dict(PARAMS), device="cpu",
                                          make_rng=draws.CallRngs(5))
    before = {k: v.clone() for k, v in from_program(model.backbone_params, TINY).items()}
    model.train(bags, y)
    after = from_program(model.backbone_params, TINY)
    assert set(after) == set(before) == set(maxvit.torchvision_names(TINY))
    unmoved = {k for k in after if torch.equal(after[k], before[k])}
    assert not unmoved, sorted(unmoved)  # weight decay moves the pre-norm shifts too
    p = model.predict_proba(bags[:5] + [None])
    assert np.isfinite(p).all() and p[-1] == np.float32(0.5)
    model.save(tmp_path / "m.pkl")
    loaded = mft.MilAttentionFineTuneModel.load(tmp_path / "m.pkl", device="cpu")
    loaded.make_rng, model.make_rng = draws.CallRngs(9), draws.CallRngs(9)
    np.testing.assert_array_equal(loaded.predict_proba(bags), model.predict_proba(bags))


def test_a_data_parallel_group_is_refused():
    x = torch.randn(2, SIZE, SIZE, 3)
    with pytest.raises(ValueError, match="data-parallel"):
        maxvit.maxvit_apply_train(_params(), x, TINY, group=object())


def _group_of(i, j, part, res, m):
    """Token (i, j)'s group: a window of contiguous tokens, or a grid group
    of tokens res / m apart."""
    return (i // m, j // m) if part == "window" else (i % (res // m), j % (res // m))


@pytest.mark.parametrize("token", [(0, 0), (3, 4), (5, 7)])
@pytest.mark.parametrize("part", ["window", "grid"])
def test_a_token_changes_its_own_group_alone(token, part):
    res, m, C, heads = 8, 2, 16, 2
    layer = params_to(_params(6)["stages"][1][0][part], dtype=torch.float64)
    partition = swin.WINDOWS if part == "window" else maxvit.GRID
    x = torch.randn(1, res, res, C, generator=torch.Generator().manual_seed(7),
                    dtype=torch.float64)
    y = x.clone()
    y[0, token[0], token[1]] += torch.randn(C, generator=torch.Generator().manual_seed(8),
                                            dtype=torch.float64)  # not constant: LN takes that out
    change = (swin._block(y, layer, heads, m, 0, None, partition)
              - swin._block(x, layer, heads, m, 0, None, partition)).abs().amax(-1)[0]
    mine = _group_of(*token, part, res, m)
    for i in range(res):
        for j in range(res):
            if (i, j) == token:
                assert change[i, j] > 0.1
            elif _group_of(i, j, part, res, m) != mine:
                assert change[i, j] == 0.0, (i, j)
            else:
                assert change[i, j] > 1e-6, (i, j)


def _dw_inputs(C, side, stride, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(3, C, side, side, generator=gen, dtype=torch.float64)
    w = torch.randn(C, 1, 3, 3, generator=gen, dtype=torch.float64)
    out = (side + 2 - 3) // stride + 1
    g = torch.randn(3, C, out, out, generator=gen, dtype=torch.float64)
    return x, w, g


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("C,side", [(4, 7), (12, 10), (32, 9)])
def test_depthwise_gradients_match_autograd(C, side, stride):
    x, w, g = _dw_inputs(C, side, stride, C + side)
    for layout in (torch.contiguous_format, torch.channels_last):
        xs = x.contiguous(memory_format=layout)
        got = torch.autograd.grad(maxvit.depthwise_conv(xs.requires_grad_(True),
                                                        w.requires_grad_(True), stride),
                                  [xs, w], g)
        want = torch.autograd.grad(F.conv2d(x.requires_grad_(True), w.requires_grad_(True),
                                            stride=stride, padding=1, groups=C), [x, w], g)
        for a, b in zip(got, want):
            assert a.shape == b.shape and _rel(a, b) < 1e-12


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_gradients_through_the_weighted_bn(stride):
    """The MBConv's depthwise convolution, then its weighted train-mode BN
    and GELU (one image at weight 0), against ``F.conv2d`` and the BN's
    formula over the weighted images in plain autograd."""
    x, w, _ = _dw_inputs(8, 9, stride, 5)
    sw = torch.tensor([1.0, 0.0, 1.0], dtype=torch.float64)
    p = {k: v.to(torch.float64) for k, v in maxvit._bn_init(8).items()}
    p["gamma"] = p["gamma"] + 0.3
    proj = torch.randn(3, 8, 5 if stride == 2 else 9, 5 if stride == 2 else 9,
                       generator=torch.Generator().manual_seed(6), dtype=torch.float64)

    def program(x, w):
        y, _ = weighted_bn.bn_train(maxvit.depthwise_conv(x, w, stride), p, 0.1, maxvit.BN_EPS,
                                    sw)
        return torch.sum(F.gelu(y) * proj)

    def plain(x, w):
        h = F.conv2d(x, w, stride=stride, padding=1, groups=8)
        n = sw.sum() * h.shape[2] * h.shape[3]
        mean = torch.sum(h * sw[:, None, None, None], (0, 2, 3)) / n
        var = torch.sum((h - mean[:, None, None]) ** 2 * sw[:, None, None, None], (0, 2, 3)) / n
        y = (h - mean[:, None, None]) * torch.rsqrt(var + maxvit.BN_EPS)[:, None, None]
        return torch.sum(F.gelu(y * p["gamma"][:, None, None] + p["beta"][:, None, None]) * proj)

    got = torch.autograd.grad(program(x.requires_grad_(True), w.requires_grad_(True)), [x, w])
    want = torch.autograd.grad(plain(x, w), [x, w])
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-10


def _step_state():
    bp, hp = _start()
    return bp, hp, {"backbone": ft_optim.init_group(mft.trainable_leaves(bp)),
                    "head": ft_optim.init_group(mft.trainable_leaves(hp))}


def test_the_recomputed_step_equals_the_kept_step_bit_for_bit(monkeypatch):
    batch, _ = _inputs()
    hy = _program_hyper()
    profiling.reset()
    with profiling.tracing():
        recomputed = mft.ft_grads(*_step_state()[:2], batch, 1.0, hy)
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    assert counters["backbone:recomputed"] == N_MBCONV
    n_bn = 1 + 3 * N_MBCONV
    # every BN forward, the MBConvs' again in the recompute, every BN backward
    assert counters["backbone:bn_plain"] == n_bn + 3 * N_MBCONV + n_bn
    monkeypatch.setattr(maxvit, "_recomputed", lambda fn, *args: fn(*args))
    kept = mft.ft_grads(*_step_state()[:2], batch, 1.0, hy)
    for a, b in zip(recomputed[0] + recomputed[1], kept[0] + kept[1]):
        assert torch.equal(a, b)
    assert torch.equal(recomputed[2], kept[2])
    # the running statistics moved once, by the first forward's statistics
    once = from_program(recomputed[3], TINY)
    assert all(torch.equal(once[k], v) for k, v in from_program(kept[3], TINY).items())
    start = from_program(_start()[0], TINY)
    assert all(not torch.equal(once[k], start[k]) for k in once if "running_mean" in k)


def test_a_maxvit_step_calls_no_atomic_op():
    bp, hp, opt = _step_state()
    batch, ref_batch = _inputs()
    ops = dc.aten_ops_called(lambda: mft.ft_step(bp, hp, opt, batch, 1.0, _program_hyper()))
    assert not ops & dc.ATOMIC_ATEN_OPS and {"mm", "bmm", "convolution"} <= ops
    assert "convolution_backward" not in ops
    gathered = dc.aten_ops_called(lambda: mil_ft_maxvit.loss_and_grads(
        from_program(bp, TINY), weights.from_program_head(hp), ref_batch, _ref_hyper(),
        _ref_arch(TINY)))
    assert "index_put(accumulate)" in gathered  # the indexed bias's backward


def test_flops_give_the_published_gmacs():
    f, stem = flops_maxvit.backbone_forward(PUBLISHED, 224)
    assert f / 2 == pytest.approx(5.6e9, rel=0.03)  # MaxViT-T, 5.6 GFLOPs (multiply-adds)
    assert stem == 2 * 3 * 64 * 9 * 112 * 112
    assert len(flops_maxvit.mbconvs(PUBLISHED, 224)) == 11
    assert flops_maxvit.train_step(PUBLISHED, 224, 4, 64, 256, 128) > 3 * 256 * f - 256 * f


def _torchvision_state_dict(seed=0):
    """A synthetic checkpoint in torchvision ``maxvit_t``'s layout: every
    parameter and running statistic under its name and shape, the buffers
    torchvision registers (relative position indices, BN step counts) and
    the classifier's linears."""
    gen = torch.Generator().manual_seed(seed)
    sd = {k: torch.randn(s, generator=gen) for k, s in
          {**ref.param_shapes(PUBLISHED), **ref.running_shapes(PUBLISHED)}.items()}
    for k in list(sd):
        if k.endswith("running_var"):
            sd[k] = sd[k].abs() + 0.5
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
        if k.endswith("relative_position_bias_table"):
            sd[k.replace("bias_table", "index")] = ref.relative_position_index(7)
    sd["classifier.3.weight"], sd["classifier.3.bias"] = torch.randn(512, 512), torch.randn(512)
    sd["classifier.5.weight"] = torch.randn(1000, 512)
    return sd


def test_load_backbone_reads_a_torchvision_checkpoint(tmp_path):
    sd = _torchvision_state_dict()
    path = tmp_path / "maxvit_t.pth"
    torch.save(sd, path)
    params, dim, pretrained = mft.load_backbone("maxvit_t", weights_path=path)
    assert dim == 512 and pretrained
    flat = from_program(params, "maxvit_t")
    assert all(torch.equal(flat[k], sd[k]) for k in flat)
    assert len(flat) == len([k for k in sd if "index" not in k and "num_batches" not in k
                             and not k.startswith(("classifier.3", "classifier.5"))])
    model = mft.MilAttentionFineTuneModel({"backbone": "maxvit_t", "pretrained": True,
                                           "weights_path": str(path)}, device="cpu")
    assert model.pretrained and model.emb_dim == 512
    assert torch.equal(model.backbone_params["stages"][2][4]["grid"]["attn"]["qkv"]["weight"],
                       sd["blocks.2.layers.4.layers.grid_attention.attn_layer.1.to_qkv.weight"])
    small = {k: v.numpy() for k, v in from_program(_params(), TINY).items()}
    np.savez(tmp_path / "tiny.npz", **small)
    tiny, dim, _ = maxvit.load_backbone(TINY, weights_path=tmp_path / "tiny.npz")
    assert dim == 64 and all(np.array_equal(from_program(tiny, TINY)[k].numpy(), v)
                             for k, v in small.items())
    with pytest.raises(ValueError):
        maxvit.convert_torchvision_state_dict(small, "maxvit_t")  # the stages are not MaxViT-T's


def test_the_backbone_table_dispatches_every_family():
    assert mft._family("maxvit_test") is mft._MAXVIT
    assert mft._family("maxvit_t") is mft._MAXVIT
    assert mft._family("swin_t") is mft._SWIN
    assert mft._family("resnet18") is mft._RESNET is mft._family("resnet50")


def test_cli_runs_a_maxvit_finetune_cv(tmp_path, monkeypatch):
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


def test_the_embed_reference_matches_the_programs_prep_and_build(tmp_path):
    """One small int16 volume: the reference's read, resize, percentile
    normalization and slice selection against the program's native prep,
    and its unfolded ResNet-18 embedding against the program's build."""
    from benchmark.drives.embed import write_nifti
    from benchmark.reference import embed
    from benchmark.reference import resnet as ref_resnet
    from pd_fusion_torch.imaging import pipeline

    ref_resnet.register("resnet18", {"block": "basic", "stage_blocks": [2, 2, 2, 2],
                                     "expansion": 1, "embedding_dim": 512,
                                     "stage_widths": [64, 128, 256, 512]})
    rng = np.random.default_rng(0)
    vol = rng.random((30, 34, 28), dtype=np.float32) * 0.3
    vol[4:26, 4:30, 4:24] += 0.5
    path = tmp_path / "sub-00_T1w.nii.gz"
    write_nifti(path, (vol * 1000).astype(np.int16), 6)
    target, count = (20, 20, 20), 6
    got = pipeline.make_slices_loader(target, [2], [count])(str(path))
    want = embed.prep(path, target, 2, count, "cpu")
    assert got.shape == tuple(want.shape) == (count, 20, 20)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=2e-5)

    gen = torch.Generator().manual_seed(1)
    bp = weights.backbone("resnet18", gen, "cpu")
    half = torch.full((3,), 0.5)
    bp = mil_ft.bn_stats_from_batch(bp, mil_ft.imagenet_batch(want, 32, half, half), "resnet18")
    emb = pipeline.run_resnet_embedding_pipeline(
        [str(path)], ["s0"], weights.to_program_backbone(bp, "resnet18"), [0.5] * 3, [0.5] * 3,
        arch="resnet18", target_shape=target, axes=[2], counts=[count], input_size=32, tta=1,
        progress=False, device="cpu")[0]
    ref_emb = embed.embed(bp, want, "resnet18", 32, half, half)
    assert _rel(torch.as_tensor(emb), ref_emb) < 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step's run-to-run bits exist only on a card")
    from pd_fusion_torch.utils.device import get_device

    return get_device("cuda")  # float32 products stay float32 (TF32 off)


def _full_step(cuda):
    """A full-width unfrozen MaxViT-T step's state and function: 4 bags of 64
    slices of 160^2 taken to 224^2, the fine-tune config's head and
    settings."""
    from pd_fusion_torch.models import ft_checks

    bp = params_to(maxvit.init_maxvit(torch.Generator().manual_seed(0)), device=cuda)
    hp = mil_init(torch.Generator().manual_seed(1), 512, ft_checks.HIDDEN, ft_checks.ATTN, True,
                  device=cuda)
    hy = dict(ft_checks.hyper(cuda), arch="maxvit_t")
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in
             ft_checks.step_inputs(4, 64, ft_checks.HW, seed=3, ragged=False).items()}

    def state():
        return (mft._clone(bp), mft._clone(hp),
                {"backbone": ft_optim.init_group(mft.trainable_leaves(bp)),
                 "head": ft_optim.init_group(mft.trainable_leaves(hp))})

    def step(st):
        b, h, loss = mft.ft_step(*st, batch, 1.0, hy)
        return {"backbone": b, "head": h, "loss": loss, "moments": st[2]}

    return state, step


@pytest.mark.cuda
def test_published_maxvit_t_on_the_card(cuda):
    p = maxvit.init_maxvit(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(2)
    flat = {k: v + (0.1 * torch.randn(v.shape, generator=gen) if "running_var" not in k
                    else torch.rand(v.shape, generator=gen))
            for k, v in from_program(p, "maxvit_t").items()}
    x = torch.rand(2, 224, 224, 3, generator=gen) * 4 - 2
    got = maxvit.maxvit_apply(params_to(to_program(flat, "maxvit_t"), device=cuda), x.to(cuda))
    want, _ = ref.forward({k: v.to(cuda) for k, v in flat.items()},
                          x.permute(0, 3, 1, 2).to(cuda), PUBLISHED, train=False)
    assert torch.linalg.norm(got - want) <= 1e-5 * torch.linalg.norm(want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_the_shortcut_pool_gradient_on_the_card(cuda, layout):
    """The strided shortcut's pool on the card against float64, at stage 1's
    shape: its gradient to 1e-6 (torch's CUDA backward of a channels-last
    pool put the step 4-5% off; ``maxvit._pool`` pools an NCHW copy)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 64, 112, 112, generator=gen)
    g = torch.randn(8, 64, 56, 56, generator=gen)
    fmt = getattr(torch, layout if layout == "channels_last" else "contiguous_format")
    xc = x.to(cuda).contiguous(memory_format=fmt).requires_grad_(True)
    got = torch.autograd.grad(maxvit._pool(xc), xc, g.to(cuda))[0].cpu().double()
    xd = x.double().requires_grad_(True)
    want = torch.autograd.grad(F.avg_pool2d(xd, 3, stride=2, padding=1), xd, g.double())[0]
    assert _rel(got, want) < 1e-6


@pytest.mark.cuda
def test_two_full_width_steps_are_equal_bit_for_bit(cuda):
    state, step = _full_step(cuda)
    twice = dc.run_twice(step, state)
    assert all(equal for equal, _ in twice.values()), {k: v for k, v in twice.items() if not v[0]}
    assert not dc.atomic_ops_called(lambda: step(state()))


@pytest.mark.cuda
def test_the_full_width_step_peaks_under_72_gb_and_counts_its_bn_calls(cuda):
    state, step = _full_step(cuda)
    st = state()
    step(state())  # warm-up: kernels built, allocator settled
    torch.cuda.synchronize(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    profiling.reset()
    with profiling.tracing():
        step(st)
        torch.cuda.synchronize(cuda)
    peak = torch.cuda.max_memory_allocated(cuda)
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    print(f"maxvit_t step peak {peak} B")
    assert peak < 72e9
    n = sum(maxvit.ARCHS["maxvit_t"].depths)
    assert counters["backbone:recomputed"] == n == 11
    assert counters["backbone:bn_kernel"] == (1 + 3 * n) + 3 * n + (1 + 3 * n) == 101
    assert "backbone:bn_plain" not in counters
