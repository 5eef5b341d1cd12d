"""The two cells after the Swin and frozen ones: ``ft_train_maxvit.maxvit_t``
(MaxViT-T, the ``train_maxvit`` drive) and ``embed_build.resnet18`` (the
slice-embedding build, the ``embed`` drive).

On the CPU at a tiny size (the MaxViT cell on a small MaxViT in the program
and in the configuration alike: 64^2 inputs, groups of 2 x 2; the embed
cell on 2 small volumes cycled to 4 paths): each cell reads ``correct``
true, and false with a fault planted (the MaxViT cell: half of each batch
left out, the state left unchanged, the running statistics left unmoved;
the embed cell: half of each volume's slices pooled, a volume's
embedding moved). The FLOP counts against ``FlopCounterMode`` on the
reference; each new reader on a stub registry, in a cell of the other
rate, without its span or counter, without a MaxViT table or without the
program's MaxViT module; the entries of ``BENCHMARK.json``; and a traced
run of the MaxViT cell that reads its program metrics."""
import json
import math
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops_maxvit
from benchmark.harness import runner, spec
from benchmark.reference import maxvit, mil_ft
from pd_fusion_torch.models import mil_attention_finetune as mft

SEED = 2**31 + 22
MAXVIT, EMBED = "ft_train_maxvit.maxvit_t", "embed_build.resnet18"
TRAIN, INFER = "train_slices_per_s", "infer_slices_per_s"
SMALL = {"stem_width": 8, "stage_widths": [8, 16, 32, 64], "embedding_dim": 64,
         "stage_blocks": [2, 1, 1, 1], "head_dim": 8, "partition_size": 2}
PUBLISHED = maxvit.arch_from(json.loads((spec.BENCH_DIR / "configs" / "mil_ft_maxvit_t.json")
                                        .read_text())["architecture"])


@pytest.fixture
def small_maxvit(tiny, monkeypatch):
    """The MaxViT cell at a tiny size, on a small MaxViT in the program and
    in the configuration alike."""
    from pd_fusion_torch.nn import maxvit as program

    a = SMALL
    monkeypatch.setitem(program.ARCHS, "maxvit_t", program.MaxVitArch(
        a["stem_width"], tuple(a["stage_widths"]), tuple(a["stage_blocks"]), a["head_dim"],
        a["partition_size"]))
    cell = tiny(MAXVIT, "maxvit_t", input_size=64)
    return cell._replace(config=dict(cell.config, architecture={
        **cell.config["architecture"], **SMALL}))


@pytest.fixture
def small_embed():
    cell = spec.resolve(EMBED)
    config = json.loads(json.dumps(cell.config))
    config["params"].update(target_shape=[16, 16, 16], input_size=32)
    mix = dict(cell.mix, bags=4, volumes=2, volume_shape=[24, 28, 22], foreground=[[3, 20], [3, 24], [3, 18]],
               gzip_level=1, params=dict(cell.mix["params"], slice_count=4))
    config["params"].update(mix["params"])
    return cell._replace(config=config, mix=mix)


def _run(cell, seed=SEED, traced=False):
    return runner.run(cell, seed, 0.05, traced, "cpu", log=lambda s: None)


def test_sound_runs_are_correct(small_maxvit, small_embed):
    out = _run(small_maxvit)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {TRAIN, "setup_s"}
    out = _run(small_embed)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {INFER, "setup_s"}
    assert out["attempted"] % 4 == 0


def test_state_unchanged(small_maxvit, monkeypatch):
    step = mft.ft_step

    def unchanged(backbone, head, opt_state, batch, *args, **kwargs):
        return backbone, head, step(backbone, head, opt_state, batch, *args, **kwargs)[2]

    monkeypatch.setattr(mft, "ft_step", unchanged)
    out = _run(small_maxvit)
    assert not out["correct"] and out["checks"]["change_gap"]["value"] > 0.5, out["checks"]


def test_running_statistics_left_unmoved(small_maxvit, monkeypatch):
    monkeypatch.setattr(mft, "merge_bn_stats", lambda trained, stats: trained)
    out = _run(small_maxvit)
    assert not out["correct"] and out["checks"]["change_gap"]["value"] > 0.5, out["checks"]


def test_half_batch_left_out(small_maxvit, monkeypatch):
    loss = mft.ft_loss

    def half(logits, y, valid, *args, **kwargs):
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = 0.0
        return loss(logits, y, valid, *args, **kwargs)

    monkeypatch.setattr(mft, "ft_loss", half)
    out = _run(small_maxvit)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["half_slices", "moved"])
def test_embed_faults(fault, small_embed, monkeypatch):
    from pd_fusion_torch.imaging import pipeline

    build = pipeline.run_resnet_embedding_pipeline

    def faulty(*args, **kwargs):
        if fault == "half_slices":
            kwargs["counts"] = [kwargs["counts"][0] // 2]
        out = build(*args, **kwargs)
        if fault == "moved":
            out[1] = out[1] * 1.01
        return out

    monkeypatch.setattr(pipeline, "run_resnet_embedding_pipeline", faulty)
    out = _run(small_embed)
    assert not out["correct"], out["checks"]


def test_a_program_without_maxvit_fails_at_once(small_maxvit, monkeypatch):
    monkeypatch.setitem(sys.modules, "pd_fusion_torch.nn.maxvit", None)
    with pytest.raises(ImportError):
        small_maxvit.drive(small_maxvit, SEED, "cpu")


def _conv_backward(grad_out, x, w, _bias, _stride, _padding, _dilation, _transposed,
                   _output_padding, _groups, output_mask, out_shape=None):
    """A convolution's gradients, each the forward's FLOPs: torch's counter
    counts a grouped (depthwise) convolution's backward as an ungrouped
    one's."""
    return 2 * math.prod(grad_out) * math.prod(w[1:]) * (int(output_mask[0]) + int(output_mask[1]))


def _count(fn):
    with FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten.convolution_backward: _conv_backward}) as counter:
        fn()
    return counter.get_total_flops()


def test_flops_match_the_counter():
    a = PUBLISHED._replace(stem=8, widths=(8, 16, 32, 64), depths=(2, 1, 1, 2), head_dim=8,
                           partition=2)
    size, B, L, H, A = 64, 2, 2, 16, 8
    gen = torch.Generator().manual_seed(0)
    bp = {k: torch.randn(s, generator=gen) * 0.1 for k, s in maxvit.param_shapes(a, size).items()}
    bp.update({k: torch.ones(s) for k, s in maxvit.running_shapes(a, size).items()})
    hp = {f"{n}.{k}": torch.randn(*(s if k == "w" else s[1:]), generator=gen) * 0.1
          for n, s in {"instance": (64, H), "attn_v": (H, A), "attn_u": (H, A),
                       "attn_w": (A, 1), "classifier": (H, 1)}.items() for k in ("w", "b")}
    x = torch.randn(B * L, 3, size, size, generator=gen)
    f, stem = flops_maxvit.backbone_forward(a, size)
    assert _count(lambda: maxvit.forward(bp, x, a, train=False)) == B * L * f
    leaves = [t.requires_grad_(True) for k, t in list(bp.items()) + list(hp.items())
              if "running" not in k]

    def step():
        emb, _ = maxvit.forward(bp, x, a, train=True)
        logits = mil_ft.head_forward(hp, emb.reshape(B, L, -1), torch.ones(B, L))
        loss = mil_ft.focal_loss(logits, torch.ones(B), torch.ones(B), 2.0, 0.25)
        torch.autograd.grad(loss, leaves)

    assert _count(step) == flops_maxvit.train_step(a, size, B, L, H, A)
    assert stem == 2 * 3 * 8 * 9 * 32 * 32


def test_published_totals():
    """The numbers the MaxViT cell's metrics read, at its shapes."""
    f, stem = flops_maxvit.backbone_forward(PUBLISHED, 224)
    assert f / 2 == pytest.approx(5.6e9, rel=0.03)
    assert flops_maxvit.train_step(PUBLISHED, 224, 4, 64, 256, 128) == \
        256 * (3 * f - stem) + 3 * 4 * (64 * 2 * (512 * 256 + 2 * 256 * 128 + 128) + 2 * 256)
    dw = flops_maxvit.depthwise(PUBLISHED, 224, 256)
    assert len(dw) == 11 and dw[0][0] == 3 * 2 * 9 * 256 * 56 * 56 * 256
    assert dw[0][1] == 4 * 2 * (256 * 256 * 112 * 112 + 256 * 256 * 56 * 56 + 9 * 256)
    att = flops_maxvit.attention(PUBLISHED, 224, 256)
    assert len(att) == 2 * 11 and att[0] == att[3] != att[4]  # block and grid alike a stage
    assert att[0][0] == 3 * 4 * 56 * 56 * 49 * 64 * 256
    assert att[0][1] == 4 * (8 * 56 * 56 * 64 * 256 + 2 * 13 * 13 * 2)
    assert att[-1][0] == 3 * 4 * 7 * 7 * 49 * 512 * 256


STUB = {"spans": {"backbone:mbconv": {"seconds": 2.5}, "backbone:grid_attention": {"seconds": 1.0}},
        "counters": {"backbone:recomputed": 22, "trainer:steps": 2}}
WANT = {"mbconv_dispatch.train": 25.0, "grid_attn_dispatch.train": 10.0, "recomputed.train": 11.0}


def _ctx(rate, **drive):
    return {"drive": SimpleNamespace(rate=rate, **drive), "window_s": 10.0,
            "device": torch.device("cuda"), "busy_s": 5.0, "peak": {"float32_flops": 67e12}}


@pytest.mark.parametrize("name", sorted(WANT))
def test_program_readers(name, monkeypatch):
    from pd_fusion_torch.utils import profiling

    read = spec.reader(name)
    monkeypatch.setattr(profiling, "snapshot", lambda: STUB)
    assert read(_ctx(TRAIN)) == pytest.approx(WANT[name])
    assert read(_ctx(INFER)) is None
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": {}, "counters": {
        "trainer:steps": 2}})  # a program without the span or counter (a ResNet)
    assert read(_ctx(TRAIN)) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert read(_ctx(TRAIN)) is None


EMBED_STUB = {"spans": {"embed:prep_wait": {"seconds": 4.0}, "embed:staging": {"seconds": 0.5}},
              "counters": {}}
EMBED_WANT = {"embed_prep_wait.infer": 40.0, "embed_staging.infer": 5.0}


@pytest.mark.parametrize("name", sorted(EMBED_WANT))
def test_embed_readers(name, monkeypatch):
    from pd_fusion_torch.utils import profiling

    read = spec.reader(name)
    monkeypatch.setattr(profiling, "snapshot", lambda: EMBED_STUB)
    assert read(_ctx(INFER)) == pytest.approx(EMBED_WANT[name])
    assert read(_ctx(TRAIN)) is None
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": {}, "counters": {}})
    assert read(_ctx(INFER)) is None  # a predict cell: no build
    monkeypatch.delattr(profiling, "snapshot")
    assert read(_ctx(INFER)) is None


@pytest.mark.parametrize("name", ["maxvit_roofline.train", "dwconv_roofline.train",
                                  "maxvit_attn_roofline.train"])
def test_roofline_readers_read_nothing_elsewhere(name, monkeypatch):
    read = spec.reader(name)
    assert read(_ctx(INFER, mv=PUBLISHED)) is None
    assert read(_ctx(TRAIN)) is None  # a ResNet or Swin cell's drive has no MaxViT table
    assert read(dict(_ctx(TRAIN, mv=PUBLISHED), device=torch.device("cpu"))) is None
    monkeypatch.setitem(sys.modules, "pd_fusion_torch.nn.maxvit", None)  # a program without it
    assert read(_ctx(TRAIN, mv=PUBLISHED)) is None


def test_entries_list_the_cells_that_report_them():
    bench = spec.load_benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for name in ("maxvit_roofline.train", "dwconv_roofline.train", "mbconv_dispatch.train",
                 "grid_attn_dispatch.train", "recomputed.train", "maxvit_attn_roofline.train"):
        assert per_layer[name]["workloads"] == [MAXVIT] and per_layer[name]["moves"] == TRAIN
    for name in EMBED_WANT:
        assert per_layer[name]["workloads"] == [EMBED] and per_layer[name]["moves"] == INFER
    for name in ("mfu.train", "device_idle.train", "host_draws.train", "host_dispatch.train",
                 "host_copies.train", "h2d_bytes.train", "prep_wait.train",
                 "window_attn_dispatch.train", "windows.train", "bn_kernel.train"):
        assert per_layer[name]["workloads"][-1] == MAXVIT
    for name in ("mfu.infer", "device_idle.infer"):
        assert per_layer[name]["workloads"][-1] == EMBED
    assert e2e[TRAIN]["workloads"][-1] == MAXVIT and e2e[INFER]["workloads"][-1] == EMBED
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[MAXVIT]["chips"] == cells[EMBED]["chips"] == 1
    assert cells[EMBED]["config"] == "mil_ft_resnet18"
    cfg = next(c for c in bench["configs"] if c["name"] == "mil_ft_maxvit_t")
    assert cfg["reduced"] == []
    src = json.loads((spec.BENCH_DIR / "configs" / "mil_ft_swin_t.json").read_text())
    mine = json.loads((spec.ROOT / cfg["file"]).read_text())
    assert {k for k in src["params"] if src["params"][k] != mine["params"][k]} == {"backbone"}
    assert set(src["params"]) == set(mine["params"])
    assert mine["architecture"]["backbone_params"] == sum(
        int(np.prod(s)) for s in maxvit.param_shapes(PUBLISHED).values()) == 30_144_968


def test_traced_maxvit_run_reads_its_program_metrics(small_maxvit):
    from pd_fusion_torch.utils import profiling

    profiling.reset()
    out = _run(small_maxvit, SEED + 1, traced=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["recomputed.train"]["value"] == 5  # one a MBConv
    # 4 bags x 4 slices a step; 2 x 2 groups of the 16, 8, 4 and 2 maps: 64, 16, 4, 1
    # for each kind, blocks (2, 1, 1, 1)
    groups = 16 * (2 * 64 + 16 + 4 + 1)
    assert out["metrics"]["windows.train"]["value"] == pytest.approx(groups / 1e3)
    assert profiling.snapshot()["counters"]["backbone:grid_windows"] == \
        profiling.snapshot()["counters"]["backbone:windows"]
    for name in ("mbconv_dispatch.train", "grid_attn_dispatch.train",
                 "window_attn_dispatch.train"):
        assert 0 < out["metrics"][name]["value"] <= 100
    assert out["metrics"]["bn_kernel.train"]["value"] == (1 + 3 * 5) + 3 * 5 + (1 + 3 * 5)
    assert not {"maxvit_roofline.train", "dwconv_roofline.train",
                "maxvit_attn_roofline.train"} & set(out["metrics"])  # CPU
    profiling.reset()


def test_traced_embed_run_reads_its_program_metrics(small_embed):
    from pd_fusion_torch.utils import profiling

    profiling.reset()
    out = _run(small_embed, SEED + 2, traced=True)
    assert out["correct"], out["checks"]
    for name in EMBED_WANT:
        assert 0 < out["metrics"][name]["value"] <= 100
    profiling.reset()
