"""The two cells after the ResNet ones: ``ft_train_swin.swin_t`` (Swin-T, the
``train_swin`` drive) and ``ft_frozen.resnet50`` (gate 0, the
``train_frozen`` drive).

On the CPU at ``conftest.tiny_cell``'s sizes (the Swin cell on a small
Swin, the program's and the configuration's tables both: 32^2 inputs,
4x4 patches, windows of 2): each cell reads ``correct`` true, and false
with half of each batch left out or the state left unchanged, and the
frozen cell also with the backbone's weights moved; the ``train`` drive
on the frozen cell reads false (its reference steps the backbone). The
FLOP counts against ``FlopCounterMode`` on the reference; each new reader
on a stub registry, in a cell of the other rate, without its span or
counter, without a Swin table or without the program's Swin module; and a
traced run of the Swin cell that reads its program metrics."""
import json
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops_swin
from benchmark.harness import runner, spec
from benchmark.reference import mil_ft, swin
from pd_fusion_torch.models import mil_attention_finetune as mft

SEED = 2**31 + 21
SWIN, FROZEN = "ft_train_swin.swin_t", "ft_frozen.resnet50"
TRAIN, INFER = "train_slices_per_s", "infer_slices_per_s"
SMALL = {"embed_dim": 8, "stage_widths": [8, 16, 32, 64], "embedding_dim": 64,
         "num_heads": [1, 2, 2, 4], "window_size": 2, "stage_blocks": [2, 2, 2, 2]}
PUBLISHED = swin.arch_from(json.loads((spec.BENCH_DIR / "configs" / "mil_ft_swin_t.json")
                                      .read_text())["architecture"])


@pytest.fixture
def small_swin(tiny, monkeypatch):
    """The Swin cell at the tiny size, on a small Swin in the program and
    in the configuration alike."""
    from pd_fusion_torch.nn import swin as program

    a = SMALL
    monkeypatch.setitem(program.ARCHS, "swin_t", program.SwinArch(
        4, a["embed_dim"], tuple(a["stage_blocks"]), tuple(a["num_heads"]), a["window_size"], 4))
    cell = tiny(SWIN, "swin_t")
    return cell._replace(config=dict(cell.config, architecture={
        **cell.config["architecture"], **SMALL}))


def _run(cell, seed=SEED, traced=False):
    return runner.run(cell, seed, 0.05, traced, "cpu", log=lambda s: None)


def test_sound_runs_are_correct(small_swin, tiny):
    for cell in (small_swin, tiny(FROZEN)):
        out = _run(cell)
        assert out["correct"], (cell.name, out["checks"])
        assert out["attempted"] > 0 and out["failed"] == 0
        assert set(out["metrics"]) == {TRAIN, "setup_s"}


def test_the_train_drive_cannot_check_frozen_steps(tiny):
    """The ``train`` drive's reference steps the backbone at
    ``lr_backbone`` while the program's gate holds it."""
    cell = tiny(FROZEN)
    cell = cell._replace(drive=spec._load(spec.BENCH_DIR / "drives" / "train.py").DRIVE)
    out = _run(cell)
    assert not out["correct"]
    assert out["checks"]["grad_gap"]["value"] > 1 and out["checks"]["change_gap"]["value"] > 0.5


@pytest.mark.parametrize("cell_name", [SWIN, FROZEN])
def test_state_unchanged(cell_name, small_swin, tiny, monkeypatch):
    step = mft.ft_step

    def unchanged(backbone, head, opt_state, batch, *args, **kwargs):
        return backbone, head, step(backbone, head, opt_state, batch, *args, **kwargs)[2]

    monkeypatch.setattr(mft, "ft_step", unchanged)
    out = _run(small_swin if cell_name == SWIN else tiny(FROZEN))
    assert not out["correct"] and out["checks"]["change_gap"]["value"] > 0.5, out["checks"]


@pytest.mark.parametrize("cell_name", [SWIN, FROZEN])
def test_half_batch_left_out(cell_name, small_swin, tiny, monkeypatch):
    loss = mft.ft_loss

    def half(logits, y, valid, *args, **kwargs):
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = 0.0
        return loss(logits, y, valid, *args, **kwargs)

    monkeypatch.setattr(mft, "ft_loss", half)
    out = _run(small_swin if cell_name == SWIN else tiny(FROZEN))
    assert not out["correct"], out["checks"]


def test_frozen_backbone_moved(tiny, monkeypatch):
    """A gate that lets the backbone move: its weights are compared too."""
    step = mft.ft_step

    def leaky(backbone, head, opt_state, batch, gate, *args, **kwargs):
        return step(backbone, head, opt_state, batch, 1.0, *args, **kwargs)

    monkeypatch.setattr(mft, "ft_step", leaky)
    out = _run(tiny(FROZEN))
    change = out["checks"]["change_gap"]
    assert not out["correct"] and change["value"] > change["limit"], out["checks"]


def _count(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops(), counter.get_flop_counts()["Global"]


def _nets(a, size, H=256, A=128):
    bp = {k: torch.randn(s) * 0.02 for k, s in swin.param_shapes(a, size).items()}
    hp = {f"{n}.{k}": torch.randn(*(s if k == "w" else s[1:])) * 0.1
          for n, s in {"instance": (swin.emb_dim(a), H), "attn_v": (H, A), "attn_u": (H, A),
                       "attn_w": (A, 1), "classifier": (H, 1)}.items() for k in ("w", "b")}
    return bp, hp


@pytest.mark.parametrize("arch", ["small", "published"])
def test_flops_match_the_counter(arch):
    a = PUBLISHED if arch == "published" else PUBLISHED._replace(
        embed_dim=8, heads=(1, 2, 2, 4), window=2)
    size, B, L, H, A = (224, 1, 2, 256, 128) if arch == "published" else (32, 2, 3, 16, 8)
    bp, hp = _nets(a, size, H, A)
    x = torch.randn(B * L, 3, size, size)
    f, embed = flops_swin.backbone_forward(a, size)
    assert _count(lambda: swin.forward(bp, x, a))[0] == B * L * f
    assert embed == 2 * 48 * a.embed_dim * (size // 4) ** 2
    leaves = [t.requires_grad_(True) for t in list(bp.values()) + list(hp.values())]

    def step():
        emb = swin.forward(bp, x, a)
        logits = mil_ft.head_forward(hp, emb.reshape(B, L, -1), torch.ones(B, L))
        loss = mil_ft.focal_loss(logits, torch.ones(B), torch.ones(B), 2.0, 0.25)
        torch.autograd.grad(loss, leaves)

    total, by_op = _count(step)
    assert total == flops_swin.train_step(a, size, B, L, H, A)
    # the batched products are the windows' attention alone, forward and backward
    assert by_op[torch.ops.aten.bmm] == sum(w for w, _ in flops_swin.window_attention(a, size,
                                                                                      B * L))
    for t in leaves:
        t.requires_grad_(False)
    assert _count(lambda: mil_ft.head_forward(hp, swin.forward(bp, x, a).reshape(B, L, -1),
                                              torch.ones(B, L)))[0] == \
        flops_swin.predict_pass(a, size, B, L, H, A)


def test_published_totals():
    """The numbers the Swin cell's metrics read, at its shapes."""
    f, embed = flops_swin.backbone_forward(PUBLISHED, 224)
    assert f == 8_979_597_312 and embed == 28_901_376  # 4.5 GMAC an image (Table 1)
    assert flops_swin.backbone_train(PUBLISHED, 224, 256) == 6_888_931_983_360
    windows = sum(d * (res // w) ** 2 for (res, _, w, _), d in
                  zip(swin.stages(PUBLISHED, 224), PUBLISHED.depths))
    assert 256 * windows == 47_616
    assert len(flops_swin.window_attention(PUBLISHED, 224, 256)) == 12


STUB = {"spans": {"backbone:window_attention": {"seconds": 2.5}},
        "counters": {"backbone:windows": 95_232, "trainer:steps": 2}}
WANT = {"window_attn_dispatch.train": 25.0, "windows.train": 47.616}


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


@pytest.mark.parametrize("name", ["swin_roofline.train", "window_attn_roofline.train"])
def test_roofline_readers_read_nothing_elsewhere(name, monkeypatch):
    read = spec.reader(name)
    assert read(_ctx(INFER, sw=PUBLISHED)) is None
    assert read(_ctx(TRAIN)) is None  # a ResNet cell's drive has no Swin table
    assert read(dict(_ctx(TRAIN, sw=PUBLISHED), device=torch.device("cpu"))) is None
    monkeypatch.setitem(sys.modules, "pd_fusion_torch.nn.swin", None)  # a program without it
    assert read(_ctx(TRAIN, sw=PUBLISHED)) is None


def test_entries_list_the_cells_that_report_them():
    bench = spec.load_benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in ("swin_roofline.train", "window_attn_roofline.train",
                 "window_attn_dispatch.train", "windows.train"):
        assert per_layer[name]["workloads"] == [SWIN] and per_layer[name]["moves"] == TRAIN
    for name in ("mfu.train", "device_idle.train", "host_draws.train", "host_dispatch.train",
                 "host_copies.train", "h2d_bytes.train", "prep_wait.train"):
        assert {SWIN, FROZEN} <= set(per_layer[name]["workloads"])
    assert SWIN not in per_layer["backbone_roofline.train"]["workloads"]
    cfg = next(c for c in bench["configs"] if c["name"] == "mil_ft_swin_t")
    assert cfg["reduced"] == []
    src = json.loads((spec.BENCH_DIR / "configs" / "mil_ft_resnet50.json").read_text())
    mine = json.loads((spec.ROOT / cfg["file"]).read_text())
    assert {k for k in src["params"] if src["params"][k] != mine["params"][k]} == {"backbone"}
    assert set(src["params"]) == set(mine["params"])


def test_traced_swin_run_reads_its_program_metrics(small_swin):
    from pd_fusion_torch.utils import profiling

    profiling.reset()
    out = _run(small_swin, SEED + 1, traced=True)
    assert out["correct"], out["checks"]
    # 4 bags x 4 slices a step; windows of the 8, 4, 2 and 1 maps: 16, 4, 1, 1, two blocks each
    assert out["metrics"]["windows.train"]["value"] == pytest.approx(16 * 2 * (16 + 4 + 1 + 1)
                                                                     / 1e3)
    assert 0 < out["metrics"]["window_attn_dispatch.train"]["value"] <= 100
    assert {"host_dispatch.train", "prep_wait.train", "h2d_bytes.train"} <= set(out["metrics"])
    assert not {"swin_roofline.train", "window_attn_roofline.train"} & set(out["metrics"])  # CPU
    profiling.reset()
