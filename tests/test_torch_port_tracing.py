"""The port's spans and counters (``pd_fusion_torch/utils/profiling.py``)
and where the MIL fine-tune records them
(``pd_fusion_torch/models/mil_attention_finetune.py``).

- Off, a span or counter records nothing and reads no clock; inside
  ``tracing()`` nested spans give their counts, seconds, self seconds and
  parent, counters add, and ``reset()`` clears them; phases stay apart.
- Under ``torch.profiler`` tracing is on by itself: each ranged span of the
  fine-tune's calling thread is in the trace by its name (the draws' on
  the preparation thread may be), and every such name is one of the
  benchmark's own ranges (``benchmark/harness/trace.py::RANGES``), which
  its trace reduction leaves out of the device's busy time;
  ``trainer:readback`` and ``trainer:prep_wait`` have no range.
- A tiny ``train`` call and a TTA-2 ``predict_proba`` count their steps,
  passes, copies, read-backs and host-to-device bytes exactly, and give the
  same bits with tracing on as off.
- ``maybe_profile`` writes the block's spans beside its Chrome trace.
- On a card (``cuda`` marker): a traced two-step call puts no program span
  name outside ``RANGES`` on the device's timeline, and the reduction's
  busy time is the union of the kernels, copies and sets alone.

The module imports no JAX, so it runs on a GPU machine too:
``python -m pytest tests/test_torch_port_tracing.py -q``.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pd_fusion_torch.models import mil_attention_finetune as mft
from pd_fusion_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from benchmark.harness import trace  # noqa: E402

RANGED = {"trainer:_aug_params", "trainer:_t", "step:ft_step", "trainer:_predict_chunk"}
N_BAGS, L, HW, BS, HIDDEN, TTA = 8, 4, 32, 4, 16, 2
PARAMS = {"backbone": "resnet18", "pretrained": False, "target_shape": [HW, HW, HW],
          "slice_count": L, "input_size": 32, "batch_size": BS, "epochs": 1,
          "freeze_backbone_epochs": 0, "early_stopping_patience": 0, "hidden_dim": HIDDEN,
          "attn_dim": 8, "gated": True, "dropout": 0.2, "train_aug": True,
          "balanced_batches": True, "loss_type": "focal", "tta_inference": TTA}


@pytest.fixture(autouse=True)
def _registry():
    profiling.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    profiling.reset()


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read with tracing off")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    assert not profiling.tracing_on()
    with profiling.span("a:outer"):
        with profiling.span("a:inner", trace=False):
            profiling.count("a:n", 5)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_nested_spans_counters_and_reset(monkeypatch):
    ticks = iter([0, 10, 30, 40, 45, 100])  # ns: outer, inner x2, outer's end
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks) * 10**7)
    with profiling.tracing():
        assert profiling.tracing_on()
        with profiling.span("a:outer"):
            for _ in range(2):
                with profiling.span("a:inner", trace=False):
                    profiling.count("a:n", 3)
            profiling.count("a:n")
    assert not profiling.tracing_on()
    snap = profiling.snapshot()
    assert snap["counters"] == {"a:n": 7}
    outer, inner = snap["spans"]["a:outer"], snap["spans"]["a:inner"]
    assert (outer["count"], outer["parent"], inner["count"], inner["parent"]) == (
        1, None, 2, "a:outer")
    assert outer["seconds"] == pytest.approx(1.0) and inner["seconds"] == pytest.approx(0.25)
    assert outer["self_seconds"] == pytest.approx(1.0 - 0.25)
    assert inner["self_seconds"] == pytest.approx(0.25)
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_phases_are_timed_with_tracing_off_and_read_apart():
    with profiling.phase_timer("fit", log=False):
        with profiling.span("a:off"):
            pass
    assert set(profiling.get_phase_times()) == {"fit"}
    with profiling.tracing(), profiling.phase_timer("fit", log=False):
        with profiling.span("a:on"):
            pass
    snap = profiling.snapshot()["spans"]
    assert set(snap) == {"fit", "a:on"} and snap["fit"]["count"] == 2
    assert snap["a:on"]["parent"] == "fit" and set(profiling.get_phase_times()) == {"fit"}
    profiling.reset_phase_times()
    assert profiling.get_phase_times() == {} and set(profiling.snapshot()["spans"]) == {"a:on"}


def _bags(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random((L, HW, HW), dtype=np.float32) for _ in range(N_BAGS)]


def _model(device="cpu", like=None):
    model = mft.MilAttentionFineTuneModel(
        dict(PARAMS), device=device, make_rng=lambda: np.random.Generator(np.random.PCG64(7)))
    if like is not None:
        model.backbone_params = mft._map_tensors(like.backbone_params,
                                                 lambda t: t.detach().clone())
        model.head_params = mft._map_tensors(like.head_params, lambda t: t.detach().clone())
    return model


def _keeps():
    g = np.random.default_rng(3)
    return lambda B, L_, H: g.random((B, L_, H)) < 0.8


def _run(model, bags):
    y = (np.arange(N_BAGS) % 2).astype(np.float32)
    model.train(bags, y, dropout_keep_fn=_keeps())
    return model.predict_proba(bags)


def _leaves(model):
    return [t.detach().clone() for t in mft.trainable_leaves(model.backbone_params)
            + mft.trainable_leaves(model.head_params)]


def test_finetune_counts_exactly_and_gives_the_same_bits():
    bags = _bags()
    off = _model()
    on = _model(like=off)
    probs_off = _run(off, bags)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    with profiling.tracing():
        probs_on = _run(on, bags)
    np.testing.assert_array_equal(probs_on, probs_off)
    for a, b in zip(_leaves(on), _leaves(off)):
        assert torch.equal(a, b)

    steps, chunks = N_BAGS // BS, N_BAGS // BS
    passes = chunks * TTA
    snap = profiling.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    assert counters["trainer:steps"] == steps and counters["trainer:passes"] == passes
    # train: mean and std once, then 11 arrays a step (the keeps among them);
    # predict: the chunk and its mask, then 5 draws and mean and std a pass
    assert spans["trainer:_t"]["count"] == 2 + 11 * steps + 2 * chunks + 7 * passes
    assert spans["step:ft_step"]["count"] == steps
    assert spans["trainer:_aug_params"]["count"] == steps + passes
    assert spans["trainer:_predict_chunk"]["count"] == passes
    assert spans["trainer:readback"]["count"] == passes
    assert spans["trainer:_t"]["parent"] is None
    f32, slab = 4, BS * L * HW * HW
    per_step = (2 * slab + 2 * BS * L + 2 * BS + BS + 2 * BS + 2 * BS) * f32 + BS * L * HIDDEN
    per_pass = (slab + BS + 2 * BS + 2 * BS + 2 * 3) * f32
    want = 2 * 3 * f32 + steps * per_step + chunks * (slab + BS * L) * f32 + passes * per_pass
    assert counters["trainer:h2d_bytes"] == want
    for s in spans.values():
        assert 0.0 <= s["self_seconds"] <= s["seconds"]


def test_ranged_spans_are_in_the_profilers_trace_and_the_benchmarks_ranges():
    model = _model()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        assert profiling.tracing_on()
        _run(model, _bags())
    assert not profiling.tracing_on()
    recorded = set(profiling.snapshot()["spans"])
    assert RANGED | {"trainer:readback", "trainer:prep_wait"} <= recorded
    in_trace = {e.name() for e in prof.profiler.kineto_results.events()} & recorded
    # the draws run on the preparation thread, whose ranges the profiler
    # records where it traces every thread, and not where it traces its own
    assert RANGED - {"trainer:_aug_params"} <= in_trace <= RANGED
    assert in_trace <= trace.RANGES


def test_maybe_profile_writes_the_blocks_spans_beside_its_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("PD_FUSION_PROFILE", str(tmp_path))
    with profiling.tracing(), profiling.span("a:before"):
        pass
    for k in range(2):
        with profiling.maybe_profile("train"):
            with profiling.span("a:x"):
                profiling.count("a:n", 2)
    spans = sorted((tmp_path / "train").glob("spans_*.json"))
    traces = sorted((tmp_path / "train").glob("trace_*.json"))
    assert [p.name.replace("spans_", "") for p in spans] == [
        p.name.replace("trace_", "") for p in traces] and len(spans) == 2
    for p in spans:
        snap = json.loads(p.read_text())
        assert set(snap["spans"]) == {"a:x"} and snap["spans"]["a:x"]["count"] == 1
        assert snap["counters"] == {"a:n": 2}


def test_the_embed_build_records_its_prep_wait_and_staging(tmp_path):
    """The embed build's consume loop: one ``embed:prep_wait`` a subject and
    the end of the prefetch, one ``embed:staging`` a subject and a flush,
    neither in the profiler's trace; the same embeddings traced or not."""
    from benchmark.drives.embed import write_nifti
    from pd_fusion_torch.imaging import pipeline
    from pd_fusion_torch.nn.resnet import init_resnet

    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        vol = rng.random((18, 20, 16), dtype=np.float32) * 0.3
        vol[3:15, 3:17, 3:13] += 0.5
        paths.append(tmp_path / f"sub-{i}_T1w.nii.gz")
        write_nifti(paths[-1], (vol * 1000).astype(np.int16), 1)
    bp = init_resnet(torch.Generator().manual_seed(0), "resnet18")

    def build():
        return np.stack(pipeline.run_resnet_embedding_pipeline(
            [str(p) for p in paths], ["a", "b", "c"], bp, [0.5] * 3, [0.5] * 3,
            arch="resnet18", target_shape=(16, 16, 16), axes=[2], counts=[4], input_size=32,
            progress=False, device="cpu", subjects_per_call=2))

    plain = build()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = build()
    spans = profiling.snapshot()["spans"]
    assert spans["embed:prep_wait"]["count"] == 3 + 1
    assert spans["embed:staging"]["count"] == 3 + 2
    assert not {"embed:prep_wait", "embed:staging"} & {
        e.name() for e in prof.profiler.kineto_results.events()}
    np.testing.assert_array_equal(plain, traced)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device's timeline exists only on a card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_traced_finetune_puts_no_program_span_on_the_device_timeline(cuda):
    model = _model(cuda)
    bags = _bags()
    y = (np.arange(N_BAGS) % 2).astype(np.float32)
    model.train(bags, y, dropout_keep_fn=_keeps())  # warm-up
    torch.cuda.synchronize()
    profiling.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.autograd.profiler.record_function(trace.WINDOW):
            model.train(bags, y, dropout_keep_fn=_keeps())
            torch.cuda.synchronize()
    names = set(profiling.snapshot()["spans"])
    assert profiling.snapshot()["counters"]["trainer:steps"] == 2
    events = prof.profiler.kineto_results.events()
    on_device = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert {e.name() for e in on_device} & names <= trace.RANGES
    win = next(e for e in events if e.name() == trace.WINDOW
               and e.device_type() != torch.autograd.DeviceType.CUDA)
    w0, w1 = win.start_ns(), win.start_ns() + win.duration_ns()
    # the kernels, copies and sets: every device-side event that is not the
    # device's copy of a range (a program span's or the window's)
    work = [(max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1)) for e in on_device
            if e.name() not in names | {trace.WINDOW}
            and e.start_ns() + e.duration_ns() > w0 and e.start_ns() < w1]
    assert work
    busy = sum(e - s for s, e in trace._union(work)) / 1e9
    assert trace.reduce(prof)["busy_s"] == pytest.approx(busy, abs=1e-9)
