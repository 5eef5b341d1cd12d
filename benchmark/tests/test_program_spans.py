"""The readers of the program's own spans and counters
(``harness/program_spans.py``, ``metrics/host_*.py``, ``metrics/h2d_bytes.*.py``):
a number from a stub registry, nothing from an empty one, from a cell of the
other rate or from a program without the registry; and a traced run of each
drive on the CPU that reads every one of its cell's metrics."""
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import runner, spec

TRAIN, INFER = "train_slices_per_s", "infer_slices_per_s"
STUB = {"spans": {"trainer:_aug_params": {"seconds": 2.0}, "step:ft_step": {"seconds": 5.0},
                  "trainer:_t": {"seconds": 0.5}, "trainer:_predict_chunk": {"seconds": 3.0},
                  "trainer:readback": {"seconds": 1.0}},
        "counters": {"trainer:h2d_bytes": 8_000_000, "trainer:steps": 4, "trainer:passes": 2}}
WANT = {"host_draws.train": (TRAIN, 20.0), "host_dispatch.train": (TRAIN, 50.0),
        "host_copies.train": (TRAIN, 5.0), "h2d_bytes.train": (TRAIN, 2.0),
        "host_draws.infer": (INFER, 20.0), "host_dispatch.infer": (INFER, 30.0),
        "host_copies.infer": (INFER, 5.0), "host_readback.infer": (INFER, 10.0),
        "h2d_bytes.infer": (INFER, 4.0)}


def _ctx(rate):
    return {"drive": SimpleNamespace(rate=rate), "window_s": 10.0,
            "device": torch.device("cuda"), "busy_s": 5.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_the_registry(name, monkeypatch):
    from pd_fusion_torch.utils import profiling

    read = spec.reader(name)
    rate, want = WANT[name]
    other = INFER if rate == TRAIN else TRAIN
    monkeypatch.setattr(profiling, "snapshot", lambda: STUB)
    assert read(_ctx(rate)) == pytest.approx(want)
    assert read(_ctx(other)) is None
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": {}, "counters": {}})
    assert read(_ctx(rate)) is None
    monkeypatch.delattr(profiling, "snapshot")  # a program without the registry
    assert read(_ctx(rate)) is None


@pytest.mark.parametrize("name", ["ft_train.resnet18", "ft_predict.resnet50"])
def test_traced_run_reads_each_of_its_cells_program_metrics(tiny, name):
    from pd_fusion_torch.utils import profiling

    profiling.reset()
    cell = tiny(name)
    out = runner.run(cell, 2**31 + 11, 0.05, True, "cpu", log=lambda s: None)
    assert out["correct"], out["checks"]
    mine = {m["name"] for m in spec.load_benchmark()["per_layer"]
            if m["source"] in ("program_span", "program_counter") and name in m["workloads"]}
    assert len(mine) == (4 if cell.drive.rate == TRAIN else 5)
    assert mine <= set(out["metrics"])
    assert all(out["metrics"][m]["value"] >= 0 for m in mine)
    p = cell.config["params"]
    B, L, (h, w), H = p["batch_size"], p["slice_count"], p["target_shape"][:2], p["hidden_dim"]
    if cell.drive.rate == TRAIN:
        # two masks of [B, L]; y, valid, angle, scale, shift [B]; translate
        # [B, 2]; slices and noise [B, L, h, w], float32; bool keeps [B, L, H]
        step = 4 * (2 * B * L * h * w + 2 * B * L + 7 * B) + B * L * H
        want = step + 24 / (cell.mix["bags"] // B)  # and mean and std once a call
        assert out["metrics"]["h2d_bytes.train"]["value"] == pytest.approx(want / 1e6)
    profiling.reset()
