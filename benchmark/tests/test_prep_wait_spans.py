"""The readers of the training loop's wait for its next prepared step or
TTA pass (``metrics/prep_wait.*.py``, span ``trainer:prep_wait``): a share
of the window from a stub registry in a cell of its own rate, nothing in a
cell of the other rate, on a program without the span or without the
registry; and a traced run of each drive on the CPU that reads it beside
every other program metric its cell lists."""
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import runner, spec

TRAIN, INFER = "train_slices_per_s", "infer_slices_per_s"
STUB = {"spans": {"trainer:_aug_params": {"seconds": 2.0}, "step:ft_step": {"seconds": 5.0},
                  "trainer:prep_wait": {"seconds": 1.5}},
        "counters": {"trainer:steps": 4, "trainer:passes": 2, "trainer:prep_ready": 3}}
WANT = {"prep_wait.train": (TRAIN, 15.0), "prep_wait.infer": (INFER, 15.0)}
CELLS = {"ft_train.resnet18": "prep_wait.train", "ft_predict.resnet50": "prep_wait.infer"}


def _ctx(rate):
    return {"drive": SimpleNamespace(rate=rate), "window_s": 10.0,
            "device": torch.device("cuda"), "busy_s": 5.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_prep_wait_reader_reads_the_span(name, monkeypatch):
    from pd_fusion_torch.utils import profiling

    read = spec.reader(name)
    rate, want = WANT[name]
    other = INFER if rate == TRAIN else TRAIN
    monkeypatch.setattr(profiling, "snapshot", lambda: STUB)
    assert read(_ctx(rate)) == pytest.approx(want)
    assert read(_ctx(other)) is None
    without = {"spans": {k: v for k, v in STUB["spans"].items() if k != "trainer:prep_wait"},
               "counters": STUB["counters"]}
    monkeypatch.setattr(profiling, "snapshot", lambda: without)  # a program without the span
    assert read(_ctx(rate)) is None
    monkeypatch.delattr(profiling, "snapshot")  # a program without the registry
    assert read(_ctx(rate)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_prep_wait_is_listed_for_the_cells_of_its_rate(name):
    rate = WANT[name][0]
    m = next(m for m in spec.load_benchmark()["per_layer"] if m["name"] == name)
    cells = {w["name"]: spec.resolve(w["name"]) for w in spec.load_benchmark()["workloads"]}
    assert (m["source"], m["layer"], m["better"], m["unit"]) == ("program_span", "trainer", "lower", "%")
    assert m["moves"] == rate
    assert set(m["workloads"]) == {n for n, c in cells.items() if c.drive.rate == rate}


@pytest.mark.parametrize("cell_name", sorted(CELLS))
def test_traced_run_reads_prep_wait(tiny, cell_name):
    from pd_fusion_torch.utils import profiling

    profiling.reset()
    out = runner.run(tiny(cell_name), 2**31 + 13, 0.05, True, "cpu", log=lambda s: None)
    assert out["correct"], out["checks"]
    mine = {m["name"] for m in spec.load_benchmark()["per_layer"]
            if m["source"] in ("program_span", "program_counter")
            and cell_name in m.get("workloads", ())}
    other = set(CELLS.values()) - {CELLS[cell_name]}
    assert CELLS[cell_name] in mine and mine <= set(out["metrics"])
    assert 0 <= out["metrics"][CELLS[cell_name]]["value"] <= 100
    assert not other & set(out["metrics"])
    profiling.reset()
