"""``metrics/bn_kernel.train.py``: the fused BN's calls a training step from
the program's counters (the kernels' on the card, the plain version's on
the CPU, never the one for the other device), nothing in a cell of the
other rate or from a program without the counter; its entry in
``BENCHMARK.json``."""
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import spec

NAME = "bn_kernel.train"
TRAIN, INFER = "train_slices_per_s", "infer_slices_per_s"
RESNET_TRAIN = ["ft_train.resnet50", "ft_train.resnet18", "ft_frozen.resnet50"]


def _ctx(rate, device="cuda"):
    return {"drive": SimpleNamespace(rate=rate), "window_s": 10.0,
            "device": torch.device(device), "busy_s": 5.0}


def test_reads_calls_a_step(monkeypatch):
    from pd_fusion_torch.utils import profiling

    read = spec.reader(NAME)
    monkeypatch.setattr(profiling, "snapshot", lambda: {
        "spans": {}, "counters": {"backbone:bn_kernel": 3 * 158, "trainer:steps": 3}})
    assert read(_ctx(TRAIN)) == pytest.approx(158.0)
    assert read(_ctx(INFER)) is None


def test_a_cpu_run_reads_the_plain_versions_calls(monkeypatch):
    from pd_fusion_torch.utils import profiling

    monkeypatch.setattr(profiling, "snapshot", lambda: {
        "spans": {}, "counters": {"backbone:bn_plain": 2 * 59, "trainer:steps": 2}})
    assert spec.reader(NAME)(_ctx(TRAIN, "cpu")) == pytest.approx(59.0)


def test_a_card_run_counts_only_the_kernels_calls(monkeypatch):
    """On the card the plain version's calls are not the kernels': a run
    whose BN took them reads nothing there, and a CPU run does not read the
    kernels' counter."""
    from pd_fusion_torch.utils import profiling

    read = spec.reader(NAME)
    monkeypatch.setattr(profiling, "snapshot", lambda: {
        "spans": {}, "counters": {"backbone:bn_plain": 2 * 59, "trainer:steps": 2}})
    assert read(_ctx(TRAIN)) is None
    monkeypatch.setattr(profiling, "snapshot", lambda: {
        "spans": {}, "counters": {"backbone:bn_kernel": 2 * 53, "trainer:steps": 2}})
    assert read(_ctx(TRAIN, "cpu")) is None


@pytest.mark.parametrize("counters", [
    {"trainer:steps": 3},  # the torch-op BN, or a Swin backbone
    {"backbone:bn_kernel": 9},  # no step counted
], ids=["no-counter", "no-steps"])
def test_reads_nothing_without_the_counter(counters, monkeypatch):
    from pd_fusion_torch.utils import profiling

    read = spec.reader(NAME)
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": {}, "counters": counters})
    assert read(_ctx(TRAIN)) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert read(_ctx(TRAIN)) is None


def test_entry_lists_the_resnet_training_cells():
    bench = spec.load_benchmark()
    entry = next(m for m in bench["per_layer"] if m["name"] == NAME)
    assert entry == {"name": NAME, "unit": "calls/step", "better": "lower",
                     "source": "program_counter", "layer": "backbone", "moves": TRAIN,
                     "workloads": RESNET_TRAIN}
    assert bench["per_layer"][-1] is entry
    cells = {w["name"] for w in bench["workloads"]}
    assert set(RESNET_TRAIN) <= cells
