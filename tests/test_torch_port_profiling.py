"""The port's tracing (``pd_fusion_torch/utils/profiling.py``): a
``torch.profiler`` trace under ``$PD_FUSION_PROFILE/<name>/`` when the
variable is set and nothing when it is not, as the JAX package's
``maybe_profile`` writes ``jax.profiler`` traces; the phase-time registry.
The spans and counters inside the fine-tune: ``test_torch_port_tracing.py``."""
import json

import pytest
import torch

from pd_fusion_torch.utils import profiling


def test_maybe_profile_writes_a_trace_under_the_named_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("PD_FUSION_PROFILE", str(tmp_path))
    with profiling.maybe_profile("train"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list((tmp_path / "train").glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)
    with profiling.maybe_profile("train"):  # a second block: a second file
        torch.zeros(4).sum()
    assert len(list((tmp_path / "train").glob("trace_*.json"))) == 2


def test_maybe_profile_does_nothing_when_unset(tmp_path, monkeypatch):
    monkeypatch.delenv("PD_FUSION_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.maybe_profile("train"):
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


def test_phase_timer_registry_and_throughput():
    profiling.reset_phase_times()
    with profiling.phase_timer("a", log=False):
        pass
    with profiling.phase_timer("a"):
        pass
    with profiling.phase_timer("b", log=False):
        pass
    times = profiling.get_phase_times()
    assert set(times) == {"a", "b"} and all(t >= 0.0 for t in times.values())
    profiling.reset_phase_times()
    assert profiling.get_phase_times() == {}
    with pytest.raises(ValueError):
        with profiling.phase_timer("c", log=False):
            raise ValueError("the block's error propagates")
    assert "c" in profiling.get_phase_times()
    profiling.reset_phase_times()
