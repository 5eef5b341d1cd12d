"""Shared set-up of the benchmark's own tests (run them with ``python -m
pytest benchmark/tests``; the repository's ``pytest tests/`` does not
collect them). On the CPU every cell runs at a tiny size; tests marked
``cuda`` run on a card and skip without one."""
import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ.setdefault("PD_FUSION_TORCH_DEVICE", "cpu")

TINY = {"target_shape": [16, 16, 16], "slice_count": 4, "input_size": 32}


def _register_architectures():
    """Every configuration's backbone table, as resolving its cells takes it."""
    from benchmark.harness import spec

    for w in spec.load_benchmark()["workloads"]:
        spec.resolve(w["name"])


_register_architectures()


def tiny_cell(name: str, arch: str = "resnet18", **params):
    """The cell as ``BENCHMARK.json`` has it, at a size the CPU can hold:
    16 bags of 4 slices of 16^2, taken to 32^2."""
    from benchmark.harness import spec

    cell = spec.resolve(name)
    config = json.loads(json.dumps(cell.config))
    config["params"].update(TINY, backbone=arch)
    config["params"].update(params)
    mix = dict(cell.mix, bags=16, positive_bags=8)
    if "bn_stats_slices" in mix:
        mix["bn_stats_slices"] = 4
    return cell._replace(config=config, mix=mix)


@pytest.fixture
def tiny():
    return tiny_cell


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
