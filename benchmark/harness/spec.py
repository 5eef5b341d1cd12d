"""Cells resolved by name from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Everything else is found by name: the configuration's file as
``BENCHMARK.json`` gives it (its ``architecture`` block is the reference's
table of the backbone), the mix at ``mixes/<traffic>.json``, the drive
that the mix names at ``drives/<drive>.py``, the limits of its comparison
at ``limits/<cell>.json``, and each per-layer metric's reader at
``metrics/<metric>.py``. Adding a cell, a configuration, a mix, a drive or
a metric adds files and entries; no file of the harness changes.
"""
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple

from benchmark.reference import resnet

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config_name: str
    config: Dict
    traffic: str
    mix: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]
    drive: type  # the mix's drive class (``drives/<drive>.py``'s ``DRIVE``)
    readers: Dict[str, Callable]  # per-layer metric -> its ``read(ctx)``


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    resnet.register(config["params"]["backbone"], config["architecture"])
    here = root / BENCH_DIR.name
    mix = json.loads((here / "mixes" / f"{w['traffic']}.json").read_text())
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=cfg["name"], config=config,
        traffic=w["traffic"], mix=mix,
        limits=json.loads((here / "limits" / f"{name}.json").read_text())["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=per_layer,
        drive=_load(here / "drives" / f"{mix['drive']}.py").DRIVE,
        readers={m["name"]: reader(m["name"], root) for m in per_layer},
    )


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    return _load(root / BENCH_DIR.name / "metrics" / f"{metric}.py").read
