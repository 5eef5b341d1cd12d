"""``BENCHMARK.json`` against the benchmark's contract, every name resolved
to its files, and a new cell resolved from added files and entries alone."""
import json
import re
import shutil

import pytest

from benchmark.harness import runner, spec
from benchmark.harness.drive import Drive
from benchmark.reference import resnet

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = spec.load_benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert not any(p.startswith("/") or ".." in p.split("/") or p.endswith("_torch")
                   for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) <= {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        assert m["source"] in SOURCES
        seen.add(m["name"])
    assert len(seen) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(name):
    cell = spec.resolve(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert issubclass(cell.drive, Drive) and cell.drive.rate in e2e and cell.limits
    assert cell.config["params"]["backbone"] in ("resnet18", "resnet50")
    for m in cell.per_layer:
        assert callable(cell.readers[m["name"]])
        assert m["moves"] in e2e  # the end-to-end metric it moves is reported in the cell


def test_configs_keep_every_width():
    src = json.loads((spec.BENCH_DIR / "configs" / "mil_ft_resnet50.json").read_text())
    other = json.loads((spec.BENCH_DIR / "configs" / "mil_ft_resnet18.json").read_text())
    differ = {k for k in src["params"] if src["params"][k] != other["params"][k]}
    assert differ == {"backbone"}
    p = src["params"]
    assert (p["slice_count"], p["input_size"], p["hidden_dim"], p["attn_dim"],
            p["batch_size"], p["target_shape"]) == (64, 224, 256, 128, 4, [160, 160, 160])


def test_configs_are_the_reference_tables():
    """Each configuration's ``architecture`` block is the reference's table."""
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        a = resnet.ARCHS[cfg["params"]["backbone"]]
        arch = cfg["architecture"]
        assert (a.block, list(a.layers), list(a.widths), a.expansion, a.embedding) == (
            arch["block"], arch["stage_blocks"], arch["stage_widths"], arch["expansion"],
            arch["embedding_dim"])
        assert c["reduced"] == cfg["reduced"] == []


COUNT_DRIVE = """
from benchmark.harness.drive import Drive


class Count(Drive):
    rate = "train_slices_per_s"
    work_per_call = flops_per_call = 1

    def setup(self):
        self.n = 0

    def call(self):
        self.n += 1

    def release(self):
        pass

    def check(self):
        return {"count_gap": 0.0 if self.n > 0 else 1.0}


DRIVE = Count
"""


def test_a_new_drive_runs_from_an_added_file(tmp_path):
    """A later kind of traffic: a drive, a mix that names it and a cell, as
    files and entries only, run through the runner with no file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark")
    bench = json.loads(json.dumps(BENCH))
    (root / "benchmark" / "drives" / "count.py").write_text(COUNT_DRIVE)
    (root / "benchmark" / "mixes" / "count.json").write_text(
        json.dumps({"drive": "count", "bags": 4, "positive_bags": 2}))
    (root / "benchmark" / "limits" / "count.mil_ft_resnet18.json").write_text(
        json.dumps({"limits": {"count_gap": 0.0}}))
    bench["workloads"].append({"name": "count.mil_ft_resnet18", "config": "mil_ft_resnet18",
                               "traffic": "count", "chips": 1, "why": "a new drive"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "train_slices_per_s":
            m["workloads"].append("count.mil_ft_resnet18")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve("count.mil_ft_resnet18", root)
    assert cell.drive.__name__ == "Count" and not cell.per_layer
    out = runner.run(cell, 2**31 + 3, 0.05, False, "cpu", log=lambda s: None)
    assert out["correct"] and out["attempted"] >= 4 * 2, out
    assert set(out["metrics"]) == {"train_slices_per_s", "setup_s"}


def test_a_new_cell_resolves_from_added_files_alone(tmp_path):
    """A later cell: a new configuration, mix, limits and per-layer metric,
    as files and entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark")
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((spec.BENCH_DIR / "configs" / "mil_ft_resnet50.json").read_text())
    cfg["params"]["freeze_backbone_epochs"] = 1
    (root / "benchmark" / "configs" / "new_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((spec.BENCH_DIR / "mixes" / "ft_train.json").read_text())
    mix["params"]["freeze_backbone_epochs"] = 1
    (root / "benchmark" / "mixes" / "ft_frozen.json").write_text(json.dumps(mix))
    (root / "benchmark" / "limits" / "ft_frozen.new_cfg.json").write_text(
        json.dumps({"limits": {"loss_gap": 1.0}}))
    (root / "benchmark" / "metrics" / "steps.train.py").write_text(
        "def read(ctx):\n    return ctx['calls']\n")
    bench["configs"].append({"name": "new_cfg", "source": "https://example.org/new",
                             "file": "benchmark/configs/new_cfg.json", "reduced": []})
    bench["workloads"].append({"name": "ft_frozen.new_cfg", "config": "new_cfg",
                               "traffic": "ft_frozen", "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "step",
                               "moves": "train_slices_per_s",
                               "workloads": ["ft_frozen.new_cfg"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "train_slices_per_s":
            m["workloads"].append("ft_frozen.new_cfg")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve("ft_frozen.new_cfg", root)
    assert cell.mix["params"]["freeze_backbone_epochs"] == 1
    assert cell.config["params"]["freeze_backbone_epochs"] == 1
    assert [m["name"] for m in cell.per_layer][-1] == "steps.train"
    assert spec.reader("steps.train", root)({"calls": 3}) == 3
    assert {m["name"] for m in cell.end_to_end} == {"train_slices_per_s", "setup_s"}
    assert spec.resolve("ft_train.resnet50", root).limits == spec.resolve(
        "ft_train.resnet50").limits
