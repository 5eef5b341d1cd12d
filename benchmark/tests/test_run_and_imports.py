"""The command without a card, the command in a directory that holds only
the benchmark, and the import check: no top-level ``jax``, ``jaxlib``,
``flax`` or ``pd_fusion`` module, names compared whole; the reference
loads nothing of the program."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path


from benchmark.harness import guard

ROOT = Path(__file__).resolve().parents[2]
TINY_RUN = """
import json, sys
sys.path[:0] = [{root!r}, {root!r} + "/src"]
sys.path.insert(0, {tests!r})
from conftest import tiny_cell
from benchmark.harness import guard, runner
out = runner.run(tiny_cell("ft_predict.resnet50"), 7, 0.1, False, "cpu", log=lambda s: None)
print(json.dumps({{"correct": out["correct"], "forbidden": guard.forbidden_loaded(),
                  "port": "pd_fusion_torch" in sys.modules}}))
"""


def _env():
    env = dict(os.environ, PD_FUSION_TORCH_DEVICE="cpu", OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    return env


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ft_train.resnet50",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(_env(), CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert "CUDA card" in proc.stderr


def test_benchmark_alone_cannot_run(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, the
    program is missing: a run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = TINY_RUN.format(root=str(tmp_path), tests=str(tmp_path / "benchmark" / "tests"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env=_env())
    assert proc.returncode != 0 and "pd_fusion_torch" in proc.stderr
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]


def test_a_run_loads_no_jax():
    code = TINY_RUN.format(root=str(ROOT), tests=str(Path(__file__).parent))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out == {"correct": True, "forbidden": [], "port": True}


def test_guard_compares_whole_names():
    assert guard.forbidden_loaded(["pd_fusion_torch", "pd_fusion_torch.nn", "jaxtyping",
                                   "flaxen", "numpy"]) == []
    assert guard.forbidden_loaded(["pd_fusion.models", "jaxlib.xla_client", "flax",
                                   "jax"]) == ["flax", "jax", "jaxlib", "pd_fusion"]


def test_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}]\n"
            "import benchmark.reference.mil_ft, benchmark.reference.resnet, benchmark.flops\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'pd_fusion_torch', 'pd_fusion', 'jax', 'jaxlib', 'flax'}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=_env())
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stderr
    for src in (ROOT / "benchmark" / "reference").glob("*.py"):
        text = src.read_text()
        assert "import pd_fusion" not in text and "from pd_fusion" not in text, src
