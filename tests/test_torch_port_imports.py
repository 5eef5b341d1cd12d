"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and
the card unless the CPU is asked for."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "pd_fusion_torch"

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(SRC)!r})
import pd_fusion_torch
names = [m.name for m in pkgutil.walk_packages(pd_fusion_torch.__path__, "pd_fusion_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "pd_fusion") or m.startswith(("jax.", "jaxlib", "pd_fusion.")))
print(len(names), bad, " ".join(names))
"""

# the modules of the calibrated, MoE and GBDT slice and of the imaging
# embed path, each imported above
SLICE_MODULES = ("ops.isotonic", "ops.isotonic_checks", "nn.moe", "models.moe", "nn.gbdt",
                 "nn.gbdt_checks", "models.unimodal_gbdt", "ops.treeshap")
EMBED_MODULES = ("imaging.nifti", "imaging.native", "imaging.pipeline", "imaging.embed_checks",
                 "ops.image", "nn.resnet", "data.openneuro_features", "data.openneuro_ds001907",
                 "scripts.build_resnet2d_embeddings", "scripts.build_resnet2d_mil_embeddings")
# the MIL fine-tune slice
FT_MODULES = ("models.mil_attention_finetune", "models.ft_checks", "nn.ft_optim",
              "training.callbacks", "utils.checkpoint", "utils.profiling")
# the ds001907 volume-feature path and the dev datasets
VOLUME_MODULES = ("ops.volume_stats", "ops.volume_stats_checks", "nn.cnn3d", "nn.cnn3d_checks",
                  "scripts.build_cnn3d_embeddings", "data.dev_datasets",
                  "data.dev_datasets.uci_parkinsons", "data.dev_datasets.uci_telemonitoring",
                  "data.dev_datasets.openneuro", "features", "features.clinical",
                  "features.datspect", "features.mri")
# download-dev and the PPMI study-data path
STUDY_MODULES = ("data.download", "data.download.uci_download", "data.download.openneuro_download",
                 "data.download.download_manager", "data.ppmi_studydata", "analysis",
                 "analysis.tabular", "analysis.column_transformer", "analysis.tabular_checks",
                 "nn.logreg", "scripts._cli_common", "scripts.ppmi_build_dataset",
                 "scripts.ppmi_train_tabular", "scripts.ppmi_eval_report",
                 "scripts.ppmi_meaningful_suite")
# the sweep tier, the stress test, the imaging upgrade and the torch helpers
SWEEP_MODULES = ("parallel.seed_sweep", "analysis.aggregate_results", "analysis.bootstrap_ci",
                 "analysis.generate_summary", "analysis.sweep_checks", "scripts.submit_sweep",
                 "scripts.submit_dual_h200", "scripts.ppmi_stress_test",
                 "scripts.ppmi_imaging_upgrade", "utils.torch_utils",
                 "scripts.export_backbone_weights", "scripts.verify_loaders")
# the multi-device tier; the run-to-run determinism checks; the ResNet's
# convolution gradient checks
MULTICHIP_MODULES = ("parallel.distributed", "parallel.dryrun", "utils.determinism_checks",
                     "nn.resnet_checks")


def test_port_imports_without_jax_or_jax_package():
    # a fresh interpreter: the test workers already hold jax
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True, timeout=120,
        check=True,
    ).stdout.strip()
    count, rest = out.split(maxsplit=1)
    bad, names = rest.split("] ", 1)
    assert int(count) >= 85  # every module of the port was imported
    assert bad + "]" == "[]"
    assert ({f"pd_fusion_torch.{m}"
             for m in SLICE_MODULES + EMBED_MODULES + FT_MODULES + VOLUME_MODULES + STUDY_MODULES
             + SWEEP_MODULES + MULTICHIP_MODULES}
            <= set(names.split()))


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(PORT))
)
def test_port_source_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "optax", "pd_fusion"), f"{path.name} imports {mod}"


def test_port_builds_its_own_native_source_not_the_root_tree():
    """The host IO library is the port's ``csrc/pd_io.cpp``, built into the
    gitignored ``build/host/``; nothing of the repository's ``native/``."""
    from pd_fusion_torch.imaging import native
    from pd_fusion_torch.paths import HOST_BUILD_DIR, ROOT_DIR

    assert native.SOURCE == PORT / "csrc" / "pd_io.cpp" and native.SOURCE.exists()
    assert HOST_BUILD_DIR == ROOT_DIR / "build" / "host"
    for path in PORT.rglob("*.py"):  # no path joined onto the root's native/
        assert '"native"' not in path.read_text(), path


def test_get_device_raises_without_cuda_unless_cpu_requested(monkeypatch):
    from pd_fusion_torch.utils.device import DEVICE_ENV, get_device

    monkeypatch.delenv(DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_device()
    assert get_device("cpu") == torch.device("cpu")
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    assert get_device() == torch.device("cpu")


def test_get_device_defaults_to_cuda_when_present(monkeypatch):
    from pd_fusion_torch.utils.device import DEVICE_ENV, get_device

    monkeypatch.delenv(DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert get_device() == torch.device("cuda")
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_set_seed_matches_jax_package_host_draws_and_chains_generators():
    import numpy as np

    from pd_fusion.utils.seed import set_seed as jax_set_seed
    from pd_fusion_torch.utils.seed import fresh_generator, set_seed

    jax_set_seed(7)
    want = (np.random.rand(5), __import__("random").random())
    set_seed(7)
    got = (np.random.rand(5), __import__("random").random())
    np.testing.assert_array_equal(want[0], got[0])
    assert want[1] == got[1]

    set_seed(7)
    a = [torch.rand(3, generator=fresh_generator()) for _ in range(2)]
    set_seed(7)
    b = [torch.rand(3, generator=fresh_generator()) for _ in range(2)]
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], a[1])


def test_chip_smoke_imports_no_jax_or_jax_package():
    for mod in _imported_modules(SRC.parent / "chip_smoke.py"):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "optax", "pd_fusion"), mod


def test_chip_smoke_fails_without_a_card_and_prints_no_result(tmp_path):
    """Without a CUDA device the script exits non-zero before any phase and
    prints no result line, also when run alone outside the repository."""
    import shutil

    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SRC.parent / "chip_smoke.py", alone)
    for script in (SRC.parent / "chip_smoke.py", alone):
        run = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                             timeout=120, cwd=tmp_path)
        assert run.returncode != 0
        assert '"ok"' not in run.stdout and '"kernels"' not in run.stdout
