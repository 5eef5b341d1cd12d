"""Repository path constants (own copy of ``pd_fusion/paths.py``).

``ROOT_DIR`` resolves to the repository root, so the port shares the JAX
package's ``configs/`` and ``runs/`` directories. ``BUILD_DIR`` holds the
CUDA kernels the port builds at first use, ``HOST_BUILD_DIR`` its host C++
library (``csrc/pd_io.cpp``); ``build/`` is listed in ``.gitignore``.
"""
import os
from pathlib import Path

ROOT_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = ROOT_DIR / "src" / "pd_fusion_torch"

DATA_DIR = ROOT_DIR / "data"
RAW_DATA_DIR = DATA_DIR / "raw"
PROCESSED_DATA_DIR = DATA_DIR / "processed"
# Dev datasets (UCI / OpenNeuro downloads) may live outside the repo.
DEV_DATA_DIR = Path(os.environ.get("PD_FUSION_DEV_DATA_DIR") or DATA_DIR / "raw_dev")

RUNS_DIR = ROOT_DIR / "runs"
CONFIGS_DIR = ROOT_DIR / "configs"
BUILD_DIR = ROOT_DIR / "build" / "kernels"
HOST_BUILD_DIR = ROOT_DIR / "build" / "host"


def get_run_dir(run_id: str) -> Path:
    """Resolve (and create) the artifact directory for one run."""
    path = RUNS_DIR / run_id
    path.mkdir(parents=True, exist_ok=True)
    return path
