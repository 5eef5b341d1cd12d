"""Cache naming and the per-slice MIL bag loader for OpenNeuro manifests
(port of ``pd_fusion/data/openneuro_features.py``: ``manifest_key``,
``config_key``, ``_cache_stem`` and ``load_resnet2d_mil_embeddings``).

Artifacts are content-addressed: ``<prefix>_<sha256(manifest)[:12]>_
<sha256(str(sorted(config.items())))[:12]>``, bit-identical to the JAX
package's names, so bags built by its
``scripts/build_resnet2d_mil_embeddings.py`` load here unchanged. The
builders themselves (ResNet slice embedding) come with the imaging slice
of the port.
"""
import hashlib
from pathlib import Path
from typing import Dict

import numpy as np
import pandas as pd

_KEY_BYTES = 1 << 20


def manifest_key(manifest_path: Path) -> str:
    """First 12 hex chars of the manifest file's sha256."""
    digest = hashlib.sha256()
    with open(manifest_path, "rb") as fh:
        for block in iter(lambda: fh.read(_KEY_BYTES), b""):
            digest.update(block)
    return digest.hexdigest()[:12]


def config_key(cfg: Dict) -> str:
    """sha256 of the sorted item repr, first 12 hex chars."""
    return hashlib.sha256(str(sorted(cfg.items())).encode()).hexdigest()[:12]


def _cache_stem(prefix: str, manifest_path: Path, cfg: Dict) -> str:
    return f"{prefix}_{manifest_key(manifest_path)}_{config_key(cfg)}"


def load_resnet2d_mil_embeddings(manifest_path: Path, cache_dir: Path, config: Dict) -> pd.DataFrame:
    """The ``.npz`` {embeddings [N, n_slices, D], subject_id, session,
    label} -> frame with one bag per row in ``mri_mil``."""
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    out_path = cache_dir / f"{_cache_stem('resnet2d_mil', manifest_path, config)}.npz"
    if not out_path.exists():
        raise FileNotFoundError(
            f"ResNet2D MIL embeddings missing at {out_path}; build them with "
            "scripts/build_resnet2d_mil_embeddings.py"
        )
    data = np.load(out_path, allow_pickle=True)
    out = pd.DataFrame(
        {
            "subject_id": data["subject_id"],
            "session": data["session"],
            "label": data["label"],
        }
    )
    out["mri_mil"] = list(data["embeddings"])
    return out
