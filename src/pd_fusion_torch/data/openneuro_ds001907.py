"""OpenNeuro ds001907 dataset loader: prebuilt manifest -> (df, masks)
(port of ``pd_fusion/data/openneuro_ds001907.py``).

The manifest path comes from the ``PD_FUSION_DS001907_MANIFEST``
environment override or the config. Two feature modes are ported:
``resnet2d_mil`` (precomputed per-slice bags in ``mri_mil``; the mri mask
marks rows with a bag) and ``resnet2d`` (mean-pooled ``mri_resnet_*``
columns; the mri mask marks rows with any feature present). The other
modes raise ``NotImplementedError`` naming their ROADMAP item. Labels
canonicalize to ``diagnosis``; the clinical/datspect masks are all-zero
and those groups have no columns (MRI-only dataset).
"""
import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import pandas as pd

from pd_fusion_torch.data.schema import TARGET_COL

_DEFAULT_MANIFEST = "data/processed/openneuro_ds001907_manifest.csv"
_CACHE_ROOT = "data/processed/openneuro_ds001907"
# feature modes of the JAX package that the port does not load yet, and
# the ROADMAP item that brings each
_NOT_PORTED = {
    "simple": "Queue 1 item 13",
    "cnn3d": "Queue 1 item 13",
    "resnet2d_mil_ft": "Queue 1 item 11",
}


def _manifest_path(config: Dict) -> Path:
    override = os.environ.get("PD_FUSION_DS001907_MANIFEST")
    if override:
        return Path(override)
    return Path(config.get("manifest_path", _DEFAULT_MANIFEST))


def load_openneuro_ds001907(config: Dict) -> Tuple[pd.DataFrame, Dict[str, np.ndarray]]:
    manifest = _manifest_path(config)
    if not manifest.exists():
        raise FileNotFoundError(f"ds001907 manifest not found: {manifest}")

    mode = config.get("feature_mode", "simple")
    if mode in _NOT_PORTED:
        raise NotImplementedError(
            f"feature_mode '{mode}' is not ported to pd_fusion_torch yet "
            f"(ROADMAP {_NOT_PORTED[mode]})"
        )
    from pd_fusion_torch.data import openneuro_features as F

    loaders = {"resnet2d": F.load_resnet2d_embeddings,
               "resnet2d_mil": F.load_resnet2d_mil_embeddings}
    if mode not in loaders:
        raise ValueError(f"unknown feature_mode '{mode}'")
    df = loaders[mode](
        manifest,
        Path(config.get("resnet2d_cache_dir", f"{_CACHE_ROOT}/embeddings_resnet2d")),
        config.get("resnet2d_config", {}),
    )

    if TARGET_COL not in df.columns:
        if "label" not in df.columns:
            raise ValueError("ds001907 frame lacks both 'label' and 'diagnosis'")
        df[TARGET_COL] = df["label"].astype(int)

    value_cols = [c for c in df.columns if c.startswith("mri_") and c != "mri_mil"]
    if value_cols:
        mri_mask = df[value_cols].notna().any(axis=1).astype(int).to_numpy()
    else:
        mri_mask = df["mri_mil"].map(lambda bag: int(bag is not None)).to_numpy()
    zeros = np.zeros(len(df), dtype=int)
    return df, {"clinical": zeros, "datspect": zeros.copy(), "mri": mri_mask}
