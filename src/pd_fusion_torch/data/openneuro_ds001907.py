"""OpenNeuro ds001907 dataset loader: prebuilt manifest -> (df, masks)
(port of ``pd_fusion/data/openneuro_ds001907.py``).

The manifest path comes from the ``PD_FUSION_DS001907_MANIFEST``
environment override or the config. Three feature modes are ported:
``resnet2d_mil`` (precomputed per-slice bags in ``mri_mil``; the mri mask
marks rows with a bag), ``resnet2d_mil_ft`` (the NIfTI paths of
``t1wbrain_path`` in ``mri_mil``, for the MIL fine-tune to stream) and
``resnet2d`` (mean-pooled ``mri_resnet_*`` columns; the mri mask marks
rows with any feature present). The other modes raise
``NotImplementedError`` naming their ROADMAP item. Labels
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
}


def _manifest_path(config: Dict) -> Path:
    override = os.environ.get("PD_FUSION_DS001907_MANIFEST")
    if override:
        return Path(override)
    return Path(config.get("manifest_path", _DEFAULT_MANIFEST))


def _mil_ft_frame(manifest: Path, cache_dir: Path, cfg: Dict) -> pd.DataFrame:
    """Fine-tune mode: no precomputed features; the NIfTI paths go into
    ``mri_mil`` for ``MilAttentionFineTuneModel`` to stream."""
    df = pd.read_csv(manifest)
    if "t1wbrain_path" not in df.columns:
        raise ValueError("manifest lacks t1wbrain_path (required for MIL fine-tune)")
    df["mri_mil"] = df["t1wbrain_path"]
    return df


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

    # feature_mode -> (cache-dir config key, default cache dir, settings key, loader)
    loaders = {
        "resnet2d": ("resnet2d_cache_dir", f"{_CACHE_ROOT}/embeddings_resnet2d",
                     "resnet2d_config", F.load_resnet2d_embeddings),
        "resnet2d_mil": ("resnet2d_cache_dir", f"{_CACHE_ROOT}/embeddings_resnet2d",
                         "resnet2d_config", F.load_resnet2d_mil_embeddings),
        "resnet2d_mil_ft": ("feature_cache_dir", _CACHE_ROOT, "feature_config", _mil_ft_frame),
    }
    if mode not in loaders:
        raise ValueError(f"unknown feature_mode '{mode}'")
    dir_key, default_dir, cfg_key, loader = loaders[mode]
    df = loader(manifest, Path(config.get(dir_key, default_dir)), config.get(cfg_key, {}))

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
