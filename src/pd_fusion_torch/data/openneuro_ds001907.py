"""OpenNeuro ds001907 dataset loader: prebuilt manifest -> (df, masks)
(port of ``pd_fusion/data/openneuro_ds001907.py``).

The manifest path comes from the ``PD_FUSION_DS001907_MANIFEST``
environment override or the config. ``feature_mode`` picks the MRI
features, each through a row of one dispatch table (cache-dir key,
default dir, settings key, loader):

- ``simple`` (the default): 3-D statistics ``mri_feat_*``, built on first
  load (``feature_config``);
- ``cnn3d``: the CNN3D autoencoder's ``mri_cnn_*`` embeddings, built by
  ``python -m pd_fusion_torch.scripts.build_cnn3d_embeddings``
  (``cnn_config``);
- ``resnet2d``: mean-pooled ``mri_resnet_*`` columns;
- ``resnet2d_mil``: precomputed per-slice bags in ``mri_mil``;
- ``resnet2d_mil_ft``: the NIfTI paths of ``t1wbrain_path`` in
  ``mri_mil``, for the MIL fine-tune to stream.

The mri mask marks rows with any ``mri_*`` value present, or else rows
with a bag; a frame with neither raises. Labels canonicalize to
``diagnosis``; the clinical/datspect masks are all-zero and those groups
have no columns (MRI-only dataset).
"""
import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import pandas as pd

from pd_fusion_torch.data.schema import TARGET_COL

_DEFAULT_MANIFEST = "data/processed/openneuro_ds001907_manifest.csv"
_CACHE_ROOT = "data/processed/openneuro_ds001907"


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
    from pd_fusion_torch.data import openneuro_features as F

    # feature_mode -> (cache-dir config key, default cache dir, settings key, loader)
    loaders = {
        "simple": ("feature_cache_dir", f"{_CACHE_ROOT}/features_simple", "feature_config",
                   F.load_simple_features),
        "cnn3d": ("embedding_cache_dir", f"{_CACHE_ROOT}/embeddings_cnn3d", "cnn_config",
                  F.load_cnn_embeddings),
        "resnet2d": ("resnet2d_cache_dir", f"{_CACHE_ROOT}/embeddings_resnet2d",
                     "resnet2d_config", F.load_resnet2d_embeddings),
        "resnet2d_mil": ("resnet2d_cache_dir", f"{_CACHE_ROOT}/embeddings_resnet2d",
                         "resnet2d_config", F.load_resnet2d_mil_embeddings),
        "resnet2d_mil_ft": ("feature_cache_dir", _CACHE_ROOT, "feature_config", _mil_ft_frame),
    }
    if mode not in loaders:
        raise ValueError(f"unknown feature_mode '{mode}' (choose from {sorted(loaders)})")
    dir_key, default_dir, cfg_key, loader = loaders[mode]
    df = loader(manifest, Path(config.get(dir_key, default_dir)), config.get(cfg_key, {}))

    if TARGET_COL not in df.columns:
        if "label" not in df.columns:
            raise ValueError("ds001907 frame lacks both 'label' and 'diagnosis'")
        df[TARGET_COL] = df["label"].astype(int)

    value_cols = [c for c in df.columns if c.startswith("mri_") and c != "mri_mil"]
    if value_cols:
        mri_mask = df[value_cols].notna().any(axis=1).astype(int).to_numpy()
    elif "mri_mil" in df.columns:
        mri_mask = df["mri_mil"].map(lambda bag: int(bag is not None)).to_numpy()
    else:
        raise ValueError("no mri_* feature columns (or mri_mil bags) in ds001907 frame")
    zeros = np.zeros(len(df), dtype=int)
    return df, {"clinical": zeros, "datspect": zeros.copy(), "mri": mri_mask}
