"""MRI feature and embedding builders and loaders for OpenNeuro manifests
(port of ``pd_fusion/data/openneuro_features.py``: cache naming, the simple
3-D statistics, the CNN3D embeddings' loader, the mean-pooled and
per-slice ResNet2D builders and their loaders).

Artifacts are content-addressed: ``<prefix>_<sha256(manifest)[:12]>_
<sha256(str(sorted(config.items())))[:12]>``, with the JAX package's
names, keys and meta JSON, so caches built by either package load in the
other: mean-pooled ``resnet2d_*.parquet`` (``mri_resnet_{k}`` columns),
per-slice ``resnet2d_mil_*.npz`` {embeddings, subject_id, session, label},
and ``<stem>.json`` with the backbone, its width and whether it was
pretrained. The numeric work is ``imaging/pipeline.py``'s streaming
pipeline on the card. A random-init backbone uses mean/std 0.5, a
pretrained one the ImageNet constants.

The simple 3-D statistics (``features_*.parquet``, ``mri_feat_{k}``
columns) are built on first load: the native read + resize on the host
threads, then ``ops/volume_stats.py`` on the card, ``STATS_BATCH``
volumes a call (the last call takes what is left: a padded batch would
change no value). The CNN3D embeddings (``embeddings_*.parquet``,
``mri_cnn_{k}``) are built by ``python -m
pd_fusion_torch.scripts.build_cnn3d_embeddings`` and only loaded here.
"""
import hashlib
import json
from pathlib import Path
from typing import Dict

import numpy as np
import pandas as pd

from pd_fusion_torch.parallel import distributed

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


def _read_manifest(manifest_path: Path) -> pd.DataFrame:
    df = pd.read_csv(manifest_path)
    if "t1wbrain_path" not in df.columns:
        raise ValueError(f"manifest {manifest_path} lacks a t1wbrain_path column")
    return df


def _id_columns(df: pd.DataFrame) -> Dict[str, np.ndarray]:
    return {
        "subject_id": df["subject_id"].to_numpy(),
        "session": df.get("session", pd.Series([1] * len(df))).to_numpy(),
        "label": df["label"].astype(int).to_numpy(),
    }


STATS_BATCH = 8  # volumes per device call of the simple statistics


def build_simple_features(manifest_path: Path, cache_dir: Path, config: Dict) -> pd.DataFrame:
    """Masked statistics, histogram and grid features of every manifest
    volume -> one row per volume, parquet-cached under the JAX package's
    name. Runs on the card unless ``PD_FUSION_TORCH_DEVICE`` names another
    device."""
    import torch

    from pd_fusion_torch.imaging.pipeline import VolumePrefetcher, make_volume_loader
    from pd_fusion_torch.ops.volume_stats import simple_volume_features
    from pd_fusion_torch.utils.device import get_device

    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    out_path = cache_dir / f"{_cache_stem('features', manifest_path, config)}.parquet"
    if out_path.exists():
        return pd.read_parquet(out_path)

    df = _read_manifest(manifest_path)
    hist_bins = int(config.get("hist_bins", 10))
    grid_size = int(config.get("grid_size", 8))
    extra = bool(config.get("extra_stats", False))
    target = tuple(int(t) for t in config.get("target_shape", (96, 96, 96)))
    dev = get_device()

    outs, pending = [], []

    def flush():
        vols = torch.from_numpy(np.stack(pending)).to(dev)
        outs.append(simple_volume_features(vols, hist_bins, grid_size, extra))
        pending.clear()

    with torch.inference_mode():
        loader = make_volume_loader(target)
        for _, vol in VolumePrefetcher([Path(p) for p in df["t1wbrain_path"]], loader):
            pending.append(vol)
            if len(pending) == STATS_BATCH:
                flush()
        if pending:
            flush()
        mat = torch.cat(outs).cpu().numpy().astype(float)

    out = pd.DataFrame(
        {**_id_columns(df), **{f"mri_feat_{k}": mat[:, k] for k in range(mat.shape[1])}})
    out.to_parquet(out_path, index=False)
    return out


# the loader builds on first use, as the JAX package's
load_simple_features = build_simple_features


def load_cnn_embeddings(manifest_path: Path, cache_dir: Path, config: Dict) -> pd.DataFrame:
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    out_path = cache_dir / f"{_cache_stem('embeddings', manifest_path, config)}.parquet"
    if not out_path.exists():
        raise FileNotFoundError(
            f"CNN3D embeddings missing at {out_path}; build them with "
            "python -m pd_fusion_torch.scripts.build_cnn3d_embeddings"
        )
    return pd.read_parquet(out_path)


def _resnet_setup(config: Dict):
    """Backbone params, preprocessing constants and slicing plan of an
    embedding config."""
    from pd_fusion_torch.nn.resnet import IMAGENET_MEAN, IMAGENET_STD, load_backbone

    arch = config.get("backbone", "resnet18")
    params, dim, pretrained = load_backbone(
        arch, weights_path=config.get("weights_path"), seed=int(config.get("seed", 0)))
    if pretrained:
        mean, std = IMAGENET_MEAN, IMAGENET_STD
    else:
        mean, std = np.full(3, 0.5, np.float32), np.full(3, 0.5, np.float32)
    if "slice_axes" in config:
        axes = [int(a) for a in config["slice_axes"]]
        counts = [int(c) for c in config["slice_counts"]]
    else:
        axes = [int(config.get("slice_axis", 2))]
        counts = [int(config.get("slice_count", 24))]
    return arch, params, dim, pretrained, mean, std, axes, counts


def _run_embed(manifest_df: pd.DataFrame, config: Dict, per_slice: bool):
    from pd_fusion_torch.imaging.pipeline import run_resnet_embedding_pipeline

    arch, params, dim, pretrained, mean, std, axes, counts = _resnet_setup(config)
    embeddings = run_resnet_embedding_pipeline(
        [Path(p) for p in manifest_df["t1wbrain_path"]],
        manifest_df["subject_id"].tolist(),
        params,
        mean,
        std,
        arch=arch,
        target_shape=tuple(int(t) for t in config.get("target_shape", (160, 160, 160))),
        axes=axes,
        counts=counts,
        input_size=int(config.get("input_size", 224)),
        tta=int(config.get("tta", 1)),
        max_rotation=float(config.get("max_rotation_deg", 5.0)),
        max_translation=float(config.get("max_translation", 0.05)),
        intensity_scale=float(config.get("intensity_scale", 0.1)),
        intensity_shift=float(config.get("intensity_shift", 0.1)),
        noise_std=float(config.get("noise_std", 0.01)),
        per_slice=per_slice,
        compute_dtype=str(config.get("compute_dtype", "float32")),
    )
    return embeddings, arch, dim, pretrained


def _write_meta(path: Path, manifest_path: Path, config: Dict, arch: str, dim: int,
                pretrained: bool, n: int) -> None:
    meta = {
        "manifest": str(manifest_path),
        "config": {k: (list(v) if isinstance(v, tuple) else v) for k, v in config.items()},
        "backbone": arch,
        "emb_dim": int(dim),
        "pretrained": bool(pretrained),
        "n_subjects": int(n),
    }
    path.write_text(json.dumps(meta, indent=2))


def build_resnet2d_embeddings(manifest_path: Path, cache_dir: Path, config: Dict) -> pd.DataFrame:
    """Mean-pooled [emb_dim] embedding per subject -> ``mri_resnet_{k}``
    columns; parquet + meta-json cached."""
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    stem = _cache_stem("resnet2d", manifest_path, config)
    out_path = cache_dir / f"{stem}.parquet"
    if out_path.exists():
        return pd.read_parquet(out_path)

    df = _read_manifest(manifest_path)
    embeddings, arch, dim, pretrained = _run_embed(df, config, per_slice=False)
    mat = np.stack(embeddings).astype(float)
    out = pd.DataFrame(
        {**_id_columns(df), **{f"mri_resnet_{k}": mat[:, k] for k in range(mat.shape[1])}})
    if not distributed.is_primary():
        return out  # rank 0 writes the cache
    out.to_parquet(out_path, index=False)
    _write_meta(cache_dir / f"{stem}.json", manifest_path, config, arch, dim, pretrained, len(df))
    return out


def load_resnet2d_embeddings(manifest_path: Path, cache_dir: Path, config: Dict) -> pd.DataFrame:
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    out_path = cache_dir / f"{_cache_stem('resnet2d', manifest_path, config)}.parquet"
    if not out_path.exists():
        raise FileNotFoundError(
            f"ResNet2D embeddings missing at {out_path}; build them with "
            "python -m pd_fusion_torch.scripts.build_resnet2d_embeddings"
        )
    return pd.read_parquet(out_path)


def build_resnet2d_mil_embeddings(manifest_path: Path, cache_dir: Path, config: Dict) -> Path:
    """Per-slice [n_slices, emb_dim] bags -> one ``.npz`` {embeddings,
    subject_id, session, label} + meta json. Returns the artifact path."""
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    stem = _cache_stem("resnet2d_mil", manifest_path, config)
    out_path = cache_dir / f"{stem}.npz"
    if out_path.exists():
        return out_path

    df = _read_manifest(manifest_path)
    embeddings, arch, dim, pretrained = _run_embed(df, config, per_slice=True)
    if not distributed.is_primary():
        return out_path  # rank 0 writes the cache
    ids = _id_columns(df)
    np.savez_compressed(
        out_path,
        embeddings=np.stack(embeddings),
        subject_id=ids["subject_id"],
        session=ids["session"],
        label=ids["label"],
    )
    _write_meta(cache_dir / f"{stem}.json", manifest_path, config, arch, dim, pretrained, len(df))
    return out_path


def load_resnet2d_mil_embeddings(manifest_path: Path, cache_dir: Path, config: Dict) -> pd.DataFrame:
    """The ``.npz`` {embeddings [N, n_slices, D], subject_id, session,
    label} -> frame with one bag per row in ``mri_mil``."""
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    out_path = cache_dir / f"{_cache_stem('resnet2d_mil', manifest_path, config)}.npz"
    if not out_path.exists():
        raise FileNotFoundError(
            f"ResNet2D MIL embeddings missing at {out_path}; build them with "
            "python -m pd_fusion_torch.scripts.build_resnet2d_mil_embeddings"
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
