"""Train the 3-D convolutional autoencoder on a manifest's volumes and write
their bottleneck embeddings (port of ``scripts/build_cnn3d_embeddings.py``,
same flags and artifacts):

    python -m pd_fusion_torch.scripts.build_cnn3d_embeddings --manifest <csv>
        [--out-dir D] [--target-shape 96 96 96] [--embedding-dim 128]
        [--epochs 10] [--batch-size 4] [--lr 1e-3] [--seed 42]

Each NIfTI is read on the host threads (``VolumePrefetcher``), then resized
(``ops/image.py::resize3d``) and z-scored on the card, as the JAX script
does (not the native prep); the stacked volumes stay on the card for the
training (``nn/cnn3d.py::train_cnn3d``) and one embedding forward. Writes
``embeddings_<hash_file(manifest)>_<hash_config(cfg)>.parquet``
(``mri_cnn_{k}``, subject_id, session, label) and its ``.json`` {manifest,
config}: the names ``load_cnn_embeddings`` looks up for a data config
whose ``cnn_config`` holds the same five settings. The weights are drawn
from a CPU generator seeded with ``--seed``, the permutations from a
generator on the card seeded with ``--seed + 1``. Runs on the card unless
``PD_FUSION_TORCH_DEVICE`` names another device.

Under ``torchrun`` (one process per card; JAX ``:88-97`` shards the
volume batch over a data mesh) each rank reads and resizes its contiguous
share of the manifest's volumes, the ranks train data-parallel
(``train_cnn3d(group=)``), the embeddings are gathered in manifest order,
and rank 0 writes the files.

    torchrun --standalone --nproc-per-node N -m \
        pd_fusion_torch.scripts.build_cnn3d_embeddings --manifest <csv> ...
"""
import argparse
import json
import time
from pathlib import Path

from pd_fusion_torch.data.openneuro_features import config_key, manifest_key

hash_file = manifest_key  # sha256 of the file, first 12 hex chars
hash_config = config_key  # sha256 of str(sorted(cfg.items())), first 12 hex chars


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Build CNN embeddings for ds001907")
    parser.add_argument("--manifest", type=str, required=True)
    parser.add_argument(
        "--out-dir", type=str, default="data/processed/openneuro_ds001907/embeddings_cnn3d"
    )
    parser.add_argument("--target-shape", type=int, nargs=3, default=[96, 96, 96])
    parser.add_argument("--embedding-dim", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=42)
    return parser.parse_args(argv)


def config_from_args(args) -> dict:
    """The cache key's config: the JAX script's five settings."""
    return {
        "target_shape": args.target_shape,
        "embedding_dim": args.embedding_dim,
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "lr": args.lr,
    }


def _stage(dev, stages, key, t0):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    now = time.perf_counter()
    stages[key] = now - t0
    return now


def main(argv=None) -> dict:
    """-> {"path": the parquet, "cached": whether it was there already,
    "stages": seconds spent in read (NIfTI read, resize and z-score), init,
    train, embed and write}."""
    from pd_fusion_torch.parallel import distributed

    args = parse_args(argv)
    with distributed.process_group():
        return _build(args)


def _build(args) -> dict:
    import pandas as pd
    import torch

    from pd_fusion_torch.imaging.nifti import read_nifti
    from pd_fusion_torch.imaging.pipeline import VolumePrefetcher
    from pd_fusion_torch.nn.cnn3d import cnn3d_embed, cnn3d_init, train_cnn3d
    from pd_fusion_torch.ops.image import resize3d, zscore_volume
    from pd_fusion_torch.parallel import distributed
    from pd_fusion_torch.utils.device import get_device, make_data_mesh, shard_rows

    manifest_path = Path(args.manifest)
    out_dir = Path(args.out_dir)
    if distributed.is_primary():
        out_dir.mkdir(parents=True, exist_ok=True)
    cfg = config_from_args(args)
    stem = f"embeddings_{hash_file(manifest_path)}_{hash_config(cfg)}"
    emb_path, meta_path = out_dir / f"{stem}.parquet", out_dir / f"{stem}.json"
    if emb_path.exists():
        print(f"Embeddings already cached at {emb_path}")
        return {"path": emb_path, "cached": True, "stages": {}}

    dev = get_device()
    stages = {}
    t0 = time.perf_counter()
    df = pd.read_csv(manifest_path)
    shape = tuple(args.target_shape)
    mesh = make_data_mesh()  # None on one card
    group = None if mesh is None else mesh.data_group
    paths = shard_rows([Path(p) for p in df["t1wbrain_path"]], mesh)
    vols = [None] * len(paths)
    with torch.no_grad():
        for i, raw in VolumePrefetcher(paths, read_nifti, depth=4):
            vols[i] = zscore_volume(resize3d(torch.from_numpy(raw).to(dev), shape))
    volumes = torch.stack(vols)[:, None]  # [N, 1, D, H, W]
    del vols
    t0 = _stage(dev, stages, "read_s", t0)

    params = cnn3d_init(torch.Generator().manual_seed(args.seed), shape, args.embedding_dim,
                        device=dev)
    t0 = _stage(dev, stages, "init_s", t0)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    params = train_cnn3d(params, volumes, args.lr, shape, args.epochs,
                         min(args.batch_size, len(df)), generator=gen, group=group)
    t0 = _stage(dev, stages, "train_s", t0)
    emb = cnn3d_embed(params, volumes, shape, group=group).cpu().numpy()
    t0 = _stage(dev, stages, "embed_s", t0)
    if not distributed.is_primary():
        return {"path": emb_path, "cached": False, "stages": stages}

    emb_df = pd.DataFrame(emb, columns=[f"mri_cnn_{i}" for i in range(emb.shape[1])])
    emb_df["subject_id"] = df["subject_id"].values
    emb_df["session"] = df["session"].values
    emb_df["label"] = df["label"].values
    emb_df.to_parquet(emb_path, index=False)
    with open(meta_path, "w") as f:
        json.dump({"manifest": str(manifest_path), "config": cfg}, f, indent=2)
    _stage(dev, stages, "write_s", t0)
    print(f"Saved embeddings to {emb_path}")
    return {"path": emb_path, "cached": False, "stages": stages}


if __name__ == "__main__":
    main()
