"""Build per-slice (MIL-bag) ResNet2D embeddings for a manifest (port of
``scripts/build_resnet2d_mil_embeddings.py``, same flags):

    python -m pd_fusion_torch.scripts.build_resnet2d_mil_embeddings --manifest <csv>

Keeps [n_slices, emb_dim] per subject, slices one or several axes, and
writes the ``.npz`` {embeddings, subject_id, session, label} and its meta
JSON under the content-addressed name that a data config with the same
settings looks up, in either package. The embed runs on the card unless
``PD_FUSION_TORCH_DEVICE`` names another device.
"""
import argparse
from pathlib import Path


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Build ResNet2D MIL embeddings for ds001907")
    parser.add_argument("--manifest", type=str, required=True)
    parser.add_argument(
        "--out-dir", type=str, default="data/processed/openneuro_ds001907/embeddings_resnet2d"
    )
    parser.add_argument("--backbone", type=str, default="resnet50")
    parser.add_argument("--target-shape", type=int, nargs=3, default=[160, 160, 160])
    parser.add_argument("--slice-axis", type=int, default=2)
    parser.add_argument("--slice-axes", type=int, nargs="+", default=None)
    parser.add_argument("--slice-count", type=int, default=48)
    parser.add_argument("--slice-counts", type=int, nargs="+", default=None)
    parser.add_argument("--input-size", type=int, default=224)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--tta", type=int, default=1)
    parser.add_argument("--max-rotation-deg", type=float, default=5.0)
    parser.add_argument("--max-translation", type=float, default=0.05)
    parser.add_argument("--intensity-scale", type=float, default=0.1)
    parser.add_argument("--intensity-shift", type=float, default=0.1)
    parser.add_argument("--noise-std", type=float, default=0.01)
    parser.add_argument("--weights-path", type=str, default=None)
    return parser.parse_args(argv)


def config_from_args(args) -> dict:
    """The embedding config, and so the cache key. ``target_shape`` is a
    list, as a YAML data config gives it, so that the loader of a config
    with these settings finds the artifact; the JAX package's script keys
    it as a tuple, under a name no config's loader looks for."""
    axes = args.slice_axes if args.slice_axes else [args.slice_axis]
    if args.slice_counts:
        if len(args.slice_counts) != len(axes):
            raise ValueError("slice-counts must match length of slice-axes")
        counts = args.slice_counts
    else:
        counts = [args.slice_count] * len(axes)

    config = {
        "backbone": args.backbone,
        "target_shape": list(args.target_shape),
        "input_size": args.input_size,
        "batch_size": args.batch_size,
        "tta": args.tta,
        "max_rotation_deg": args.max_rotation_deg,
        "max_translation": args.max_translation,
        "intensity_scale": args.intensity_scale,
        "intensity_shift": args.intensity_shift,
        "noise_std": args.noise_std,
    }
    if len(axes) == 1:
        config["slice_axis"] = axes[0]
        config["slice_count"] = counts[0]
    else:
        config["slice_axes"] = axes
        config["slice_counts"] = counts
    if args.weights_path:
        config["weights_path"] = args.weights_path
    return config


def main(argv=None):
    from pd_fusion_torch.data.openneuro_features import build_resnet2d_mil_embeddings

    args = parse_args(argv)
    out_path = build_resnet2d_mil_embeddings(Path(args.manifest), Path(args.out_dir),
                                             config_from_args(args))
    print(f"Saved MIL embeddings to {out_path}")
    return out_path


if __name__ == "__main__":
    main()
