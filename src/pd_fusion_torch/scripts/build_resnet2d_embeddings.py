"""Build mean-pooled ResNet2D slice embeddings for a manifest (port of
``scripts/build_resnet2d_embeddings.py``, same flags):

    python -m pd_fusion_torch.scripts.build_resnet2d_embeddings --manifest <csv>

A thin CLI over ``pd_fusion_torch.data.openneuro_features.
build_resnet2d_embeddings``; the embed runs on the card unless
``PD_FUSION_TORCH_DEVICE`` names another device.
"""
import argparse
from pathlib import Path


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Build ResNet2D embeddings for ds001907")
    parser.add_argument("--manifest", type=str, required=True)
    parser.add_argument(
        "--out-dir", type=str, default="data/processed/openneuro_ds001907/embeddings_resnet2d"
    )
    parser.add_argument("--backbone", type=str, default="resnet18")
    parser.add_argument("--target-shape", type=int, nargs=3, default=[160, 160, 160])
    parser.add_argument("--slice-axis", type=int, default=2)
    parser.add_argument("--slice-count", type=int, default=24)
    parser.add_argument("--input-size", type=int, default=224)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--tta", type=int, default=1)
    parser.add_argument("--max-rotation-deg", type=float, default=5.0)
    parser.add_argument("--max-translation", type=float, default=0.05)
    parser.add_argument("--intensity-scale", type=float, default=0.1)
    parser.add_argument("--intensity-shift", type=float, default=0.1)
    parser.add_argument("--noise-std", type=float, default=0.01)
    parser.add_argument("--weights-path", type=str, default=None,
                        help="Optional torchvision .pth / exported .npz backbone weights")
    return parser.parse_args(argv)


def config_from_args(args) -> dict:
    """The embedding config, and so the cache key. ``target_shape`` is a
    list, as a YAML data config gives it, so that the loader of a config
    with these settings finds the artifact; the JAX package's script keys
    it as a tuple, under a name no config's loader looks for."""
    config = {
        "backbone": args.backbone,
        "target_shape": list(args.target_shape),
        "slice_axis": args.slice_axis,
        "slice_count": args.slice_count,
        "input_size": args.input_size,
        "batch_size": args.batch_size,
        "tta": args.tta,
        "max_rotation_deg": args.max_rotation_deg,
        "max_translation": args.max_translation,
        "intensity_scale": args.intensity_scale,
        "intensity_shift": args.intensity_shift,
        "noise_std": args.noise_std,
    }
    if args.weights_path:
        config["weights_path"] = args.weights_path
    return config


def main(argv=None):
    from pd_fusion_torch.data.openneuro_features import build_resnet2d_embeddings
    from pd_fusion_torch.parallel import distributed

    args = parse_args(argv)
    with distributed.process_group(host=True):
        df = build_resnet2d_embeddings(Path(args.manifest), Path(args.out_dir),
                                       config_from_args(args))
    print(f"Built {len(df)} subject embeddings -> {args.out_dir}")
    return df


if __name__ == "__main__":
    main()
