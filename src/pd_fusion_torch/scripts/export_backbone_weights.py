"""Export a torchvision ResNet state_dict to ``.npz`` for the port's backbone
(port of ``scripts/export_backbone_weights.py``, same flags):

    python -m pd_fusion_torch.scripts.export_backbone_weights --out W.npz
        [--arch resnet18|resnet50] [--src state_dict.pth]

Point ``weights_path:`` at the ``.npz`` in a ``resnet2d_config`` or the
``mil_attention_ft`` params. With ``--src`` the state_dict is read from
that ``.pth``; without it the ImageNet weights come from torchvision,
which is installed on neither machine: the script then raises with that
message. The written arrays are converted once more through
``nn/resnet.py::convert_torch_state_dict`` as a round-trip check.
"""
import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Export torch resnet weights to npz")
    parser.add_argument("--arch", default="resnet18", choices=["resnet18", "resnet50"])
    parser.add_argument("--src", default=None,
                        help="Optional .pth state_dict; default: torchvision pretrained")
    parser.add_argument("--out", required=True, help="Output .npz path")
    args = parser.parse_args(argv)

    if args.src:
        import torch

        sd = torch.load(args.src, map_location="cpu", weights_only=True)
    else:
        try:
            from torchvision.models import (
                ResNet18_Weights, ResNet50_Weights, resnet18, resnet50,
            )
        except ImportError as exc:
            raise SystemExit(
                "export_backbone_weights: torchvision is not installed; pass --src with a "
                f"saved state_dict (.pth) instead ({exc})") from exc
        model = (
            resnet50(weights=ResNet50_Weights.DEFAULT)
            if args.arch == "resnet50"
            else resnet18(weights=ResNet18_Weights.DEFAULT)
        )
        sd = model.state_dict()

    arrays = {}
    for k, v in sd.items():
        if k.startswith("fc."):
            continue  # classification head is never used (fc=Identity)
        arrays[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    np.savez_compressed(args.out, **arrays)
    print(f"Exported {len(arrays)} tensors -> {args.out}")

    # round-trip: the written arrays must convert into the port's tree
    from pd_fusion_torch.nn.resnet import convert_torch_state_dict

    data = np.load(args.out)
    convert_torch_state_dict({k: data[k] for k in data.files}, args.arch)
    print("Conversion check OK")


if __name__ == "__main__":
    main()
