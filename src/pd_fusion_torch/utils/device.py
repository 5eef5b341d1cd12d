"""Device selection (port of ``pd_fusion/utils/device.py:14-26``).

The port runs on the CUDA device. ``get_device`` returns ``cuda`` unless
the caller passes ``device="cpu"`` (or any other torch device string) or
sets ``PD_FUSION_TORCH_DEVICE``; with no CUDA device and no such request
it raises rather than carry on silently on the CPU. No mesh: the port
targets one card.

Matmul precision is set here, once, for the CUDA device: float32 products
stay full float32 (``allow_tf32 = False`` for matmul and cuDNN), matching
the JAX package's float32 results to the tolerances its tests state.
"""
import os
from typing import Optional, Union

import torch

DEVICE_ENV = "PD_FUSION_TORCH_DEVICE"


def get_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    requested = device if device is not None else os.environ.get(DEVICE_ENV)
    if requested is not None:
        dev = torch.device(requested)
    elif torch.cuda.is_available():
        dev = torch.device("cuda")
    else:
        raise RuntimeError(
            "pd_fusion_torch runs on a CUDA device and none is available; pass "
            f"device='cpu' or set {DEVICE_ENV}=cpu to run on the CPU"
        )
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
