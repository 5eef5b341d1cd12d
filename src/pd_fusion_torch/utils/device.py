"""Device selection (port of ``pd_fusion/utils/device.py:14-26``).

The port runs on the CUDA device. ``get_device`` returns ``cuda`` unless
the caller passes ``device="cpu"`` (or any other torch device string) or
sets ``PD_FUSION_TORCH_DEVICE``; with no CUDA device and no such request
it raises rather than carry on silently on the CPU. Under torchrun
(``parallel/distributed.py``, one process per card) the card is the
rank's own, ``cuda:{LOCAL_RANK % device_count}``.

``make_data_mesh`` and ``shard_rows`` are the counterparts of the JAX
package's ``make_data_mesh`` and ``batch_sharding``
(``pd_fusion/utils/device.py:28-44``): a data axis over every rank, and
this rank's contiguous rows of a batch. ``replicated_sharding`` has none:
every rank builds the same parameters from the same seed or file.

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
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        # under torchrun: the rank's own card
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                           % max(torch.cuda.device_count(), 1))
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def make_data_mesh():
    """A one-axis ("data",) mesh over every rank of the process group
    (``None`` without one, or with one rank)."""
    from pd_fusion_torch.parallel import distributed

    n = distributed.world_size()
    if n <= 1:
        return None
    return distributed.fold_data_mesh(1, n, get_device().type)


def shard_rows(x, mesh):
    """This rank's contiguous rows of ``x`` (a tensor, an array or a list) on
    the mesh's data axis (``x`` whole without a mesh)."""
    if mesh is None:
        return x
    from pd_fusion_torch.parallel.distributed import local_slice

    return x[local_slice(len(x), mesh.data, mesh.data_index)]
