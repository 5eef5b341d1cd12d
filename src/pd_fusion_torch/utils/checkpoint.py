"""Training-state checkpoints (port of ``pd_fusion/utils/checkpoint.py``).

A checkpoint directory holds ``step_<n>.pt`` files and a ``LATEST`` marker
naming the newest step, as in the JAX package. The JAX package saves
through orbax with a pickle fallback; the port has no orbax and pickles
no objects: the state is a tree of dicts, lists, numbers and tensors,
saved with ``torch.save`` after every tensor is copied to the CPU, and
read back with ``torch.load(..., weights_only=True)``.
"""
from pathlib import Path
from typing import Any, Optional

import torch


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_checkpoint(path, state: Any, step: int = 0):
    """Save a training state tree under directory ``path`` as step ``step``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f"step_{step}.pt.tmp"
    torch.save(_to_cpu(state), tmp)
    tmp.replace(path / f"step_{step}.pt")
    (path / "LATEST").write_text(str(step))


def latest_step(path) -> Optional[int]:
    marker = Path(path) / "LATEST"
    if not marker.exists():
        return None
    try:
        return int(marker.read_text().strip())
    except ValueError:
        return None


def load_checkpoint(path, step: Optional[int] = None) -> Optional[Any]:
    """The state saved at ``step`` (default: the latest) as CPU tensors, or
    None when there is none."""
    path = Path(path)
    if step is None:
        step = latest_step(path)
    if step is None:
        return None
    f = path / f"step_{step}.pt"
    if not f.exists():
        return None
    return torch.load(f, map_location="cpu", weights_only=True)
