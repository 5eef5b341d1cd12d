"""YAML / pickle IO helpers (own copy of ``pd_fusion/utils/io.py``).

``load_yaml`` keeps ``yaml.UnsafeLoader`` so results files that embed
numpy scalars read back; the writers cast numpy scalars and tensors to
plain Python values first, so the port's own artifacts load with safe
loaders too.
"""
import pickle
from pathlib import Path
from typing import Any, Dict

import numpy as np
import yaml


def _to_plain(obj: Any) -> Any:
    """Recursively convert numpy scalars/arrays (and tensors) to plain Python types."""
    if isinstance(obj, dict):
        return {_to_plain(k): _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        return _to_plain(obj.tolist())
    if hasattr(obj, "detach") and hasattr(obj, "cpu"):  # torch.Tensor
        return _to_plain(obj.detach().cpu().numpy())
    if isinstance(obj, Path):
        return str(obj)
    return obj


def load_yaml(path: Path) -> Dict[str, Any]:
    with open(path, "r") as f:
        return yaml.load(f, Loader=yaml.UnsafeLoader)


# _to_plain guarantees pure-Python trees, so the libyaml C emitter is safe
_DUMPER = getattr(yaml, "CSafeDumper", yaml.SafeDumper)


def save_yaml(data: Dict[str, Any], path: Path):
    with open(path, "w") as f:
        yaml.dump(_to_plain(data), f, default_flow_style=False, Dumper=_DUMPER)


def save_pickle(obj: Any, path: Path):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path: Path) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)
