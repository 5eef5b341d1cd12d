"""Host-facing metric API (port of ``pd_fusion/utils/metrics.py``).

``compute_metrics`` keeps the JAX package's signature and return dict;
the computation is ``ops.metrics.binary_metrics`` on the port's device.
Returns plain Python floats so results.yaml serialization is clean.
"""
from typing import Dict

import numpy as np
import torch

from pd_fusion_torch.ops import metrics as dev_metrics
from pd_fusion_torch.utils.device import get_device


def compute_metrics(y_true, y_prob, threshold: float = 0.5) -> Dict[str, float]:
    y_true = np.asarray(y_true)
    y_prob = np.asarray(y_prob, dtype=np.float32)
    if np.unique(y_true[~np.isnan(y_prob)]).size < 2:
        # sklearn raises here; keep an explicit error for parity
        raise ValueError("compute_metrics requires both classes present in y_true")
    dev = get_device()
    out = dev_metrics.binary_metrics(
        torch.tensor(y_true, dtype=torch.float32, device=dev),
        torch.tensor(y_prob, device=dev),  # a copy: y_prob may be a read-only view
        None,
        threshold,
    )
    packed = torch.stack([out[k] for k in dev_metrics.METRIC_NAMES]).cpu().numpy()
    return {k: float(v) for k, v in zip(dev_metrics.METRIC_NAMES, packed)}
