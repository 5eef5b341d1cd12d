"""Missingness scenario engine — the product's core "fault injection".

Own copy of ``pd_fusion/data/missingness.py`` (the port imports nothing
of the JAX package):
- ``apply_missingness_scenario``: ``drop_modalities`` drops each listed
  modality entirely, or per-sample with ``drop_rate``; ``type: "random"``
  drops k of the *available* modalities per subject;
- ``get_modality_mask_matrix``: [N, M] matrix in fixed MODALITIES order.

RNG parity: random draws use the numpy global RNG in the same call order
as the JAX package (np.random.rand per modality for drop_rate; per-subject
np.random.choice for random scenarios), so with identical seeds the
scenario masks are bit-identical to a JAX run's.
"""
import logging
from typing import Dict

import numpy as np
import pandas as pd

from pd_fusion_torch.data.schema import MODALITIES


def apply_missingness_scenario(
    df: pd.DataFrame, scenario: Dict, maskdict: Dict[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    logger = logging.getLogger("pd_fusion")
    new_masks = {k: v.copy() for k, v in maskdict.items()}

    if "drop_modalities" in scenario:
        for mod in scenario["drop_modalities"]:
            if mod not in new_masks:
                logger.info(
                    f"[missingness] scenario '{scenario.get('name', 'unnamed')}': "
                    f"modality '{mod}' not found in masks; no-op."
                )
                continue
            if np.all(new_masks[mod] == 0):
                logger.info(
                    f"[missingness] scenario '{scenario.get('name', 'unnamed')}': "
                    f"modality '{mod}' already absent; no-op."
                )
            if "drop_rate" in scenario:
                rate = float(scenario.get("drop_rate", 0.0))
                if rate <= 0:
                    continue
                drop = np.random.rand(len(new_masks[mod])) < rate
                new_masks[mod][drop] = 0
            else:
                new_masks[mod] = np.zeros_like(new_masks[mod])

    if scenario.get("type") == "random":
        n_drop = scenario.get("n_drop", 1)
        modalities = list(new_masks.keys()) if new_masks else MODALITIES
        for i in range(len(df)):
            available = [m for m in modalities if m in new_masks and new_masks[m][i] == 1]
            if not available:
                continue
            choices = np.random.choice(available, size=min(n_drop, len(available)), replace=False)
            for mod in choices:
                new_masks[mod][i] = 0

    return new_masks


def get_modality_mask_matrix(maskdict: Dict[str, np.ndarray]) -> np.ndarray:
    if not maskdict:
        raise ValueError("maskdict is empty")
    template = next(iter(maskdict.values()))
    cols = [
        maskdict[m] if m in maskdict else np.zeros_like(template) for m in MODALITIES
    ]
    return np.stack(cols, axis=1)
