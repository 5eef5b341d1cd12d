"""Feature <-> modality column resolution and block masking (port of
``pd_fusion/data/feature_utils.py``).

Prefix-based resolution (``clinical_*``) with a canonical-schema
fallback; concatenation in fixed MODALITIES order; per-modality index
lists; masking zeroes the feature block of masked-out modalities through
a [n_features, n_modalities] one-hot assignment matrix. The host forms
are numpy; ``apply_modality_masks`` is the same masking as a torch
function, for use inside device programs.
"""
from typing import Dict, List

import numpy as np
import pandas as pd
import torch

from pd_fusion_torch.data.missingness import get_modality_mask_matrix
from pd_fusion_torch.data.schema import MODALITIES, MODALITY_FEATURES


def get_modality_feature_cols(df: pd.DataFrame, modality: str) -> List[str]:
    prefixed = [c for c in df.columns if c.startswith(f"{modality}_")]
    if prefixed:
        return prefixed
    return [c for c in MODALITY_FEATURES.get(modality, []) if c in df.columns]


def get_all_feature_cols(df: pd.DataFrame) -> List[str]:
    cols: List[str] = []
    for mod in MODALITIES:
        cols.extend(get_modality_feature_cols(df, mod))
    return cols


def get_feature_slices(feature_cols: List[str]) -> Dict[str, List[int]]:
    slices: Dict[str, List[int]] = {m: [] for m in MODALITIES}
    for i, col in enumerate(feature_cols):
        assigned = False
        for mod in MODALITIES:
            if col.startswith(f"{mod}_"):
                slices[mod].append(i)
                assigned = True
                break
        if assigned:
            continue
        for mod, feats in MODALITY_FEATURES.items():
            if col in feats:
                slices[mod].append(i)
                break
    return slices


def feature_modality_matrix(feature_cols: List[str]) -> np.ndarray:
    """[n_features, n_modalities] one-hot assignment (0 for unassigned
    columns means "never masked")."""
    slices = get_feature_slices(feature_cols)
    A = np.zeros((len(feature_cols), len(MODALITIES)), dtype=np.float32)
    for mi, mod in enumerate(MODALITIES):
        for i in slices[mod]:
            A[i, mi] = 1.0
    return A


def apply_modality_masks_np(X, mask_matrix, assign):
    """X: [N, F]; mask_matrix: [N, M] (1=present); assign: [F, M] one-hot.
    The keep-factor formula the CV engine and the moddrop model's eval
    prep share."""
    keep = 1.0 - assign @ (1.0 - mask_matrix.T)  # [F, N]
    return X * keep.T


def apply_modality_masks(X: torch.Tensor, mask_matrix: torch.Tensor,
                         assign: torch.Tensor) -> torch.Tensor:
    """X: [N, F]; mask_matrix: [N, M] (1=present); assign: [F, M] one-hot.

    Features of masked-out modalities are zeroed; unassigned features pass
    through unchanged.
    """
    keep = 1.0 - (assign[None, :, :] * (1.0 - mask_matrix[:, None, :])).sum(-1)
    return X * keep


def apply_masks_to_matrix(
    X: np.ndarray, masks: Dict[str, np.ndarray], feature_cols: List[str]
) -> np.ndarray:
    """Zero the feature blocks of the modalities ``masks`` marks absent."""
    assign = feature_modality_matrix(feature_cols)
    mm = get_modality_mask_matrix(masks).astype(np.float32)
    keep = 1.0 - (assign[None, :, :] * (1.0 - mm[:, None, :])).sum(-1)
    return np.asarray(X, np.float32) * keep
