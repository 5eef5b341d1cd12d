"""Scenario evaluation (port of ``pd_fusion/evaluation/evaluate.py``, MIL
branch).

For each scenario, transform the availability masks (missingness
engine), None out the bags whose mri modality is dropped, predict, and
compute the six metrics; with a group column, subject-level aggregation
(group mean of y_prob, first y_true) adds ``subject_*`` metrics.
``compute_risk_coverage`` sorts by confidence and accumulates error vs
coverage. Flat-feature and MoE inputs raise ``NotImplementedError``
(ROADMAP Queue 1 items 5 and 8).
"""
from typing import Dict

import numpy as np
import pandas as pd
import torch

from pd_fusion_torch.data.missingness import apply_missingness_scenario
from pd_fusion_torch.data.schema import TARGET_COL
from pd_fusion_torch.ops.metrics import risk_coverage as _risk_coverage_dev
from pd_fusion_torch.utils.device import get_device
from pd_fusion_torch.utils.metrics import compute_metrics


def is_mil_prep(prep_info) -> bool:
    return isinstance(prep_info, tuple) and len(prep_info) >= 2 and prep_info[0] == "mil"


def is_moe_prep(prep_info) -> bool:
    return isinstance(prep_info, dict)


def predict_for_masks(model, df, masks: Dict[str, np.ndarray], prep_info) -> np.ndarray:
    """Prepare family-specific inputs under the given masks and predict."""
    if is_mil_prep(prep_info):
        mil_col = prep_info[1]
        bags = df[mil_col].tolist()
        if "mri" in masks:
            bags = [bag if m == 1 else None for bag, m in zip(bags, masks["mri"])]
        return np.asarray(model.predict_proba(bags, masks=masks)).ravel()
    raise NotImplementedError(
        "only MIL inputs are ported to pd_fusion_torch yet (flat features: ROADMAP "
        "Queue 1 item 5; MoE: item 8)"
    )


def _subject_metrics(df, group_col, y_true, y_prob):
    tmp = pd.DataFrame({"group": df[group_col].values, "y_true": y_true, "y_prob": y_prob})
    y_true_g = tmp.groupby("group")["y_true"].first().values
    y_prob_g = tmp.groupby("group")["y_prob"].mean().values
    return compute_metrics(y_true_g, y_prob_g)


def evaluate_model(model, df_test, mask_test, prep_info, config) -> Dict[str, Dict[str, float]]:
    results = {}
    scenarios = config.get("scenarios", [{"name": "baseline", "drop_modalities": []}])
    group_col = config.get("group_col")
    y_true = df_test[TARGET_COL].values

    for scenario in scenarios:
        current_masks = apply_missingness_scenario(df_test, scenario, mask_test)
        y_prob = predict_for_masks(model, df_test, current_masks, prep_info)
        metrics = compute_metrics(y_true, y_prob)
        if group_col and group_col in df_test.columns:
            for k, v in _subject_metrics(df_test, group_col, y_true, y_prob).items():
                metrics[f"subject_{k}"] = v
        results[scenario["name"]] = metrics
    return results


def predict_proba_for_scenario(model, df_test, mask_test, prep_info, scenario):
    """(y_true, y_prob) for one scenario — used for fold-prediction CSVs."""
    current_masks = apply_missingness_scenario(df_test, scenario, mask_test)
    y_true = df_test[TARGET_COL].values
    return y_true, predict_for_masks(model, df_test, current_masks, prep_info)


def compute_risk_coverage(y_true, y_prob, masks=None) -> Dict[str, np.ndarray]:
    dev = get_device()
    out = _risk_coverage_dev(
        torch.as_tensor(np.asarray(y_true, np.float32), device=dev),
        torch.as_tensor(np.asarray(y_prob, np.float32), device=dev),
    ).cpu().numpy()
    return {"coverage": out[0], "risk": out[1]}
