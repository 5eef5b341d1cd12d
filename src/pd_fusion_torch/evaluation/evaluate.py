"""Scenario evaluation (port of ``pd_fusion/evaluation/evaluate.py``).

For each scenario, transform the availability masks (missingness
engine), prepare the family's inputs (the flat matrix with the dropped
modality blocks zeroed, plus the mask matrix for ``fusion_masked``; None
for the bags whose mri modality is dropped), predict, and compute the six
metrics; with a group column, subject-level aggregation (group mean of
y_prob, first y_true) adds ``subject_*`` metrics.

Flat-matrix MLP models evaluate every scenario at once: one stacked
[S, N, F'] forward and one metrics pass whose results and probabilities
come back in one packed buffer (``_eval_scenarios_fused``), when there is
more than one scenario, both classes are present and the model's own
class has ``prepare_eval_matrix``. Calibrated and conformal wrappers take
the per-scenario loop. ``compute_risk_coverage`` sorts by confidence and
accumulates error vs coverage. MoE inputs raise ``NotImplementedError``
(ROADMAP Queue 1 item 8).
"""
from typing import Dict

import numpy as np
import pandas as pd
import torch

from pd_fusion_torch.data.feature_utils import apply_masks_to_matrix
from pd_fusion_torch.data.missingness import apply_missingness_scenario, get_modality_mask_matrix
from pd_fusion_torch.data.preprocess import preprocess_features
from pd_fusion_torch.data.schema import TARGET_COL
from pd_fusion_torch.ops import metrics as dev_metrics
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
    if is_moe_prep(prep_info):
        raise NotImplementedError(
            "MoE inputs are not ported to pd_fusion_torch yet (ROADMAP Queue 1 item 8)"
        )
    imputer, scaler, feature_cols = prep_info
    X, _, _ = preprocess_features(df, feature_cols, imputer, scaler)
    X = apply_masks_to_matrix(X, masks, feature_cols)
    if hasattr(model, "mask_dim"):
        return np.asarray(
            model.predict_proba(X, masks=get_modality_mask_matrix(masks))
        ).ravel()
    return np.asarray(model.predict_proba(X, masks=masks)).ravel()


def _subject_metrics(df, group_col, y_true, y_prob):
    tmp = pd.DataFrame({"group": df[group_col].values, "y_true": y_true, "y_prob": y_prob})
    y_true_g = tmp.groupby("group")["y_true"].first().values
    y_prob_g = tmp.groupby("group")["y_prob"].mean().values
    return compute_metrics(y_true_g, y_prob_g)


def _tiled_targets(y_true, n_scenarios, device):
    """[S, N] float32 labels + all-ones weights for the fused pass."""
    y = torch.as_tensor(np.tile(y_true.astype(np.float32), (n_scenarios, 1)), device=device)
    return y, torch.ones_like(y)


def _assemble_scenario_results(packed, scenarios, df_test, group_col, y_true):
    """Unpack the buffer, add subject-level metrics, key by scenario name."""
    md, probs = dev_metrics.unpack_metrics_and_probs(
        packed, (len(scenarios),), (len(scenarios), len(y_true))
    )
    results = {}
    for si, scenario in enumerate(scenarios):
        metrics = {k: float(v[si]) for k, v in md.items()}
        if group_col and group_col in df_test.columns:
            for k, v in _subject_metrics(df_test, group_col, y_true, probs[si]).items():
                metrics[f"subject_{k}"] = v
        results[scenario["name"]] = metrics
    return results


def _eval_scenarios_fused(model, df_test, mask_test, prep_info, scenarios, group_col, y_true):
    """All scenarios at once: stacked [S, N, F'] inputs -> one MLP forward
    -> the metrics of every scenario, packed with the probs."""
    from pd_fusion_torch.nn.trainer import predict_proba

    imputer, scaler, feature_cols = prep_info
    X_base, _, _ = preprocess_features(df_test, feature_cols, imputer, scaler)
    mats = []
    for scenario in scenarios:
        current_masks = apply_missingness_scenario(df_test, scenario, mask_test)
        X = apply_masks_to_matrix(X_base, current_masks, feature_cols)
        mats.append(model.prepare_eval_matrix(X, current_masks))
    dev = model.device
    probs = predict_proba(model.net_params, torch.as_tensor(np.stack(mats), device=dev))
    y, w = _tiled_targets(y_true, len(scenarios), dev)
    packed = dev_metrics.binary_metrics_packed(probs, y, w).cpu().numpy()
    return _assemble_scenario_results(packed, scenarios, df_test, group_col, y_true)


def evaluate_model(model, df_test, mask_test, prep_info, config) -> Dict[str, Dict[str, float]]:
    results = {}
    scenarios = config.get("scenarios", [{"name": "baseline", "drop_modalities": []}])
    group_col = config.get("group_col")
    y_true = df_test[TARGET_COL].values

    # the check is on the model's own CLASS: calibration/conformal wrappers
    # delegate attribute access to the wrapped model, but their predictions
    # must flow through the wrapper, so they take the per-scenario loop
    multi = len(scenarios) > 1 and np.unique(y_true).size >= 2
    if (multi and not is_mil_prep(prep_info) and not is_moe_prep(prep_info)
            and hasattr(type(model), "prepare_eval_matrix")):
        return _eval_scenarios_fused(
            model, df_test, mask_test, prep_info, scenarios, group_col, y_true
        )

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
