"""Training dispatch (port of ``pd_fusion/training/train.py``: parameter
resolution and the MIL branch of ``train_pipeline``).

Returns ``(model, prep_info)``; for the MIL family prep_info is
``("mil", mil_col)``. Other families raise ``NotImplementedError``
(ROADMAP Queue 1).
"""
import logging
from pathlib import Path

import numpy as np

from pd_fusion_torch.data.schema import TARGET_COL
from pd_fusion_torch.paths import ROOT_DIR
from pd_fusion_torch.utils.io import load_yaml


def _load_default_params(path_str: str):
    p = Path(path_str)
    if not p.exists():
        p = ROOT_DIR / p
    try:
        return load_yaml(p).get("params", {})
    except Exception:
        return {}


def _resolve_params(config, model_type):
    """Missing params fall back to the sibling model config file, as in
    the JAX package (the MIL family takes its params as given)."""
    if "params" not in config or not isinstance(config.get("params"), dict):
        config["params"] = {}
    if model_type in ("fusion_late", "fusion_masked", "fusion_moddrop", "unimodal_mlp"):
        if "hidden_dims" not in config["params"]:
            config["params"] = {**_load_default_params("configs/model_fusion.yaml"), **config["params"]}
    elif model_type == "moe":
        if "expert_hidden_dims" not in config["params"]:
            config["params"] = {**_load_default_params("configs/model_moe.yaml"), **config["params"]}
    elif model_type == "unimodal_gbdt":
        if not config["params"]:
            config["params"] = {**_load_default_params("configs/model_unimodal.yaml"), **config["params"]}


def _maybe_calibrate(config, model, X_val, y_val, masks_val, logger):
    if not config.get("calibrate", False):
        return model
    from pd_fusion_torch.models.calibrate import CalibratedModel

    cal = CalibratedModel(model, method="isotonic")
    try:
        cal.fit(X_val, y_val, masks_val)
        return cal
    except Exception as e:  # pragma: no cover
        logger.warning(f"Calibration failed; using uncalibrated model: {e}")
        return model


def train_pipeline(config, df_train, df_val, mask_train, mask_val):
    logger = logging.getLogger("pd_fusion")
    model_type = config["model_type"]
    _resolve_params(config, model_type)
    if model_type != "mil_attention":
        raise NotImplementedError(
            f"model_type '{model_type}' is not ported to pd_fusion_torch yet (ROADMAP Queue 1)"
        )

    y_train = df_train[TARGET_COL].values
    y_val = df_val[TARGET_COL].values
    mil_col = config.get("mil_column", "mri_mil")
    if mil_col not in df_train.columns:
        raise ValueError(f"MIL column '{mil_col}' not found in training data.")
    X_train_bags = df_train[mil_col].tolist()
    X_val_bags = df_val[mil_col].tolist()
    if not X_train_bags:
        raise ValueError("No MIL bags found for training.")
    from pd_fusion_torch.models.mil_attention import MilAttentionModel

    input_dim = int(np.asarray(X_train_bags[0]).shape[1])
    model = MilAttentionModel(input_dim, config["params"])
    model.train(X_train_bags, y_train, (X_val_bags, y_val))
    model = _maybe_calibrate(config, model, X_val_bags, y_val, mask_val, logger)
    return model, ("mil", mil_col)
