"""Training dispatch (port of ``pd_fusion/training/train.py``): parameter
resolution (missing params fall back to the sibling model config file),
per-family preprocessing and the optional isotonic calibration wrap.

Returns ``(model, prep_info)``; prep_info is what downstream code
dispatches on:
  tuple (imputer, scaler, feature_cols) -> flat-feature families
  dict  {mod: (imputer, scaler, feats)} -> MoE
  tuple ("mil", mil_col)                -> MIL families
``mil_attention_ft`` raises ``NotImplementedError`` naming its ROADMAP item.
"""
import logging
from pathlib import Path

import numpy as np

from pd_fusion_torch.data.feature_utils import get_all_feature_cols, get_modality_feature_cols
from pd_fusion_torch.data.missingness import get_modality_mask_matrix
from pd_fusion_torch.data.preprocess import preprocess_features
from pd_fusion_torch.data.schema import MODALITIES, TARGET_COL
from pd_fusion_torch.experiments.registry import check_ported
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
    the JAX package (the MIL families take their params as given)."""
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
    check_ported(model_type)
    _resolve_params(config, model_type)

    y_train = df_train[TARGET_COL].values
    y_val = df_val[TARGET_COL].values

    # --- MIL: bags of per-slice embeddings --------------------------------
    if model_type == "mil_attention":
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

    # --- flat-feature families --------------------------------------------
    all_features = get_all_feature_cols(df_train)
    if not all_features:
        raise ValueError(
            "No feature columns found for any modality. Check dataset loader and schema."
        )

    X_train, imputer, scaler = preprocess_features(df_train, all_features)
    X_val, _, _ = preprocess_features(df_val, all_features, imputer, scaler)

    prep_info = (imputer, scaler, all_features)
    calibrate_X_val = X_val
    calibrate_masks = None

    if model_type in ("unimodal_gbdt", "unimodal_mlp"):
        modality = config.get("modality", "clinical")
        mod_features = get_modality_feature_cols(df_train, modality)
        if not mod_features:
            logger.warning(
                f"Unimodal '{modality}' has no features in dataset; using constant baseline."
            )
            from pd_fusion_torch.models.dummy import ConstantProbabilityModel

            model = ConstantProbabilityModel()
            model.train(np.zeros((len(y_train), 1)), y_train, None)
            prep_info = (None, None, mod_features)
            calibrate_X_val = np.zeros((len(y_val), 1))
        else:
            # the scaler is fitted on the modality's own columns
            X_tr_mod, imp, scl = preprocess_features(df_train, mod_features)
            X_va_mod, _, _ = preprocess_features(df_val, mod_features, imp, scl)
            if model_type == "unimodal_gbdt":
                from pd_fusion_torch.models.unimodal_gbdt import UnimodalGBDT

                model = UnimodalGBDT(modality, config["params"])
            else:
                from pd_fusion_torch.models.fusion_late import LateFusionModel

                model = LateFusionModel(len(mod_features), config["params"])
            model.train(X_tr_mod, y_train, (X_va_mod, y_val))
            prep_info = (imp, scl, mod_features)
            calibrate_X_val = X_va_mod

    elif model_type == "fusion_late":
        from pd_fusion_torch.models.fusion_late import LateFusionModel

        model = LateFusionModel(len(all_features), config["params"])
        model.train(X_train, y_train, (X_val, y_val))

    elif model_type == "fusion_masked":
        from pd_fusion_torch.models.fusion_masked import MaskedFusionModel

        train_mm = get_modality_mask_matrix(mask_train)
        val_mm = get_modality_mask_matrix(mask_val)
        X_tr = np.concatenate([X_train, train_mm], axis=1)
        X_va = np.concatenate([X_val, val_mm], axis=1)
        model = MaskedFusionModel(len(all_features), train_mm.shape[1], config["params"])
        model.train(X_tr, y_train, (X_va, y_val))
        calibrate_X_val = X_va

    elif model_type == "fusion_moddrop":
        from pd_fusion_torch.models.fusion_moddrop import ModalityDropoutModel

        mod_dims = {m: len(get_modality_feature_cols(df_train, m)) for m in MODALITIES}
        model = ModalityDropoutModel(mod_dims, config["params"])
        model.train(X_train, y_train, (X_val, y_val))
        calibrate_masks = mask_val

    elif model_type == "moe":
        from pd_fusion_torch.models.moe import MoEModel

        # per-modality imputer and scaler; a modality without features is
        # left out, and the routing masks are the natural ones
        moe_dims, X_tr_dict, X_va_dict, moe_prep = {}, {}, {}, {}
        for mod in MODALITIES:
            feats = get_modality_feature_cols(df_train, mod)
            if not feats:
                continue
            X_tr_dict[mod], imp_m, scl_m = preprocess_features(df_train, feats)
            X_va_dict[mod], _, _ = preprocess_features(df_val, feats, imp_m, scl_m)
            moe_dims[mod] = len(feats)
            moe_prep[mod] = (imp_m, scl_m, feats)
        mask_tr = np.stack([mask_train[m] for m in moe_dims], axis=1).astype(np.float32)
        mask_va = np.stack([mask_val[m] for m in moe_dims], axis=1).astype(np.float32)
        model = MoEModel(moe_dims, config["params"])
        model.train(X_tr_dict, y_train, mask_tr, (X_va_dict, y_val, mask_va))
        prep_info = moe_prep
        calibrate_X_val = X_va_dict
        calibrate_masks = mask_va

    else:
        raise ValueError(f"Unknown model type: {model_type}")

    model = _maybe_calibrate(config, model, calibrate_X_val, y_val, calibrate_masks, logger)
    return model, prep_info
