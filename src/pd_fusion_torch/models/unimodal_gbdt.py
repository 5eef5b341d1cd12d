"""Unimodal gradient-boosted trees (port of
``pd_fusion/models/unimodal_gbdt.py``).

The backend resolves via ``nn.gbdt.resolve_gbdt_backend``: ``backend:
auto`` (the default) trains ``nn.gbdt.DeviceHistGBDT`` when the port's
device is CUDA and scikit-learn's ``HistGradientBoostingClassifier`` on
the CPU; ``backend: device``/``host`` or PD_FUSION_GBDT_BACKEND force
either. The host backend is imported when it is chosen: where
scikit-learn is missing (the card's machine) it raises an ImportError
that says so, and never falls back to the other backend.
"""
import numpy as np

from pd_fusion_torch.models.base import BaseModel
from pd_fusion_torch.nn.gbdt import DeviceHistGBDT, bin_features, resolve_gbdt_backend
from pd_fusion_torch.utils.io import load_pickle, save_pickle


def _translate_params_histgb(params):
    """Map the lgbm-style config params onto HistGradientBoosting."""
    out = {}
    if "n_estimators" in params:
        out["max_iter"] = int(params["n_estimators"])
    if "learning_rate" in params:
        out["learning_rate"] = float(params["learning_rate"])
    if "max_depth" in params:
        out["max_depth"] = int(params["max_depth"])
    if "random_state" in params:
        out["random_state"] = int(params["random_state"])
    return out


_DEVICE_PARAM_KEYS = (
    "n_estimators",
    "learning_rate",
    "max_depth",
    "num_leaves",
    "reg_lambda",
    "min_child_samples",
    "min_child_weight",
    "random_state",
    "hist_mode",
)


def _host_classifier(params):
    try:
        from sklearn.ensemble import HistGradientBoostingClassifier
    except ImportError as e:
        raise ImportError(
            "unimodal_gbdt's host backend is scikit-learn's HistGradientBoostingClassifier, "
            "and scikit-learn is not installed here; use backend: device (or auto on a "
            "CUDA device)"
        ) from e
    return HistGradientBoostingClassifier(**_translate_params_histgb(params))


class UnimodalGBDT(BaseModel):
    def __init__(self, mod_name, params=None):
        self.mod_name = mod_name
        self.params = dict(params or {})
        if resolve_gbdt_backend(self.params.pop("backend", None)) == "device":
            self.backend = "device"
            self.model = DeviceHistGBDT(
                **{k: v for k, v in self.params.items() if k in _DEVICE_PARAM_KEYS}
            )
        else:
            self.backend = "histgb"
            self.model = _host_classifier(self.params)

    def train(self, X, y, val_data=None):
        self.model.fit(X, y)

    def predict_proba(self, X, masks=None):
        return self.model.predict_proba(X)[:, 1]

    def prepare_eval_bins(self, X):
        """Device-backend hook for the fused scenario evaluation
        (evaluation/evaluate.py::_eval_scenarios_fused_gbdt): the
        scenario-zeroed matrix -> int32 bin codes under the fitted edges."""
        return bin_features(np.asarray(X, np.float32), self.model.edges_)

    def save(self, path):
        save_pickle(self, path)

    @classmethod
    def load(cls, path):
        return load_pickle(path)
