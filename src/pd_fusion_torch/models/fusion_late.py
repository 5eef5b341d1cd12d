"""Late-fusion MLP over concatenated modality features (port of
``pd_fusion/models/fusion_late.py``): full-batch Adam + BCE for
``epochs`` steps, no minibatching, no early stopping. The same class is
the ``unimodal_mlp`` backbone. Weights live on the port's device
(``utils/device.py``); the init generator is drawn at construction, the
training generator in ``train``.
"""
import numpy as np
import torch

from pd_fusion_torch.models.base import BaseModel
from pd_fusion_torch.nn.mlp import mlp_init, mlp_params_from_jax, mlp_params_to_numpy
from pd_fusion_torch.nn.trainer import predict_proba, train_fullbatch
from pd_fusion_torch.utils.device import get_device
from pd_fusion_torch.utils.io import load_pickle, save_pickle
from pd_fusion_torch.utils.seed import fresh_generator


class LateFusionModel(BaseModel):
    kind = "fusion_late"

    def __init__(self, input_dim, params, device=None):
        self.params = params
        self.device = get_device(device)
        self.input_dim = int(input_dim)
        dims = [self.input_dim, *params["hidden_dims"], 1]
        self.net_params = mlp_init(fresh_generator(), dims, device=self.device)

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def train(self, X, y, val_data=None):
        self.net_params = train_fullbatch(
            self.net_params, self._t(X), self._t(y), None, fresh_generator(self.device),
            float(self.params["lr"]), int(self.params["epochs"]),
            float(self.params.get("dropout", 0.2)), float(self.params.get("weight_decay", 0.0)),
        )

    def predict_proba(self, X, masks=None):
        return predict_proba(self.net_params, self._t(X)).cpu().numpy()

    def prepare_eval_matrix(self, X, masks=None):
        """The matrix fed to the MLP under the given availability masks, so
        that ``evaluate_model`` can stack every scenario into one forward."""
        return np.asarray(X, np.float32)

    def _state(self):
        return {"kind": self.kind, "input_dim": self.input_dim, "params": self.params,
                "net_params": mlp_params_to_numpy(self.net_params)}

    def save(self, path):
        save_pickle(self._state(), path)

    @classmethod
    def _from_state(cls, state, device=None):
        return cls(state["input_dim"], state["params"], device=device)

    @classmethod
    def load(cls, path, input_dim=None, params=None, device=None):
        state = load_pickle(path)
        inst = cls._from_state(state, device=device)
        inst.net_params = mlp_params_from_jax(state["net_params"], device=inst.device)
        return inst
