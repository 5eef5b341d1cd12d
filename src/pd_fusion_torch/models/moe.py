"""MoE model wrapper (port of ``pd_fusion/models/moe.py``).

``train(X_dict, y, mask, val_data)`` takes per-modality preprocessed
inputs and an [N, M] mask; the validation tuple is accepted and ignored,
as in the JAX package. Compute runs through the stacked-expert program
of ``pd_fusion_torch.nn.moe`` on the port's device; the init generator
is drawn at construction.
"""
import numpy as np
import torch

from pd_fusion_torch.models.base import BaseModel
from pd_fusion_torch.nn.moe import (
    moe_init,
    moe_params_from_jax,
    moe_params_to_numpy,
    moe_predict,
    train_moe,
)
from pd_fusion_torch.utils.device import get_device
from pd_fusion_torch.utils.io import load_pickle, save_pickle
from pd_fusion_torch.utils.seed import fresh_generator


class MoEModel(BaseModel):
    kind = "moe"

    def __init__(self, modality_dims, params, device=None):
        self.params = params
        self.device = get_device(device)
        self.modality_dims = dict(modality_dims)
        self.mods = sorted(self.modality_dims.keys())
        self.f_max = max(self.modality_dims[m] for m in self.mods)
        self.net_params = moe_init(fresh_generator(), self.modality_dims,
                                   params["expert_hidden_dims"], params["router_hidden_dims"],
                                   device=self.device)

    def _stack_inputs(self, X_dict):
        """Per-modality matrices -> [M, N, Fmax], zero-padded (numpy)."""
        n = len(next(iter(X_dict.values())))
        x = np.zeros((len(self.mods), n, self.f_max), np.float32)
        for mi, mod in enumerate(self.mods):
            Xm = np.asarray(X_dict[mod], np.float32)
            x[mi, :, : Xm.shape[1]] = Xm
        return x

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def train(self, X_dict, y, mask, val_data=None):
        self.net_params = train_moe(
            self.net_params, self._t(self._stack_inputs(X_dict)), self._t(mask), self._t(y),
            float(self.params["lr"]), int(self.params["epochs"]),
            float(self.params.get("weight_decay", 0.0)),
        )

    def predict_proba(self, X_dict, mask=None):
        x_stack = self._stack_inputs(X_dict)
        if mask is None:
            mask = np.ones((x_stack.shape[1], len(self.mods)), np.float32)
        return moe_predict(self.net_params, self._t(x_stack), self._t(mask)).cpu().numpy()

    def save(self, path):
        save_pickle({"kind": self.kind, "modality_dims": self.modality_dims,
                     "params": self.params, "net_params": moe_params_to_numpy(self.net_params)},
                    path)

    @classmethod
    def load(cls, path, modality_dims=None, params=None, device=None):
        state = load_pickle(path)
        inst = cls(state["modality_dims"], state["params"], device=device)
        inst.net_params = moe_params_from_jax(state["net_params"], device=inst.device)
        return inst
