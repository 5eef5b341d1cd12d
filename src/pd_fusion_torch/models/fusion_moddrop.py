"""Fusion-ModDrop, the flagship tabular model (port of
``pd_fusion/models/fusion_moddrop.py``).

- features are the concatenation of modality blocks; block boundaries
  come from ``modality_dims`` in sorted-name order;
- training: minibatch Adam; per batch each modality is dropped whole with
  probability ``moddrop_rate``, one draw per modality shared by the batch,
  or one per sample and modality with ``moddrop_per_sample: true``
  (``nn/trainer.minibatch_moddrop_impl``);
- inference: the availability masks zero the missing modality blocks.
"""
import numpy as np
import torch

from pd_fusion_torch.data.feature_utils import apply_modality_masks_np
from pd_fusion_torch.models.base import BaseModel
from pd_fusion_torch.nn.mlp import mlp_init, mlp_params_from_jax, mlp_params_to_numpy
from pd_fusion_torch.nn.trainer import predict_proba, train_minibatch_moddrop
from pd_fusion_torch.utils.device import get_device
from pd_fusion_torch.utils.io import load_pickle, save_pickle
from pd_fusion_torch.utils.seed import fresh_generator


def _assignment_matrix(modality_dims):
    """[F, M] one-hot feature->modality map for the sorted-name block
    layout (the three modality names sort into MODALITIES order, which
    is the concatenation order of ``get_all_feature_cols``)."""
    mods = sorted(modality_dims.keys())
    F = sum(modality_dims.values())
    A = np.zeros((F, len(mods)), dtype=np.float32)
    start = 0
    for mi, mod in enumerate(mods):
        d = modality_dims[mod]
        A[start : start + d, mi] = 1.0
        start += d
    return A, mods


class ModalityDropoutModel(BaseModel):
    def __init__(self, modality_dims, params, device=None):
        self.params = params
        self.device = get_device(device)
        self.modality_dims = dict(modality_dims)
        self.assign, self.mod_names = _assignment_matrix(self.modality_dims)
        dims = [int(self.assign.shape[0]), *params["hidden_dims"], 1]
        self.net_params = mlp_init(fresh_generator(), dims, device=self.device)

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def train(self, X, y, val_data=None):
        n = len(X)
        batch_size = int(self.params.get("batch_size", 32))
        self.net_params = train_minibatch_moddrop(
            self.net_params, self._t(X), self._t(y), torch.ones(n, device=self.device),
            self._t(self.assign), fresh_generator(self.device),
            float(self.params["lr"]), int(self.params["epochs"]), min(batch_size, n),
            float(self.params.get("dropout", 0.2)), float(self.params.get("weight_decay", 0.0)),
            float(self.params.get("moddrop_rate", 0.2)),
            bool(self.params.get("moddrop_per_sample", False)),
        )

    def prepare_eval_matrix(self, X, masks=None):
        """Zero the feature blocks of the modalities ``masks`` marks absent."""
        X = np.asarray(X, np.float32)
        if masks is None:
            return X
        mask_mat = np.stack(
            [np.asarray(masks[m], np.float32) if m in masks else np.ones(len(X), np.float32)
             for m in self.mod_names],
            axis=1,
        )
        return apply_modality_masks_np(X, mask_mat, self.assign)

    def predict_proba(self, X, masks=None):
        return predict_proba(self.net_params, self._t(self.prepare_eval_matrix(X, masks))).cpu().numpy()

    def save(self, path):
        save_pickle(
            {
                "kind": "fusion_moddrop",
                "modality_dims": self.modality_dims,
                "params": self.params,
                "net_params": mlp_params_to_numpy(self.net_params),
            },
            path,
        )

    @classmethod
    def load(cls, path, input_dim=None, params=None, device=None):
        state = load_pickle(path)
        inst = cls(state["modality_dims"], state["params"], device=device)
        inst.net_params = mlp_params_from_jax(state["net_params"], device=inst.device)
        return inst
