"""Mask-aware fusion (port of ``pd_fusion/models/fusion_masked.py``): the
[N, M] modality-availability matrix is appended to the feature vector.

The ``mask_dim`` attribute is load-bearing: downstream code dispatches on
``hasattr(model, "mask_dim")`` to decide whether to pass the mask matrix.
"""
import numpy as np

from pd_fusion_torch.data.missingness import get_modality_mask_matrix
from pd_fusion_torch.models.fusion_late import LateFusionModel


class MaskedFusionModel(LateFusionModel):
    kind = "fusion_masked"

    def __init__(self, input_dim, mask_dim, params, device=None):
        super().__init__(input_dim + mask_dim, params, device=device)
        self.mask_dim = mask_dim

    def predict_proba(self, X, masks=None):
        if masks is not None:
            X = np.concatenate([np.asarray(X, np.float32), np.asarray(masks, np.float32)], axis=1)
        return super().predict_proba(X)

    def prepare_eval_matrix(self, X, masks=None):
        if masks is None:
            return np.asarray(X, np.float32)
        mm = get_modality_mask_matrix(masks).astype(np.float32)
        return np.concatenate([np.asarray(X, np.float32), mm], axis=1)

    def _state(self):
        return {**super()._state(), "input_dim": self.input_dim - self.mask_dim,
                "mask_dim": self.mask_dim}

    @classmethod
    def _from_state(cls, state, device=None):
        return cls(state["input_dim"], state["mask_dim"], state["params"], device=device)
