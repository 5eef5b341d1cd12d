"""Constant-probability baseline (own copy of ``pd_fusion/models/dummy.py``):
predicts the training prevalence for every sample. The stand-in model
when a modality carries no features at all."""
import numpy as np

from pd_fusion_torch.models.base import BaseModel
from pd_fusion_torch.utils.io import load_pickle, save_pickle


class ConstantProbabilityModel(BaseModel):
    """No-op learner whose only state is one scalar probability."""

    def __init__(self, p: float = 0.5):
        self.p = float(p)

    def train(self, X, y, val_data=None):
        y = np.asarray(y)
        if y.size:
            self.p = float(y.mean())

    def predict_proba(self, X, masks=None):
        return np.repeat(self.p, len(X))

    def save(self, path):
        save_pickle(self, path)

    @classmethod
    def load(cls, path):
        return load_pickle(path)
