"""Model protocol (own copy of ``pd_fusion/models/base.py``).

Every model family implements the same four-method surface —
``train`` / ``predict_proba`` / ``save`` / ``load`` — which is what the
experiment runner, the calibration/conformal wrappers, and the
serialization loader program against. Concrete models in the port hold
a dict of torch tensors and delegate compute to ``pd_fusion_torch.nn``.
"""
import abc


class BaseModel(abc.ABC):
    @abc.abstractmethod
    def train(self, X, y, val_data=None):
        """Fit on features ``X`` / labels ``y`` (optional validation tuple)."""

    @abc.abstractmethod
    def predict_proba(self, X, masks=None):
        """Return P(y=1) per row; ``masks`` carries modality presence."""

    @abc.abstractmethod
    def save(self, path):
        """Persist enough state for ``load`` to reconstruct the model."""

    @classmethod
    @abc.abstractmethod
    def load(cls, path):
        """Inverse of ``save``."""
