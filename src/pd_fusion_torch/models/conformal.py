"""Mask-conditioned conformal (selective-prediction) wrapper (own copy of
``pd_fusion/models/conformal.py``).

- fit: the nonconformity score on the calibration set is 1 - p_true;
  scores are grouped by the subject's modality-availability pattern (the
  mask row rendered as a "010"-style key over sorted modality names);
  each group with n >= 10 gets the (1-alpha)*100 percentile as its
  threshold; a global percentile is the fallback;
- predict: abstain where min(p, 1-p) exceeds the group's threshold.

Host numpy: the calibration sets are hundreds of rows.
"""
import pickle
from typing import Dict, Tuple, Union

import numpy as np


class MaskConformalWrapper:
    def __init__(self, base_model, alpha: float = 0.1):
        self.base_model = base_model
        self.alpha = alpha
        self.thresholds: Dict[str, float] = {}
        self.global_threshold = 0.0

    @staticmethod
    def _mask_key(row) -> str:
        return "".join(str(int(v)) for v in row)

    def _predict(self, X, masks):
        try:
            probs = self.base_model.predict_proba(X, masks=masks)
        except TypeError:
            probs = self.base_model.predict_proba(X)
        return np.asarray(probs).ravel()

    def fit(self, X_cal: Union[np.ndarray, Dict], y_cal: np.ndarray, masks_cal: Dict[str, np.ndarray]):
        probs = self._predict(X_cal, masks_cal)
        y_cal = np.asarray(y_cal)
        scores = np.where(y_cal == 1, 1.0 - probs, probs)

        mod_keys = sorted(masks_cal.keys())
        mask_matrix = np.stack([np.asarray(masks_cal[k]) for k in mod_keys], axis=1)
        keys = np.array([self._mask_key(row) for row in mask_matrix])

        for key in np.unique(keys):
            group_scores = scores[keys == key]
            if len(group_scores) < 10:
                continue  # group falls back to the global threshold
            self.thresholds[str(key)] = float(
                np.percentile(group_scores, (1.0 - self.alpha) * 100)
            )
        self.global_threshold = float(np.percentile(scores, (1.0 - self.alpha) * 100))

    def predict(self, X, masks) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (probabilities, abstention boolean mask)."""
        probs = self._predict(X, masks)
        scores = np.minimum(probs, 1.0 - probs)

        mod_keys = sorted(masks.keys())
        mask_matrix = np.stack([np.asarray(masks[k]) for k in mod_keys], axis=1)
        thresh = np.array(
            [
                self.thresholds.get(self._mask_key(row), self.global_threshold)
                for row in mask_matrix
            ]
        )
        return probs, scores > thresh

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @classmethod
    def load(cls, path):
        with open(path, "rb") as f:
            return pickle.load(f)
