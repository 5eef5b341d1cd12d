"""Clinical feature helper (port of ``pd_fusion/features/clinical.py``; no
pipeline calls it): the canonical column subset, with sex coded 1/0 (NaN
otherwise) and ``updrs_iii``/``age`` coerced to numbers."""
import numpy as np
import pandas as pd

CLINICAL_FEATURES = ["updrs_iii", "age", "sex", "education", "duration_yr"]


def get_clinical_features(df: pd.DataFrame) -> pd.DataFrame:
    available = [f for f in CLINICAL_FEATURES if f in df.columns]
    subset = df[available].copy()

    if "sex" in subset.columns:
        def _enc(x):
            s = str(x).upper()
            if s in ("M", "1", "1.0"):
                return 1
            if s in ("F", "0", "0.0"):
                return 0
            return np.nan

        subset["sex"] = subset["sex"].apply(_enc)

    for col in ("updrs_iii", "age"):
        if col in subset.columns:
            subset[col] = pd.to_numeric(subset[col], errors="coerce")
    return subset
