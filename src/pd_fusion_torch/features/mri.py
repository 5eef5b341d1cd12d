"""Tabular MRI feature helper (port of ``pd_fusion/features/mri.py``; no
pipeline calls it). Input columns are canonical (after the column mapper):
drops the metadata columns and, when an ``icv`` column exists, divides
every other numeric column by the intracranial volume."""
import pandas as pd

_META_COLS = frozenset({"patno", "event_id", "date"})
_ICV_EPS = 1e-6


def get_mri_features(df: pd.DataFrame) -> pd.DataFrame:
    feats = df.drop(columns=[c for c in df.columns if c in _META_COLS]).copy()
    if "icv" not in feats.columns:
        return feats
    denom = feats["icv"] + _ICV_EPS
    numeric = [
        c for c in feats.columns
        if c != "icv" and pd.api.types.is_numeric_dtype(feats[c])
    ]
    feats[numeric] = feats[numeric].div(denom, axis=0)
    return feats
