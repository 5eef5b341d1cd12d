"""DaT-SPECT feature helper (port of ``pd_fusion/features/datspect.py``; no
pipeline calls it): the ROI subset plus caudate/putamen asymmetry indices
|L - R| / mean(L, R)."""
import pandas as pd

ROI_COLS = ["caudate_r", "caudate_l", "putamen_r", "putamen_l", "sbr_mean"]


def get_datspect_features(df: pd.DataFrame) -> pd.DataFrame:
    available = [f for f in ROI_COLS if f in df.columns]
    subset = df[available].copy()

    for region in ("caudate", "putamen"):
        lcol, rcol = f"{region}_l", f"{region}_r"
        if lcol in subset.columns and rcol in subset.columns:
            mean_val = (subset[lcol] + subset[rcol]) / 2.0
            subset[f"{region}_asym"] = (subset[lcol] - subset[rcol]).abs() / (mean_val + 1e-6)
    return subset
