"""PPMI dataset loading and the synthetic multimodal generator (own copy
of ``pd_fusion/data/ppmi_loader.py``).

- ``load_ppmi_data(config, synthetic)``: the synthetic generator, or the
  processed parquet with masks re-derived from marker columns;
- ``generate_synthetic_data``: per-modality Gaussian features, Bernoulli
  availability masks, NaN injection into missing rows, label from
  ``clinical_f0 - datspect_f0``. It consumes the numpy global RNG in the
  JAX package's exact call order (one ``randn`` then one ``choice`` per
  modality, in MODALITIES order), so the frame and masks are
  bit-identical to a JAX run's for the same seed;
- ``process_and_merge_data``: raw CSV validate / map / outer-merge ->
  parquet (the CLI's ``validate-data`` step);
- ``create_masks_from_df``: presence from marker columns per modality.
"""
import logging
from typing import Dict, Tuple

import numpy as np
import pandas as pd

from pd_fusion_torch.data.column_mapping import load_and_validate_raw_data
from pd_fusion_torch.data.schema import ID_COL, MODALITIES, TARGET_COL
from pd_fusion_torch.paths import PROCESSED_DATA_DIR

_MODALITY_MARKER_COLS = {
    "clinical": ["updrs_iii", "age"],
    "datspect": ["sbr_mean", "caudate_r"],
    "mri": ["hippocampus_l", "hippocampus_r"],
}


def load_ppmi_data(config: Dict, synthetic: bool = False) -> Tuple[pd.DataFrame, Dict[str, np.ndarray]]:
    if synthetic:
        return generate_synthetic_data(config["synthetic"])

    processed_path = PROCESSED_DATA_DIR / "ppmi_merged.parquet"
    if processed_path.exists():
        logging.getLogger("pd_fusion").info(f"Loading processed data from {processed_path}")
        df = pd.read_parquet(processed_path)
        masks = create_masks_from_df(df, config.get("modalities", {}))
        return df, masks

    raise FileNotFoundError(
        f"Processed data not found at {processed_path}. Run 'validate-data' first."
    )


def process_and_merge_data(data_config: Dict, column_config: Dict):
    """Load raw CSVs, map columns, outer-merge on patno, log per-modality
    presence, write parquet."""
    logger = logging.getLogger("pd_fusion")
    PROCESSED_DATA_DIR.mkdir(parents=True, exist_ok=True)

    raw_dfs = load_and_validate_raw_data(data_config, column_config)
    if not raw_dfs:
        logger.error("No valid data loaded from raw files.")
        return

    merged_df = None
    for mod, df in raw_dfs.items():
        if merged_df is None:
            merged_df = df
        else:
            merged_df = pd.merge(merged_df, df, on=ID_COL, how="outer", suffixes=("", f"_{mod}"))

    logger.info(f"Merged DataFrame Shape: {merged_df.shape}")
    logger.info("Missingness Stats per Modality (based on key columns):")
    for mod in MODALITIES:
        if mod in raw_dfs:
            n_present = raw_dfs[mod][ID_COL].nunique()
            n_total = len(merged_df)
            logger.info(f"  {mod}: {n_present}/{n_total} ({n_present / n_total:.1%}) subjects present")

    out_path = PROCESSED_DATA_DIR / "ppmi_merged.parquet"
    merged_df.to_parquet(out_path)
    logger.info(f"Saved merged data to {out_path}")
    return merged_df


def create_masks_from_df(df: pd.DataFrame, mod_config: Dict) -> Dict[str, np.ndarray]:
    """Presence mask per modality: 1 if any marker column is non-null."""
    masks = {}
    for mod in MODALITIES:
        cols = [c for c in _MODALITY_MARKER_COLS.get(mod, []) if c in df.columns]
        if cols:
            masks[mod] = df[cols].notna().any(axis=1).astype(int).values
        else:
            masks[mod] = np.zeros(len(df), dtype=int)
    return masks


def generate_synthetic_data(synth_config: Dict) -> Tuple[pd.DataFrame, Dict[str, np.ndarray]]:
    """Synthetic multimodal data; consumes np.random in the JAX package's
    exact call order for bit-identical outputs under the same seed."""
    n = synth_config["num_samples"]
    data = {ID_COL: np.arange(n)}

    masks = {}
    for i, mod in enumerate(MODALITIES):
        dim = synth_config.get(f"{mod}_dim", 10)
        missing_rate = synth_config["missing_rates"][i]

        features = np.random.randn(n, dim)
        mask = np.random.choice([0, 1], size=n, p=[missing_rate, 1 - missing_rate])
        masks[mod] = mask
        features[mask == 0] = np.nan
        for j in range(dim):
            data[f"{mod}_f{j}"] = features[:, j]

    clinical_score = data.get("clinical_f0", 0)
    dat_score = data.get("datspect_f0", 0)
    y_prob = 1 / (1 + np.exp(-(clinical_score - dat_score)))
    data[TARGET_COL] = (y_prob > 0.5).astype(int)

    return pd.DataFrame(data), masks
