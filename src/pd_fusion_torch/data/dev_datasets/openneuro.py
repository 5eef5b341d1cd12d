"""OpenNeuro BIDS dev-dataset loader -> canonical multimodal format (port
of ``pd_fusion/data/dev_datasets/openneuro.py``).

Reads ``<dev data dir>/openneuro/<accession>/participants.tsv``: infers and
normalizes the diagnosis label (per-accession hints from
``configs/openneuro_labels.yaml``), builds ``clinical_*`` features (sex
coded, everything else coerced to numbers), derives ``mri_*`` proxy
features as per-modality NIfTI file counts (t1w/t2w/bold/dwi/fmap) under
each BIDS subject directory, NaNs the MRI block where no file was found,
and returns (df, masks).

One table drives the MRI modality detection (filename marker -> feature
column); labels and sex are mapped through lookups built over the unique
values.
"""
import logging
from collections import Counter
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd

from pd_fusion_torch.data.schema import ID_COL, TARGET_COL
from pd_fusion_torch.paths import ROOT_DIR, dev_data_dir

logger = logging.getLogger("pd_fusion.openneuro")

ID_ALIASES = ("participant_id", "subject_id", "sub_id", "subject")
LABEL_COLUMN_GUESSES = (
    "group", "diagnosis", "dx", "phenotype", "status", "case_control", "patient",
)
FALLBACK_LABEL_MAP = {
    "pd": 1, "parkinson": 1, "parkinson's": 1, "patient": 1, "case": 1,
    "hc": 0, "control": 0, "healthy": 0, "ctl": 0,
}
SEX_CODES = {"m": 1, "male": 1, "1": 1, "f": 0, "female": 0, "0": 0}

# filename marker -> mri proxy feature (order matters: first match wins)
MRI_MARKERS = (("_t1w", "t1w"), ("_t2w", "t2w"), ("_bold", "bold"), ("_dwi", "dwi"))
MRI_FEATURES = ("t1w", "t2w", "bold", "dwi", "fmap")


def _accession_hints(accession: str) -> Dict:
    cfg_path = ROOT_DIR / "configs" / "openneuro_labels.yaml"
    if not cfg_path.exists():
        return {}
    try:
        from pd_fusion_torch.utils.io import load_yaml

        return (load_yaml(cfg_path) or {}).get(accession, {}) or {}
    except Exception as exc:  # malformed yaml should not kill the loader
        logger.warning("openneuro label config unreadable: %s", exc)
        return {}


def _as_binary(value, label_map: Dict[str, int]) -> Optional[int]:
    if pd.isna(value):
        return None
    if isinstance(value, (int, np.integer, float, np.floating)):
        f = float(value)
        if f in (0.0, 1.0):
            return int(f)
    return label_map.get(str(value).strip().lower())


def _scan_mri_counts(subject_dir: Path) -> Counter:
    counts: Counter = Counter()
    if subject_dir.is_dir():
        for f in subject_dir.rglob("*.nii*"):
            lower = f.name.lower()
            for marker, feat in MRI_MARKERS:
                if marker in lower:
                    counts[feat] += 1
                    break
        fmap = subject_dir / "fmap"
        if fmap.is_dir():
            counts["fmap"] = sum(1 for _ in fmap.rglob("*.nii*"))
    return counts


def load_openneuro_dataset(accession: str) -> Tuple[pd.DataFrame, Dict[str, np.ndarray]]:

    root = dev_data_dir() / "openneuro" / accession
    participants = root / "participants.tsv"
    if not root.exists():
        raise FileNotFoundError(
            f"OpenNeuro dataset missing at {root}; fetch it with "
            "'python -m pd_fusion.cli download-dev --dataset openneuro'"
        )
    if not participants.exists():
        raise FileNotFoundError(f"no participants.tsv under {root}")
    table = pd.read_csv(participants, sep="\t")

    id_col = next((c for c in ID_ALIASES if c in table.columns), None)
    if id_col is None:
        raise ValueError(f"participants.tsv for {accession} lacks a subject-id column")
    table = table.rename(columns={id_col: ID_COL})

    hints = _accession_hints(accession)
    label_col = hints.get("label_column") or next(
        (c for c in hints.get("label_column_candidates", LABEL_COLUMN_GUESSES) if c in table.columns),
        None,
    )
    if label_col is None:
        raise ValueError(
            f"cannot infer the label column for {accession}; set label_column "
            "in configs/openneuro_labels.yaml"
        )
    label_map = {str(k).lower(): int(v) for k, v in hints.get("label_map", FALLBACK_LABEL_MAP).items()}

    lut = {v: _as_binary(v, label_map) for v in table[label_col].unique()}
    y = table[label_col].map(lut)
    table = table[y.notna()].reset_index(drop=True)
    y = y.dropna().astype(int).reset_index(drop=True)
    if y.nunique() < 2:
        raise ValueError(f"{accession}: label column '{label_col}' is single-class after mapping")

    out = pd.DataFrame({ID_COL: table[ID_COL].values, TARGET_COL: y.values})

    # clinical block: sex gets a code, everything else numeric-coerced
    for col in table.columns:
        if col in (ID_COL, label_col):
            continue
        if col.lower() in ("sex", "gender"):
            codes = {v: SEX_CODES.get(str(v).strip().lower()) for v in table[col].unique()}
            out[f"clinical_{col.lower()}"] = table[col].map(codes)
        else:
            numeric = pd.to_numeric(table[col], errors="coerce")
            if numeric.notna().any():
                out[f"clinical_{col}"] = numeric.values

    # mri proxy block: NIfTI counts per BIDS subject dir
    for feat in MRI_FEATURES:
        # float so the later NaN masking is dtype-compatible (pandas 3
        # raises on NaN-into-int64 setitem)
        out[f"mri_{feat}_count"] = 0.0
    for i, sid in enumerate(out[ID_COL]):
        name = str(sid) if str(sid).startswith("sub-") else f"sub-{sid}"
        for feat, n in _scan_mri_counts(root / name).items():
            out.loc[i, f"mri_{feat}_count"] = n

    clinical_cols = [c for c in out.columns if c.startswith("clinical_")]
    mri_cols = [c for c in out.columns if c.startswith("mri_")]
    clinical_mask = (
        out[clinical_cols].notna().any(axis=1).astype(int).values
        if clinical_cols
        else np.zeros(len(out), dtype=int)
    )
    mri_mask = (out[mri_cols].sum(axis=1) > 0).astype(int).values
    if mri_mask.sum() == 0:
        logger.warning("%s: no NIfTI files found; MRI modality absent", accession)
    out.loc[mri_mask == 0, mri_cols] = np.nan

    masks = {
        "clinical": clinical_mask,
        "datspect": np.zeros(len(out), dtype=int),
        "mri": mri_mask,
    }
    return out, masks
