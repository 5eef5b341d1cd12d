"""Canonical modality schema (own copy of ``pd_fusion/data/schema.py``).

The fixed MODALITIES ordering is a cross-layer contract: mask matrices,
feature concatenation, and the MoE expert stacking all use this order.
"""
from typing import Dict, List

MODALITIES = ["clinical", "datspect", "mri"]

MODALITY_FEATURES: Dict[str, List[str]] = {
    "clinical": ["age", "sex", "education", "updrs_iii", "disease_duration"],
    "datspect": ["caudate_l", "caudate_r", "putamen_l", "putamen_r", "sbr_mean"],
    "mri": ["hippocampus_l", "hippocampus_r"],
}

TARGET_COL = "diagnosis"  # 1 for PD, 0 for HC
ID_COL = "patno"
