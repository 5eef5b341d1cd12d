"""UCI Telemonitoring dataset -> canonical format (port of
``pd_fusion/data/dev_datasets/uci_telemonitoring.py``).

Reads ``<dev data dir>/uci/parkinsons_updrs.data``. The dataset is PD-only,
so the binary target is a severity proxy: ``total_UPDRS`` (else
``motor_UPDRS``) at or above its median. ``subject#`` becomes the id; the
voice and demographic features become ``clinical_*`` (both UPDRS columns
are left out); masks: clinical 1, others 0.
"""
from typing import Dict, Tuple

import numpy as np
import pandas as pd

from pd_fusion_torch.data.schema import ID_COL, TARGET_COL
from pd_fusion_torch.paths import dev_data_dir


def load_uci_telemonitoring() -> Tuple[pd.DataFrame, Dict[str, np.ndarray]]:

    data_path = dev_data_dir() / "uci" / "parkinsons_updrs.data"
    if not data_path.exists():
        raise FileNotFoundError(
            f"UCI Telemonitoring data not found at {data_path}. "
            "Run 'python -m pd_fusion.cli download-dev' first."
        )

    df = pd.read_csv(data_path)
    df = df.rename(columns={"subject#": ID_COL})

    severity_col = "total_UPDRS" if "total_UPDRS" in df.columns else "motor_UPDRS"
    if severity_col not in df.columns:
        raise ValueError("Telemonitoring dataset missing UPDRS columns for severity proxy.")
    df[TARGET_COL] = (df[severity_col] >= df[severity_col].median()).astype(int)

    exclude = [ID_COL, TARGET_COL, "motor_UPDRS", "total_UPDRS"]
    feature_cols = [c for c in df.columns if c not in exclude]
    df = df.rename(columns={c: f"clinical_{c}" for c in feature_cols})

    n = len(df)
    masks = {
        "clinical": np.ones(n, dtype=int),
        "datspect": np.zeros(n, dtype=int),
        "mri": np.zeros(n, dtype=int),
    }
    return df, masks
