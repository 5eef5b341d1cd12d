"""UCI Parkinsons voice dataset -> canonical multimodal format (port of
``pd_fusion/data/dev_datasets/uci_parkinsons.py``).

Reads ``<dev data dir>/uci/parkinsons.data``: ``status`` becomes the
target, ``name`` the id, every voice feature a ``clinical_*`` column;
masks: clinical 1, datspect 0, mri 0. ``synthetic_frame`` writes a seeded
stand-in with UCI's columns, for tests and smoke runs (nothing fetched).
"""
from typing import Dict, Tuple

import numpy as np
import pandas as pd

from pd_fusion_torch.data.schema import ID_COL, TARGET_COL
from pd_fusion_torch.paths import dev_data_dir

# parkinsons.data's columns, in the file's order (UCI's parkinsons.names)
COLUMNS = ["name", "MDVP:Fo(Hz)", "MDVP:Fhi(Hz)", "MDVP:Flo(Hz)", "MDVP:Jitter(%)",
           "MDVP:Jitter(Abs)", "MDVP:RAP", "MDVP:PPQ", "Jitter:DDP", "MDVP:Shimmer",
           "MDVP:Shimmer(dB)", "Shimmer:APQ3", "Shimmer:APQ5", "MDVP:APQ", "Shimmer:DDA", "NHR",
           "HNR", "status", "RPDE", "DFA", "spread1", "spread2", "D2", "PPE"]


def load_uci_parkinsons() -> Tuple[pd.DataFrame, Dict[str, np.ndarray]]:

    data_path = dev_data_dir() / "uci" / "parkinsons.data"
    if not data_path.exists():
        raise FileNotFoundError(
            f"UCI Parkinsons data not found at {data_path}. "
            "Run 'python -m pd_fusion.cli download-dev' first."
        )

    df = pd.read_csv(data_path)
    df = df.rename(columns={"status": TARGET_COL, "name": ID_COL})
    feature_cols = [c for c in df.columns if c not in (TARGET_COL, ID_COL)]
    df = df.rename(columns={c: f"clinical_{c}" for c in feature_cols})

    n = len(df)
    masks = {
        "clinical": np.ones(n, dtype=int),
        "datspect": np.zeros(n, dtype=int),
        "mri": np.zeros(n, dtype=int),
    }
    return df, masks


def synthetic_frame(n: int = 195, seed: int = 0) -> pd.DataFrame:
    """A seeded stand-in for parkinsons.data: UCI's columns and row count,
    six recordings a subject, about 3/4 PD (``status`` 1), synthetic values
    of which some shift with the label."""
    rng = np.random.RandomState(seed)
    status = (rng.rand(n) < 0.75).astype(int)
    cols = {"name": [f"phon_R01_S{i // 6:02d}_{i % 6 + 1}" for i in range(n)]}
    for j, c in enumerate(c for c in COLUMNS if c not in ("name", "status")):
        cols[c] = rng.randn(n) * (1 + j % 4) + 0.6 * status * (j % 3 == 0)
    cols["status"] = status
    return pd.DataFrame(cols)[COLUMNS]
