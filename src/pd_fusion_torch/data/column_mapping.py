"""Raw CSV column validation and canonical renaming (own copy of
``pd_fusion/data/column_mapping.py``).

``ColumnMapper.validate_and_map`` checks that every ``required_columns``
entry appears in the raw dataframe, then renames via ``column_map``;
``load_and_validate_raw_data`` reads each modality's configured CSVs from
``raw_data_dir`` (first valid file wins when several are listed).
"""
import logging
from pathlib import Path
from typing import Dict, Optional

import pandas as pd


class ColumnMapper:
    def __init__(self, config: Dict):
        self.config = config
        self.logger = logging.getLogger("pd_fusion")

    def validate_and_map(self, df: pd.DataFrame, modality: str) -> Optional[pd.DataFrame]:
        if modality not in self.config:
            self.logger.warning(f"No configuration found for modality: {modality}")
            return None

        mod_config = self.config[modality]
        required = mod_config.get("required_columns", [])
        column_map = mod_config.get("column_map", {})

        missing = [c for c in required if c not in df.columns]
        if missing:
            self.logger.error(f"Missing required columns for {modality}: {missing}")
            return None

        rename = {k: v for k, v in column_map.items() if k in df.columns}
        return df.rename(columns=rename)


def load_and_validate_raw_data(data_config: Dict, column_config: Dict) -> Dict[str, pd.DataFrame]:
    logger = logging.getLogger("pd_fusion")
    raw_dir = Path(data_config["raw_data_dir"])
    mapper = ColumnMapper(column_config)

    loaded: Dict[str, pd.DataFrame] = {}
    for mod, mod_cfg in data_config["modalities"].items():
        dfs = []
        for f_name in mod_cfg["files"]:
            f_path = raw_dir / f_name
            if not f_path.exists():
                logger.error(f"File not found: {f_path}")
                continue
            try:
                df = pd.read_csv(f_path)
            except Exception as e:  # pragma: no cover
                logger.error(f"Error loading {f_path}: {e}")
                continue
            mapped = mapper.validate_and_map(df, mod)
            if mapped is not None:
                dfs.append(mapped)

        if dfs:
            loaded[mod] = dfs[0]
            if len(dfs) > 1:
                logger.warning(f"Multiple files loaded for {mod}, using first one only for now.")
        else:
            logger.warning(f"No valid data loaded for modality: {mod}")
    return loaded
