"""Shared helper of the port's PPMI suite scripts (own copy of
``scripts/_cli_common.py``): every script logs to stdout and to a log file
inside its output directory."""
import logging
from pathlib import Path

from pd_fusion_torch.analysis.tabular import _file_and_console


def file_logger(name: str, out_dir: Path, filename: str) -> logging.Logger:
    """Logger writing to stdout and ``out_dir/filename`` (dir is created);
    a later call for another directory moves its handlers there."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    return _file_and_console(name, out_dir / filename, "[%(asctime)s] %(levelname)s %(message)s")
