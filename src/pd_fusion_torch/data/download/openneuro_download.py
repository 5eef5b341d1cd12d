"""OpenNeuro dataset fetchers (own copy of
``pd_fusion/data/download/openneuro_download.py``): one ``openneuro``
CLI call per accession, a metadata-only include filter, and an accession
that exists is skipped. Without the CLI nothing is fetched."""
import logging
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

logger = logging.getLogger("pd_fusion.download")

# PD-relevant accessions the framework ships loaders/configs for
ACCESSIONS: Sequence[str] = ("ds004471", "ds004392", "ds001907")
METADATA_FILES = ("participants.tsv", "participants.json", "dataset_description.json")


def cli_available() -> bool:
    if shutil.which("openneuro"):
        return True
    logger.warning(
        "the 'openneuro' CLI is not installed — install with "
        "'npm install -g @openneuro/cli' and run 'openneuro login', "
        "or download the datasets manually"
    )
    return False


def fetch_accession(accession: str, dest_root: Path, metadata_only: bool = False) -> None:
    target = dest_root / accession
    if target.exists():
        logger.info("%s already present at %s — skipping", accession, target)
        return
    cmd = ["openneuro", "download", accession, str(target)]
    if metadata_only:
        for name in METADATA_FILES:
            cmd += ["--include", name]
    logger.info("downloading %s -> %s", accession, target)
    try:
        subprocess.run(cmd, check=True)
    except Exception as exc:
        logger.error("openneuro download failed for %s: %s", accession, exc)


def download_openneuro_datasets(base_dir: Path, metadata_only: bool = False) -> None:
    if not cli_available():
        return
    dest_root = Path(base_dir) / "openneuro"
    dest_root.mkdir(parents=True, exist_ok=True)
    for accession in ACCESSIONS:
        fetch_accession(accession, dest_root, metadata_only=metadata_only)
