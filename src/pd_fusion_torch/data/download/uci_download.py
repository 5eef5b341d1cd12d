"""UCI dataset fetchers (own copy of ``pd_fusion/data/download/uci_download.py``):
the same URLs, a file that exists is skipped, and a failed transfer leaves
no partial file. Uses stdlib ``urllib``, so the download path has no
third-party dependency."""
import logging
import urllib.request
from pathlib import Path

logger = logging.getLogger("pd_fusion.download")

_UCI_BASE = "https://archive.ics.uci.edu/ml/machine-learning-databases/parkinsons"
UCI_SOURCES = {
    "parkinsons.data": f"{_UCI_BASE}/parkinsons.data",
    "parkinsons_updrs.data": f"{_UCI_BASE}/telemonitoring/parkinsons_updrs.data",
}
_CHUNK = 1 << 16


def fetch(url: str, dest: Path) -> None:
    """Stream one URL to dest; a failed transfer never leaves a partial
    file behind."""
    if dest.exists():
        logger.info("already present: %s", dest)
        return
    dest.parent.mkdir(parents=True, exist_ok=True)
    logger.info("fetching %s -> %s", url, dest)
    try:
        with urllib.request.urlopen(url) as resp, open(dest, "wb") as out:
            while True:
                block = resp.read(_CHUNK)
                if not block:
                    break
                out.write(block)
        logger.info("done: %s", dest.name)
    except Exception as exc:
        logger.error("download failed for %s: %s", url, exc)
        dest.unlink(missing_ok=True)
        raise


def download_uci_datasets(base_dir: Path) -> None:
    """Fetch the UCI Parkinsons voice + telemonitoring tables into
    base_dir/uci/ (the layout the dev loaders expect)."""
    for filename, url in UCI_SOURCES.items():
        fetch(url, Path(base_dir) / "uci" / filename)
