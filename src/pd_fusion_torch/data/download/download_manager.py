"""Dev-dataset download front door (own copy of
``pd_fusion/data/download/download_manager.py``): the per-source fetchers
for ``download-dev`` (``cli.py``) and the manual instructions for the
access-controlled datasets."""
import argparse
import logging
from pathlib import Path

from pd_fusion_torch.data.download.openneuro_download import download_openneuro_datasets
from pd_fusion_torch.data.download.uci_download import download_uci_datasets

logger = logging.getLogger("pd_fusion.download_manager")

DATASETS = ("all", "uci", "openneuro", "manual")
RESTRICTED_SOURCES = (
    (
        "Synapse mPower (Mobile Parkinson's Data)",
        "https://www.synapse.org/#!Synapse:syn4993293",
        "Synapse account + Certified User status + accepted conditions",
        "data/raw_dev/synapse/",
    ),
    (
        "BioFIND (LONI/IDA)",
        "https://ida.loni.usc.edu/",
        "signed Data Use Agreement (DUA)",
        "data/raw_dev/biofind/",
    ),
)


def print_manual_instructions() -> None:
    bar = "=" * 60
    print(f"\n{bar}\nMANUAL DOWNLOAD REQUIRED FOR RESTRICTED DATASETS\n{bar}")
    for i, (name, url, needs, dest) in enumerate(RESTRICTED_SOURCES, 1):
        print(f"{i}. {name}")
        print(f"   - URL: {url}")
        print(f"   - Requires: {needs}")
        print(f"   - Place the downloaded files under '{dest}'")
    print(bar + "\n")


def download_dev(out: str, dataset: str = "all", metadata_only: bool = False) -> None:
    """``download-dev``: the UCI files, the OpenNeuro accessions and the
    manual instructions, as ``dataset`` selects."""
    out_dir = Path(out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if dataset in ("all", "uci"):
        download_uci_datasets(out_dir)
    if dataset in ("all", "openneuro"):
        download_openneuro_datasets(out_dir, metadata_only=metadata_only)
    if dataset in ("all", "manual"):
        print_manual_instructions()


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    cli = argparse.ArgumentParser(description="Fetch development datasets")
    cli.add_argument("--out", default="data/raw_dev")
    cli.add_argument("--dataset", default="all", choices=DATASETS)
    cli.add_argument("--openneuro-metadata-only", action="store_true")
    args = cli.parse_args()
    download_dev(args.out, args.dataset, args.openneuro_metadata_only)


if __name__ == "__main__":
    main()
