"""Smoke-check the UCI dev-dataset loaders (port of ``scripts/verify_loaders.py``):

    python -m pd_fusion_torch.scripts.verify_loaders

Loads each UCI dataset under ``paths.dev_data_dir()`` and prints its shape
and mask keys, or why it failed.
"""
from pd_fusion_torch.data.dev_datasets.uci_parkinsons import load_uci_parkinsons
from pd_fusion_torch.data.dev_datasets.uci_telemonitoring import load_uci_telemonitoring
from pd_fusion_torch.utils.logging import setup_logging


def verify_loaders():
    setup_logging()
    for name, loader in (
        ("UCI Parkinsons", load_uci_parkinsons),
        ("UCI Telemonitoring", load_uci_telemonitoring),
    ):
        print("-" * 50)
        print(f"Verifying {name}...")
        try:
            df, masks = loader()
            print(f"SUCCESS. Shape: {df.shape}")
            print(f"Masks keys: {list(masks.keys())}")
            print(f"Clinical Present: {masks['clinical'].sum()}/{len(df)}")
        except Exception as e:  # the report names each loader's failure and goes on
            print(f"FAILED: {e}")
    print("-" * 50)


if __name__ == "__main__":
    verify_loaders()
