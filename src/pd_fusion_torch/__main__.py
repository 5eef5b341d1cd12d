"""``python -m pd_fusion_torch`` == ``python -m pd_fusion_torch.cli``."""
from pd_fusion_torch.cli import main

if __name__ == "__main__":
    main()
