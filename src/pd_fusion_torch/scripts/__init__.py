"""Command-line builders of the port, run as ``python -m
pd_fusion_torch.scripts.<name>`` (the JAX package's ``scripts/`` as
modules of the port, with the same flags)."""
