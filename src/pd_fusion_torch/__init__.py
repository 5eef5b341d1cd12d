"""pd_fusion_torch — the PyTorch/CUDA port of ``pd_fusion`` for NVIDIA Hopper.

A package beside the JAX package ``pd_fusion``, which stays the reference
it is tested against. The port imports ``torch`` and never ``jax`` nor any
module of ``pd_fusion``: where it needs a host-only module of the JAX
package it keeps its own copy. Module paths and names mirror the JAX
package (``pd_fusion/nn/mil.py`` -> ``pd_fusion_torch/nn/mil.py``).

Every Pallas kernel of the JAX package becomes a kernel written by hand
for Hopper (``csrc/``, built with ``nvcc`` at first use into ``build/``).
Entry points run on the CUDA device unless the caller asks for the CPU
(``PD_FUSION_TORCH_DEVICE=cpu``, see ``utils/device.py``).
"""

__version__ = "0.1.0"
