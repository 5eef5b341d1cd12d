"""Linear-layer initialisation shared by the port's networks (port of
``pd_fusion/nn/mlp.py::linear_init``).

Parameters are plain dicts of tensors in the JAX package's layout:
``{"w": [fan_in, fan_out], "b": [fan_out]}``, applied as ``x @ w + b``.
Initialisation matches torch ``nn.Linear``'s default, as the JAX package's
does: U(-1/sqrt(fan_in), +1/sqrt(fan_in)) for both w and b. The draws come
from an explicit ``torch.Generator`` (w first, then b), so they differ from
the JAX package's ``jax.random`` draws; tests carry weights across instead.
"""
import math
from typing import Dict

import torch


def linear_init(generator: torch.Generator, fan_in: int, fan_out: int) -> Dict[str, torch.Tensor]:
    bound = float(torch.tensor(1.0 / math.sqrt(max(fan_in, 1)), dtype=torch.float32))
    w = torch.empty((fan_in, fan_out), dtype=torch.float32).uniform_(-bound, bound, generator=generator)
    b = torch.empty((fan_out,), dtype=torch.float32).uniform_(-bound, bound, generator=generator)
    return {"w": w, "b": b}
