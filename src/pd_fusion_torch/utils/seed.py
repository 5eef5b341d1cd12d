"""Seeding (port of ``pd_fusion/utils/seed.py``).

``set_seed`` seeds ``random`` and the numpy global RNG exactly as the JAX
package does, so the host-side draws (synthetic data, sklearn-free
scenario draws) are bit-identical to a JAX run's. In place of the JAX
package's global PRNG key chain it resets a chain of ``torch.Generator``s:
``fresh_generator`` takes the place of ``fresh_key`` and returns a new,
independently seeded generator split off the chain. torch and JAX give
different numbers from the same seed, so device-side draws (init,
shuffles, dropout) differ between the two packages; the tests feed both
the same draws through explicit seams instead.
"""
import random
import threading
from typing import Optional

import numpy as np
import torch

_lock = threading.Lock()
_chain: Optional[torch.Generator] = None


def set_seed(seed: int = 42):
    """Seed host RNGs and reset the global generator chain."""
    global _chain
    random.seed(seed)
    np.random.seed(seed)
    with _lock:
        _chain = torch.Generator().manual_seed(int(seed))


def fresh_generator(device=None) -> torch.Generator:
    """A new generator on ``device`` (default CPU), seeded from the chain.

    ``set_seed`` must have been called first; falls back to seed 0.
    """
    global _chain
    with _lock:
        if _chain is None:
            _chain = torch.Generator().manual_seed(0)
        sub_seed = int(torch.randint(0, 2**62, (1,), generator=_chain).item())
    return torch.Generator(device=device or "cpu").manual_seed(sub_seed)
