"""The check that nothing of JAX or of the JAX package was loaded: the
top-level name of every module in ``sys.modules`` (the part before the
first dot) compared whole, so ``pd_fusion_torch`` is not ``pd_fusion``."""
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pd_fusion"})


def forbidden_loaded(modules=None):
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
