"""Lightweight phase timing (own copy of ``pd_fusion/utils/profiling.py``).

- ``phase_timer(name)``: context manager logging a phase's wall-clock;
- ``maybe_profile(name)``: a no-op in the port (the JAX package wraps the
  block in ``jax.profiler.trace``; a torch profiler hook is later work).
"""
import contextlib
import logging
import time

logger = logging.getLogger("pd_fusion")


@contextlib.contextmanager
def phase_timer(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.info(f"[timing] {name}: {time.perf_counter() - t0:.3f}s")


@contextlib.contextmanager
def maybe_profile(name: str = "trace"):
    yield
