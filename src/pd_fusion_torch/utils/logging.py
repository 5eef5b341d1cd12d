"""Logging setup (own copy of ``pd_fusion/utils/logging.py``).

Rich console handler when available; plain StreamHandler fallback so the
framework runs in minimal headless environments.
"""
import logging


def setup_logging(level: str = "INFO"):
    try:
        from rich.logging import RichHandler

        handlers = [RichHandler(rich_tracebacks=True, show_path=False)]
        fmt = "%(message)s"
    except Exception:  # pragma: no cover - rich is normally present
        handlers = [logging.StreamHandler()]
        fmt = "[%(asctime)s] %(levelname)s %(message)s"
    logging.basicConfig(level=level, format=fmt, datefmt="[%X]", handlers=handlers)
    return logging.getLogger("pd_fusion")
