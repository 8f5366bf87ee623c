"""Utilities: device selection, run logging, metrics and progress bars."""

from .device import resolve_device
from .logging import MetricsWriter, make_logger, setup_run_dir
from .progress import progress

__all__ = [
    "MetricsWriter",
    "make_logger",
    "setup_run_dir",
    "progress",
    "resolve_device",
]
