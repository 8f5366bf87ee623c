"""Utilities: device selection, run logging and progress bars."""

from .device import resolve_device
from .logging import make_logger, setup_run_dir
from .progress import progress

__all__ = ["make_logger", "setup_run_dir", "progress", "resolve_device"]
