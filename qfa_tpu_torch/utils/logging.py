"""Run logging: the run layout of ``qfa_tpu.utils.logging``, a
``config.yaml`` dump and a ``log.txt`` FileHandler in the output
directory. (The training half's JSONL metrics stream comes with it.)
"""

from __future__ import annotations

import logging
import os

__all__ = ["setup_run_dir", "make_logger"]


def setup_run_dir(output_dir: str, config=None) -> str:
    """Create the output dir and dump the run config (``config.yaml``)."""
    os.makedirs(output_dir, exist_ok=True)
    if config is not None:
        with open(os.path.join(output_dir, "config.yaml"), "w") as f:
            f.write(config.dump())
    return output_dir


def make_logger(output_dir: str, name: str = "qfa_tpu_torch") -> logging.Logger:
    """File logger writing ``log.txt`` in the output dir (the JAX package's
    line format)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers = [
        h for h in logger.handlers if not isinstance(h, logging.FileHandler)
    ]
    handler = logging.FileHandler(os.path.join(output_dir, "log.txt"))
    handler.setLevel(logging.INFO)
    handler.setFormatter(
        logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    )
    logger.addHandler(handler)
    return logger
