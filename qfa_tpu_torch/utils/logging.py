"""Run logging: the run layout of ``qfa_tpu.utils.logging``, a
``config.yaml`` dump and a ``log.txt`` FileHandler in the output
directory, and the JSONL metrics stream of training runs
(``metrics.jsonl``).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import IO, Any

__all__ = ["setup_run_dir", "make_logger", "MetricsWriter"]


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


class MetricsWriter:
    """Append-only JSONL metrics stream (one record per epoch), each
    record stamped with ``wall_s`` since the writer opened."""

    def __init__(self, output_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)
        self._fh: IO | None = open(self.path, "a")
        self._t0 = time.time()

    def write(self, **record: Any) -> None:
        if self._fh is None:
            raise ValueError(f"metrics stream {self.path} is closed")
        record.setdefault("wall_s", round(time.time() - self._t0, 3))
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
