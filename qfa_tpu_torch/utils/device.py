"""Explicit device selection: a run names its device and never falls back."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(spec) -> torch.device:
    """``spec`` ("cuda", "cuda:1", "cpu" or a ``torch.device``) as a
    ``torch.device``. A CUDA device that is not visible raises
    ``RuntimeError``: a run asked for the GPU never continues on the CPU."""
    dev = torch.device(spec)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch sees no CUDA "
                "device; pass --device cpu to run the plain path on the CPU"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cpu or cuda)")
    return dev
