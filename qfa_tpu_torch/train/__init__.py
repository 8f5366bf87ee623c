"""Training: reference-semantics Adam, train state, full-state checkpoints,
and the whole-epoch engine on the CUDA epoch kernel (``fit_fused``)."""

from . import adam
from .checkpoint import latest_checkpoint, load_state, save_state
from .fused_engine import SeededShuffler, Shuffler, fit_fused, pick_tiling
from .loop import (
    TrainConfig,
    TrainState,
    guard_nonfinite,
    make_ckpt_saver,
    make_val_fn,
    reshuffle_dataset,
)

__all__ = [
    "adam",
    "latest_checkpoint",
    "load_state",
    "save_state",
    "SeededShuffler",
    "Shuffler",
    "fit_fused",
    "pick_tiling",
    "TrainConfig",
    "TrainState",
    "guard_nonfinite",
    "make_ckpt_saver",
    "make_val_fn",
    "reshuffle_dataset",
]
