"""Training: reference-semantics Adam, train state, full-state checkpoints,
the whole-epoch engine on the CUDA epoch kernel (``fit_fused``), the
host-streaming trainer (``fit_streaming``) on the per-step engines
(``make_fused_step_fn`` on the CUDA step kernel, ``make_step_fn`` by
autograd), and the resident autograd trainer ``fit``."""

from . import adam
from .checkpoint import latest_checkpoint, load_state, save_state
from .fused_engine import SeededShuffler, Shuffler, fit_fused, pick_tiling
from .loop import (
    TrainConfig,
    TrainState,
    fit,
    fit_streaming,
    guard_nonfinite,
    guard_nonfinite_device,
    make_ckpt_saver,
    make_epoch_fn,
    make_fused_step_fn,
    make_sliced_epoch_fn,
    make_step_fn,
    make_val_fn,
    reshuffle_dataset,
    train_epoch,
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
    "fit",
    "fit_streaming",
    "guard_nonfinite",
    "guard_nonfinite_device",
    "make_ckpt_saver",
    "make_epoch_fn",
    "make_fused_step_fn",
    "make_sliced_epoch_fn",
    "make_step_fn",
    "make_val_fn",
    "reshuffle_dataset",
    "train_epoch",
]
