"""Training: reference-semantics Adam, train state, full-state checkpoints,
the whole-epoch engine on the CUDA epoch kernel (``fit_fused``), the
host-streaming trainer (``fit_streaming``) on the per-step engines
(``make_fused_step_fn`` on the CUDA step kernel, ``make_step_fn`` by
autograd), and the resident autograd trainer ``fit``; the three share one
run skeleton (``_run``)."""

from ..data.shuffle import SeededShuffler, Shuffler, pick_tiling
from . import adam
from ._run import make_val_fn
from .checkpoint import latest_checkpoint, load_state, make_ckpt_saver, \
    save_state
from .fused_engine import fit_fused
from .loop import (
    fit,
    fit_streaming,
    make_epoch_fn,
    make_fused_step_fn,
    make_sliced_epoch_fn,
    make_step_fn,
    reshuffle_dataset,
    train_epoch,
)
from .state import (
    TrainConfig,
    TrainState,
    guard_nonfinite,
    guard_nonfinite_device,
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
