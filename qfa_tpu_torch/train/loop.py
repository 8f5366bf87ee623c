"""Training configuration, state and the epoch-boundary helpers the
trainers share: non-finite guard, checkpoint saver, held-out validation
and the physical reshuffle.

The counterparts of ``qfa_tpu.train.loop``'s ``TrainConfig``,
``TrainState``, ``guard_nonfinite``, ``make_ckpt_saver``, ``make_val_fn``
and ``reshuffle_dataset``. The plain autograd trainers ``fit`` and
``fit_streaming`` are not ported yet (ROADMAP A9); the fused engine is
``train.fused_engine.fit_fused``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..data.loader import ResidualDataset
from ..models.params import PARAM_NAMES, ParamBounds, QFAParams, save_npz
from ..models.qfa import ModelOptions
from . import adam

Tensor = torch.Tensor

__all__ = [
    "TrainConfig",
    "TrainState",
    "guard_nonfinite",
    "make_ckpt_saver",
    "make_val_fn",
    "reshuffle_dataset",
]


@dataclass(frozen=True)
class TrainConfig:
    """Static training configuration (the JAX package's fields)."""

    n_epochs: int = 500
    batch_size: int = 500
    learning_rate: float = 1e-3
    weight_decay: float = 0.1
    decay_alpha: float = 0.9
    decay_step: int = 10
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    smooth_interval: int = 5
    save_interval: int = 5
    reference_norm: bool = True  #: per-element nonzero-count grad averaging.
    stop_on_negative_loss: bool = True
    reject_nonfinite: bool = True  #: roll back epochs whose loss goes NaN/Inf.
    #: bf16 operands (f32 accumulation) on the epoch kernel's six heavy
    #: products; counts, loss books and the Cholesky chain stay f32.
    mxu_bf16: bool = False
    #: accepted for configuration parity; the port's epoch has one
    #: backward form, identical to ``False`` (see ``ops.epoch_kernel``).
    bwd_wide: bool = False
    options: ModelOptions = ModelOptions()
    bounds: ParamBounds = ParamBounds()

    def adam_config(self) -> adam.AdamConfig:
        return adam.AdamConfig(
            learning_rate=self.learning_rate,
            b1=self.b1,
            b2=self.b2,
            eps=self.eps,
            weight_decay=self.weight_decay,
            decay_alpha=self.decay_alpha,
            decay_step=self.decay_step,
        )


@dataclass
class TrainState:
    """Mutable training state: parameters and optimizer state."""

    params: QFAParams
    opt_state: adam.AdamState


def _all_finite(params: QFAParams) -> bool:
    return all(bool(torch.isfinite(getattr(params, k)).all())
               for k in PARAM_NAMES)


def guard_nonfinite(new_state: TrainState, old_state: TrainState, loss
                    ) -> tuple[TrainState, bool]:
    """Reject an update that produced non-finite values: returns the new
    state when the loss and every new parameter are finite, otherwise the
    old state (moments included); and whether the update was kept."""
    ok = bool(torch.isfinite(torch.as_tensor(loss)).all()) and \
        _all_finite(new_state.params)
    return (new_state if ok else old_state), ok


def make_ckpt_saver(output_dir: str, mu, save_full_state: bool) -> Callable:
    """Epoch-checkpoint writer: the reference npz
    (``checkpoints/model_parameters_epoch_XX.npz``) and, with
    ``save_full_state``, the full state (params, Adam moments, epoch) in
    ``checkpoints/state_epoch_XX.npz`` for an exact resume."""

    def _save(state: TrainState, ckpt: int) -> None:
        save_npz(
            f"{output_dir}/checkpoints/model_parameters_epoch_{ckpt:02d}.npz",
            state.params, mu,
        )
        if save_full_state:
            from .checkpoint import save_state

            save_state(f"{output_dir}/checkpoints/state_epoch_{ckpt:02d}.npz",
                       state, mu)

    return _save


def make_val_fn(val_data: ResidualDataset | None, options: ModelOptions
                ) -> Callable | None:
    """Held-out validation evaluator ``params -> mean NLL`` (a float), or
    None. Evaluated with the plain torch likelihood in the plane layout
    (the validation set keeps its zabs plane and mask), on the device the
    validation tensors lie on."""
    if val_data is None:
        return None
    from ..data.batch import SpectraBatch
    from ..data.loader import as_f32
    from ..models.qfa import mean_nll

    batch = SpectraBatch(
        delta=as_f32(val_data.delta),
        error=as_f32(val_data.error),
        zabs=as_f32(val_data.zabs),
        mask=val_data.mask,
        weight=torch.ones((val_data.size,), dtype=torch.float32,
                          device=val_data.delta.device),
    )

    @torch.no_grad()
    def val_fn(params: QFAParams) -> float:
        return float(mean_nll(params, batch, options))

    return val_fn


def reshuffle_dataset(data: ResidualDataset, perm: Tensor) -> ResidualDataset:
    """Physically permute the rows of every tensor of the dataset by
    ``perm`` (a new dataset; the old tensors are left as they are)."""
    perm = torch.as_tensor(perm, dtype=torch.long, device=data.delta.device)
    return ResidualDataset(*(
        None if x is None else torch.index_select(x, 0, perm) for x in data
    ))
