"""The train state and configuration, the non-finite guards, and the
update every per-step engine ends with: what the trainers and the
data-parallel engines (``parallel``) share."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..models.params import PARAM_NAMES, ParamBounds, QFAParams, clip_params
from ..models.qfa import ModelOptions
from . import adam

Tensor = torch.Tensor

__all__ = ["TrainConfig", "TrainState", "apply_step", "guard_nonfinite",
           "guard_nonfinite_device"]


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
    #: reject updates whose loss or params go NaN/Inf: per step on the
    #: step engines, per epoch (rolled back) on the whole-epoch engine.
    reject_nonfinite: bool = True
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


def guard_nonfinite_device(new_state: TrainState, old_state: TrainState,
                           loss: Tensor, all_shards: Callable | None = None
                           ) -> tuple[TrainState, Tensor]:
    """:func:`guard_nonfinite` without a host sync: ``ok`` is a 0-d bool
    tensor (the loss and every new parameter finite) and every tensor of
    the returned state is ``torch.where(ok, new, old)``, moments included,
    as in the JAX package's elementwise guard. The step functions use it,
    so a step never waits for the card. Where each rank holds a shard of
    the parameters, ``all_shards`` maps this rank's ``ok`` to the ``ok``
    of every shard (a collective), so that all ranks keep or reject the
    update together."""
    ok = torch.isfinite(loss).all()
    for k in PARAM_NAMES:
        ok = ok & torch.isfinite(getattr(new_state.params, k)).all()
    if all_shards is not None:
        ok = all_shards(ok)

    def pick(new: QFAParams, old: QFAParams) -> QFAParams:
        return QFAParams(**{
            k: torch.where(ok, getattr(new, k).detach(),
                           getattr(old, k).detach()) for k in PARAM_NAMES})

    opt = adam.AdamState(
        m=pick(new_state.opt_state.m, old_state.opt_state.m
               ).requires_grad_(False),
        v=pick(new_state.opt_state.v, old_state.opt_state.v
               ).requires_grad_(False),
        epoch=new_state.opt_state.epoch)
    return TrainState(pick(new_state.params, old_state.params), opt), ok


def apply_step(config: TrainConfig, adam_cfg: adam.AdamConfig,
               state: TrainState, loss: Tensor, grads: QFAParams,
               all_shards: Callable | None = None):
    """Adam, clip and the device-side guard of one batch update
    (``all_shards``: see :func:`guard_nonfinite_device`)."""
    new_params, new_opt = adam.apply_update(state.params, grads,
                                            state.opt_state, adam_cfg)
    new_state = TrainState(clip_params(new_params, config.bounds), new_opt)
    if config.reject_nonfinite:
        new_state, _ = guard_nonfinite_device(new_state, state, loss,
                                              all_shards)
    return new_state, loss
