"""Adam with the reference's semantics, as functions on ``QFAParams``.

The same rules as ``qfa_tpu.train.adam``:

* L2 weight decay is folded into the gradient before the moment updates
  (Adam with L2, not AdamW), for every parameter including the scalars;
* the bias-correction and schedule counter advances once per **epoch**
  (:func:`next_epoch`), so every batch of an epoch shares one learning
  rate and one pair of bias corrections;
* the step decay is ``lr0 * alpha ** ((i + 1) // step)``.

The learning rate and both corrections are computed in float32 on the
host (:func:`schedule_f32`), as the JAX package computes them, and are
shared by this module, the epoch kernel and its plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.params import PARAM_NAMES, QFAParams

__all__ = [
    "AdamConfig",
    "AdamState",
    "init",
    "schedule_f32",
    "scheduled_lr",
    "apply_update",
    "next_epoch",
]


class AdamConfig(NamedTuple):
    """Hyper-parameters."""

    learning_rate: float = 1e-2
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-3
    decay_alpha: float = 1.0  #: step-decay factor (1.0 = constant LR)
    decay_step: int = 10  #: epochs per decay step


class AdamState(NamedTuple):
    """Optimizer state: moments shaped like the parameters and the
    reference's per-epoch counter."""

    m: QFAParams  #: first-moment estimates.
    v: QFAParams  #: second-moment estimates.
    epoch: int  #: the per-epoch counter ``i``.

    @classmethod
    def from_numpy(cls, m: dict, v: dict, epoch, *, device=None) -> "AdamState":
        """Build from name -> array mappings (e.g. the JAX package's
        ``AdamState`` converted with ``np.asarray``) and an epoch count."""
        return cls(m=_moments(QFAParams.from_numpy(m, device=device)),
                   v=_moments(QFAParams.from_numpy(v, device=device)),
                   epoch=int(np.asarray(epoch)))

    def to_numpy(self) -> tuple[dict, dict, int]:
        """``(m, v, epoch)`` as float32 numpy dicts and an int (the inverse
        of :meth:`from_numpy`)."""
        return self.m.to_numpy(), self.v.to_numpy(), int(self.epoch)


def _moments(tree: QFAParams) -> QFAParams:
    """Moments are optimizer state, not trainable: no autograd."""
    return tree.requires_grad_(False)


def init(params: QFAParams) -> AdamState:
    """Zero moments on the parameters' device, counter 0."""
    zeros = lambda: _moments(QFAParams(**{  # noqa: E731
        k: torch.zeros_like(getattr(params, k).detach()) for k in PARAM_NAMES
    }))
    return AdamState(m=zeros(), v=zeros(), epoch=0)


def schedule_f32(
    epoch: int,
    *,
    learning_rate: float,
    decay_alpha: float,
    decay_step: int,
    b1: float,
    b2: float,
) -> tuple[np.float32, np.float32, np.float32]:
    """``(lr, bc1, bc2)`` of counter ``epoch`` in float32:
    ``lr = lr0 * alpha ** ((epoch + 1) // step)``, ``bc1 = 1 - b1 ** t``,
    ``bc2 = 1 - b2 ** t`` with ``t = epoch + 1``."""
    f32 = np.float32
    t = f32(epoch + 1)
    decay = f32(decay_alpha) ** f32((epoch + 1) // decay_step)
    return f32(f32(learning_rate) * decay), f32(1.0) - f32(b1) ** t, \
        f32(1.0) - f32(b2) ** t


def _schedule(config: AdamConfig, epoch: int):
    return schedule_f32(epoch, learning_rate=config.learning_rate,
                        decay_alpha=config.decay_alpha,
                        decay_step=config.decay_step, b1=config.b1,
                        b2=config.b2)


def scheduled_lr(config: AdamConfig, epoch: int) -> np.float32:
    """The step-decayed learning rate of counter ``epoch`` (float32)."""
    return _schedule(config, epoch)[0]


@torch.no_grad()
def apply_update(
    params: QFAParams, grads: QFAParams, state: AdamState, config: AdamConfig
) -> tuple[QFAParams, AdamState]:
    """One batch update; returns ``(new_params, new_state)`` (the counter
    is unchanged: it advances per epoch)."""
    lr, bc1, bc2 = (float(x) for x in _schedule(config, state.epoch))
    wd, b1, b2, eps = (config.weight_decay, config.b1, config.b2, config.eps)
    new_p, new_m, new_v = {}, {}, {}
    for k in PARAM_NAMES:
        p = getattr(params, k).detach()
        g = getattr(grads, k).detach() + wd * p
        m = (1 - b1) * g + b1 * getattr(state.m, k).detach()
        v = (1 - b2) * g * g + b2 * getattr(state.v, k).detach()
        new_p[k] = p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        new_m[k], new_v[k] = m, v
    return QFAParams(**new_p), AdamState(
        m=_moments(QFAParams(**new_m)), v=_moments(QFAParams(**new_v)),
        epoch=state.epoch,
    )


def next_epoch(state: AdamState) -> AdamState:
    """Advance the per-epoch counter (the reference's ``optimizer.step()``)."""
    return state._replace(epoch=state.epoch + 1)
