"""Full training-state checkpoints: parameters, Adam moments and the epoch
counter, so a resumed run continues the exact trajectory.

The npz schema is ``qfa_tpu.train.checkpoint``'s key for key (``mu``,
``epoch``, ``F, Psi, omega, tau0, c0, beta`` and their ``m_*``/``v_*``
moments, float32; ``epoch`` int32), so either package resumes the
other's run. The reference-schema parameter npz is
``models.params.save_npz``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.params import PARAM_NAMES, QFAParams
from . import adam
from .loop import TrainState

__all__ = ["save_state", "load_state", "latest_checkpoint"]


def save_state(path: str, state: TrainState, mu) -> None:
    """Write a full-state npz: params, Adam m/v, epoch counter, mu."""
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    if isinstance(mu, torch.Tensor):
        mu = mu.detach().cpu().numpy()
    arrays = {"mu": np.asarray(mu, np.float32),
              "epoch": np.asarray(state.opt_state.epoch, np.int32)}
    p = state.params.to_numpy()
    m, v, _ = state.opt_state.to_numpy()
    for k in PARAM_NAMES:
        arrays[k] = p[k]
        arrays[f"m_{k}"] = m[k]
        arrays[f"v_{k}"] = v[k]
    np.savez(path, **arrays)


def load_state(path: str, *, device=None) -> tuple[TrainState, torch.Tensor]:
    """Load a full-state npz onto ``device``; returns (TrainState, mu)."""
    with np.load(path) as f:
        params = QFAParams.from_numpy({k: f[k] for k in PARAM_NAMES},
                                      device=device)
        opt = adam.AdamState.from_numpy(
            {k: f[f"m_{k}"] for k in PARAM_NAMES},
            {k: f[f"v_{k}"] for k in PARAM_NAMES},
            f["epoch"], device=device,
        )
        mu = torch.tensor(f["mu"], dtype=torch.float32, device=device)
    return TrainState(params, opt), mu


def latest_checkpoint(directory: str,
                      prefix: str = "state_epoch_") -> str | None:
    """Newest full-state checkpoint in a directory (by epoch number)."""
    if not os.path.isdir(directory):
        return None
    best, best_epoch = None, -1
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".npz"):
            try:
                epoch = int(name[len(prefix):-4])
            except ValueError:
                continue
            if epoch > best_epoch:
                best, best_epoch = os.path.join(directory, name), epoch
    return best
