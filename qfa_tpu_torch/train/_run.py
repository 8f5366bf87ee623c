"""The run skeleton of the three trainers (``loop.fit``,
``loop.fit_streaming``, ``fused_engine.fit_fused``): the set-up, the chunk
rule and the reference's epoch-boundary policy, each written once.
``fit`` and ``fit_streaming`` run chunks of one epoch and end each with
:meth:`Run.end_epoch`; ``fit_fused`` calls its steps one by one, inside
its spans and around its rollback and lookahead.
"""

from __future__ import annotations

import logging
from typing import Callable

import torch

from ..data.batch import SpectraBatch
from ..data.loader import ResidualDataset, as_f32
from ..data.shuffle import local_batch
from ..models.params import QFAParams, smooth_params
from ..models.qfa import ModelOptions, mean_nll
from ..utils.profiling import raise_if_nonfinite
from . import adam
from .checkpoint import make_ckpt_saver
from .state import TrainConfig, TrainState


def make_val_fn(val_data: ResidualDataset | None, options: ModelOptions
                ) -> Callable | None:
    """Held-out validation evaluator ``params -> mean NLL`` (a float), or
    None. Evaluated with the plain torch likelihood in the plane layout
    (the validation set keeps its zabs plane and mask), on the device the
    validation tensors lie on."""
    if val_data is None:
        return None
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


def chunk_length(epoch: int, config: TrainConfig, limit: int = 1, *,
                 saves: bool = False, reshuffle: int = 0) -> int:
    """The epochs of the chunk from ``epoch``: at most ``limit`` and the
    epochs left, ending exactly at the next smoothing boundary, at the
    next checkpoint when the run ``saves``, and at the next physical
    reshuffle when one comes every ``reshuffle`` epochs."""
    n = min(limit, config.n_epochs - epoch,
            config.smooth_interval - epoch % config.smooth_interval)
    if saves:
        n = min(n, config.save_interval - epoch % config.save_interval)
    if reshuffle:
        n = min(n, reshuffle - epoch % reshuffle)
    return n


class Run:
    """A run's set-up and its epoch-boundary policy: the state
    (``initial_state``, or ``params`` with a fresh Adam state; with a
    ``mesh``, rank 0's on every rank) and its start epoch, and the writer
    (no mesh, or rank 0), which alone validates (``val_data``, moved to
    ``val_device`` when given), logs, reports and saves. ``name`` names
    the trainer in errors."""

    def __init__(self, name: str, params: QFAParams | None,
                 config: TrainConfig, mu, *, mesh=None,
                 initial_state: TrainState | None = None,
                 output_dir: str | None = None, save_full_state: bool = True,
                 logger: logging.Logger | None = None,
                 metrics_cb: Callable | None = None,
                 val_data: ResidualDataset | None = None, val_device=None):
        self.name, self.config = name, config
        self.ndev = 1 if mesh is None else mesh.size
        local_batch(config.batch_size, self.ndev)
        state = initial_state if initial_state is not None \
            else TrainState(params, adam.init(params))
        self.start = int(state.opt_state.epoch)
        if mesh is not None:
            from ..parallel import replicated  # parallel imports train

            state = replicated(state, mesh)
        self.state = state
        writer = mesh is None or mesh.rank == 0
        if writer and val_data is not None and val_device is not None:
            val_data = ResidualDataset(*(None if x is None else
                                         x.to(val_device) for x in val_data))
        self.val_fn = make_val_fn(val_data, config.options) if writer \
            else None
        if isinstance(mu, torch.Tensor):
            mu = mu.detach().cpu()  # once, not a device read per save
        self.save = make_ckpt_saver(output_dir, mu, save_full_state)
        self.saves = bool(output_dir)  # for the chunk rule: alike on all
        self.save_dir = output_dir if writer else None
        self.logger = logger if writer else None
        self.metrics_cb = metrics_cb if writer else None
        self.history: list = []

    def where(self, epoch: int, n: int = 1) -> str:
        """The ``n`` epochs from ``epoch``, as errors name them."""
        if n == 1:
            return f"{self.name} epoch {epoch}"
        return f"{self.name} epochs {epoch}-{epoch + n - 1}"

    def check(self, epoch: int, losses, state: TrainState) -> bool:
        """With NaN debugging on, raise on a non-finite state or loss
        (``losses``: one epoch's float, or a chunk's list); add the losses
        to the history; whether they stop the run (a negative loss)."""
        chunk = losses if isinstance(losses, list) else [losses]
        raise_if_nonfinite(self.where(epoch, len(chunk)), losses,
                           params=state.params, opt_state=state.opt_state)
        self.history.extend(chunk)
        return self.config.stop_on_negative_loss and any(x < 0.0
                                                         for x in chunk)

    def report(self, epoch: int, losses: list, dt: float, params: QFAParams,
               rejected: bool = False) -> None:
        """The chunk's held-out loss (on ``params``, shown on its last
        epoch's line), a log line per epoch, and ``metrics_cb`` per epoch
        at ``dt`` / n seconds each; a rejected chunk is neither validated
        nor logged."""
        val = None if self.val_fn is None or rejected \
            else self.val_fn(params)
        n = len(losses)
        for k, loss in enumerate(losses):
            if self.logger is not None and not rejected:
                msg = (f"epoch: {epoch + k:03d}/{self.config.n_epochs:03d}"
                       f"  ;  loss:  {loss:.2f}  ;  time:  {dt / n:.2f} s")
                if val is not None and k == n - 1:
                    msg += f"  ;  val_loss:  {val:.2f}"
                self.logger.info(msg)
            if self.metrics_cb is not None:
                self.metrics_cb(epoch + k, loss, dt / n)

    def actions(self, ckpt: int) -> tuple[bool, bool]:
        """Whether the chunk ending at checkpoint epoch ``ckpt`` smooths,
        and whether it saves (on the writer), when it does not stop."""
        return (ckpt % self.config.smooth_interval == 0,
                bool(self.save_dir) and ckpt % self.config.save_interval == 0)

    def boundary(self, state: TrainState, ckpt: int, stop: bool,
                 smooth: Callable = smooth_params,
                 save: Callable | None = None) -> None:
        """The chunk's end at ``ckpt``: smooth ``state``'s parameters on
        the interval or a stop, then save it on the interval or a stop."""
        smooth_now, save_now = self.actions(ckpt)
        if stop or smooth_now:
            state.params = smooth(state.params)
        if self.save_dir and (stop or save_now):
            (save or self.save)(state, ckpt)

    def end_epoch(self, epoch: int, loss: float, dt: float,
                  state: TrainState) -> bool:
        """The whole policy after one epoch of a per-epoch trainer, on
        ``state`` (smoothed in place); whether the run stops."""
        stop = self.check(epoch, loss, state)
        self.report(epoch, [loss], dt, state.params)
        self.boundary(state, epoch + 1, stop)
        return stop
