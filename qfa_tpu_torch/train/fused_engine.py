"""Production trainer on the whole-epoch engine (``ops.epoch_kernel``).

The counterpart of ``qfa_tpu.train.pallas_engine.fit_pallas``, with its
contract: the dataset is padded with inert zero rows to whole batches (the
tail batch trains; the loss divisor counts the real rows), epochs run in
chunks of up to ``epochs_per_launch`` per call, ending exactly at every
smoothing, saving and reshuffle boundary; an epoch (or chunk) whose loss
is not finite is rolled back with the counter kept advanced; a negative
loss stops the run (smooth + save); the full state resumes exactly,
replaying the physical reshuffles of the uninterrupted run; an optional
held-out set is evaluated after every chunk.

Shuffling: every epoch regroups ``tile_batch``-row tiles into batches
through a tile permutation; ``reshuffle_interval > 0`` also permutes the
rows physically every K epochs. Both come from a :class:`Shuffler`, by
default :class:`SeededShuffler` (``torch.Generator``s seeded from the
run's seed and the epoch), so a permutation depends only on the seed and
the epoch number. On the GPU the tile is only this shuffle granule:
:func:`pick_tiling` takes the largest power of two <= 256 that divides
the batch, so batches are never padded.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Protocol

import numpy as np
import torch

from ..data.loader import ResidualDataset
from ..models.params import QFAParams, smooth_params
from ..ops.epoch_kernel import fused_train_epoch, fused_train_epoch_plain
from . import adam
from .loop import (
    TrainConfig,
    TrainState,
    make_ckpt_saver,
    make_val_fn,
    reshuffle_dataset,
)

__all__ = ["Shuffler", "SeededShuffler", "pick_tiling", "fit_fused"]

_A10 = ("{} is not ported yet: multi-device training waits for parallel/ "
        "on torch.distributed (ROADMAP A10)")


class Shuffler(Protocol):
    """Source of the per-epoch permutations of :func:`fit_fused`."""

    def tiles(self, epoch: int, n_tiles: int) -> torch.Tensor:
        """Tile permutation of ``epoch``: ``n_tiles`` int64 indices."""

    def rows(self, epoch: int, n_rows: int) -> torch.Tensor:
        """Row permutation of the physical reshuffle at ``epoch``."""


class SeededShuffler:
    """Permutations from ``torch.Generator``s seeded with (seed, epoch,
    stream): tile permutations on stream 0, row reshuffles on stream 1."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def _generator(self, epoch: int, stream: int) -> torch.Generator:
        state = np.random.SeedSequence([self.seed, int(epoch), stream])
        return torch.Generator().manual_seed(
            int(state.generate_state(1, np.uint64)[0]))

    def tiles(self, epoch: int, n_tiles: int) -> torch.Tensor:
        return torch.randperm(n_tiles, generator=self._generator(epoch, 0))

    def rows(self, epoch: int, n_rows: int) -> torch.Tensor:
        return torch.randperm(n_rows, generator=self._generator(epoch, 1))


def pick_tiling(batch_size: int, limit: int = 256) -> tuple[int, int]:
    """``(tile_batch, batch_rows)`` for a batch size: the tile is the
    largest power of two <= ``limit`` that divides ``batch_size`` (4 for
    the reference default 500), and ``batch_rows == batch_size``, so no
    batch carries padding. The TPU's sublane alignment and its measured
    cost model do not apply on the GPU, where the tile is only the
    granule of the epoch shuffle."""
    if batch_size < 1:
        raise ValueError(f"batch size must be >= 1, got {batch_size}")
    tb = 1
    while tb * 2 <= limit and batch_size % (tb * 2) == 0:
        tb *= 2
    return tb, batch_size


def _pad_rows(data: ResidualDataset, pad: int) -> ResidualDataset:
    if not pad:
        return data
    return ResidualDataset(*(
        None if x is None else torch.cat(
            [x, torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                            device=x.device)])
        for x in data
    ))


def fit_fused(
    params: QFAParams | None,
    data: ResidualDataset,
    mu,
    config: TrainConfig,
    *,
    seed: int = 0,
    shuffler: Shuffler | None = None,
    output_dir: str | None = None,
    logger: logging.Logger | None = None,
    metrics_cb: Callable[[int, float, float], None] | None = None,
    val_data: ResidualDataset | None = None,
    initial_state: TrainState | None = None,
    tile_batch: int | None = None,
    reshuffle_interval: int = 0,
    save_full_state: bool = True,
    derive_mask: bool = False,
    loglam: torch.Tensor | None = None,
    epochs_per_launch: int = 1,
    plain: bool = False,
    mesh=None,
    dp_exact: bool = False,
) -> tuple[QFAParams, list]:
    """Full training run on the whole-epoch engine.

    ``data`` lies on the training device (CUDA: the kernel; CPU: the plain
    version); ``params`` (or ``initial_state``) on the same device.
    ``derive_mask`` drops the mask (the engine derives ``error > 0``);
    ``loglam`` switches to the derived layout, where ``data.zabs`` is the
    (N, 2) zq column. ``plain=True`` runs the plain version on any device.
    Returns (final params, per-epoch loss history of the epochs run here).
    ``mesh``/``dp_exact`` raise: multi-device training is ROADMAP A10.
    """
    if mesh is not None:
        raise NotImplementedError(_A10.format("mesh"))
    if dp_exact:
        raise NotImplementedError(_A10.format("dp_exact"))
    shuffler = SeededShuffler(seed) if shuffler is None else shuffler
    state = initial_state if initial_state is not None \
        else TrainState(params, adam.init(params))
    start_epoch = int(state.opt_state.epoch)
    b = config.batch_size
    n_real = data.size  # before padding: the loss divisor
    if derive_mask:
        data = data._replace(mask=None)
    if tile_batch is None:
        tb, batch_rows = pick_tiling(b)
    else:
        tb = max(1, min(int(tile_batch), b))
        batch_rows = -(-b // tb) * tb
    n_batches = max(-(-n_real // b), 1)
    data = _pad_rows(data, n_batches * batch_rows - data.size)
    n_tiles = data.size // tb
    epoch_fn = fused_train_epoch_plain if plain else fused_train_epoch
    val_fn = make_val_fn(val_data, config.options)
    _save = make_ckpt_saver(output_dir, mu, save_full_state)
    if reshuffle_interval and start_epoch:
        # exact resume: replay the reshuffles of the uninterrupted run
        for past in range(reshuffle_interval, start_epoch, reshuffle_interval):
            data = reshuffle_dataset(data, shuffler.rows(past, data.size))

    history: list = []
    epl = max(1, int(epochs_per_launch))
    epoch = start_epoch
    while epoch < config.n_epochs:
        # chunks end exactly at the next epoch-boundary action
        chunk = min(epl, config.n_epochs - epoch,
                    config.smooth_interval - epoch % config.smooth_interval)
        if output_dir:
            chunk = min(chunk,
                        config.save_interval - epoch % config.save_interval)
        if reshuffle_interval:
            chunk = min(chunk,
                        reshuffle_interval - epoch % reshuffle_interval)
        if reshuffle_interval and epoch and epoch % reshuffle_interval == 0:
            data = reshuffle_dataset(data, shuffler.rows(epoch, data.size))
        perms = torch.stack([torch.as_tensor(shuffler.tiles(epoch + k, n_tiles))
                             for k in range(chunk)])
        t0 = time.perf_counter()
        prev_state = state  # rollback anchor
        out = epoch_fn(
            state.params, state.opt_state.m, state.opt_state.v,
            data.delta, data.error, data.zabs, perms, data.mask,
            epoch=epoch, n_batches=n_batches, n_epochs=chunk, loglam=loglam,
            derive_zabs=loglam is not None, tile_batch=tb,
            learning_rate=config.learning_rate,
            weight_decay=config.weight_decay, decay_alpha=config.decay_alpha,
            decay_step=config.decay_step, b1=config.b1, b2=config.b2,
            eps=config.eps, bounds=config.bounds,
            tau_which=config.options.tau_which,
            reference_norm=config.reference_norm, mxu_bf16=config.mxu_bf16,
            bwd_wide=config.bwd_wide,
        )
        state = TrainState(out.params, adam.AdamState(
            m=out.m, v=out.v, epoch=epoch + chunk))
        # reference epoch loss: sum of batch means over floor(N_real / B)
        means = out.loss_sums.reshape(chunk, -1) / torch.clamp(
            out.n_real.reshape(chunk, -1), min=1.0)
        losses = [float(x) for x in
                  (means.sum(dim=1) / max(n_real // b, 1)).cpu()]
        dt = time.perf_counter() - t0
        history.extend(losses)
        rejected = config.reject_nonfinite and not all(
            np.isfinite(x) for x in losses)
        if rejected:
            # epoch-level non-finite guard: restore params and moments,
            # keep the advanced counter (a rejected step still counts)
            state = TrainState(prev_state.params, adam.AdamState(
                m=prev_state.opt_state.m, v=prev_state.opt_state.v,
                epoch=state.opt_state.epoch))
            if logger is not None:
                logger.warning(
                    "epoch%s %03d%s produced non-finite loss %s: update"
                    " rejected, parameters and moments rolled back",
                    "s" if chunk > 1 else "", epoch,
                    f"-{epoch + chunk - 1:03d}" if chunk > 1 else "", losses)
        val_loss = None if val_fn is None or rejected \
            else val_fn(state.params)
        for k, loss in enumerate(losses):
            if logger is not None and not rejected:
                msg = (f"epoch: {epoch + k:03d}/{config.n_epochs:03d}  ;  "
                       f"loss:  {loss:.2f}  ;  time:  {dt / chunk:.2f} s")
                if val_loss is not None and k == chunk - 1:
                    msg += f"  ;  val_loss:  {val_loss:.2f}"
                logger.info(msg)
            if metrics_cb is not None:
                metrics_cb(epoch + k, loss, dt / chunk)
        ckpt = epoch + chunk
        if config.stop_on_negative_loss and any(x < 0.0 for x in losses):
            state.params = smooth_params(state.params)
            if output_dir:
                _save(state, ckpt)
            break
        if ckpt % config.smooth_interval == 0:
            state.params = smooth_params(state.params)
        if output_dir and ckpt % config.save_interval == 0:
            _save(state, ckpt)
        epoch = ckpt
    return state.params, history
