"""Training loops.

The counterparts of ``qfa_tpu.train.loop``:

* the per-step engines ``make_step_fn`` (``torch.autograd``) and
  ``make_fused_step_fn`` (the CUDA step kernel ``ops.fused_step``; the JAX
  package's ``make_pallas_step_fn``), each ``(state, batch) -> (state,
  loss)`` with the normalization, Adam, clip and a non-finite guard that
  stay on the device, so a step never waits for the card;
* the host-streaming trainer ``fit_streaming`` over ``data.streaming``
  (surveys larger than device memory), one host sync per epoch;
* the resident plain autograd trainer ``fit`` with ``make_epoch_fn``,
  ``train_epoch`` and ``make_sliced_epoch_fn``;
* ``reshuffle_dataset``; and, defined in ``state``, ``checkpoint`` and
  ``_run``, ``TrainConfig``, ``TrainState``, the guards,
  ``make_ckpt_saver`` and ``make_val_fn``.

Both trainers run on the run skeleton (``_run.Run``) of the production
trainer on the whole-epoch kernel, ``train.fused_engine.fit_fused``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable

import numpy as np
import torch

from ..data.batch import SpectraBatch
from ..data.loader import (
    ResidualDataset,
    as_f32,
    batch_indices,
    epoch_indices,
)
from ..data.shuffle import SeededShuffler
from ..models.params import PARAM_NAMES, QFAParams
from ..models.qfa import loss_and_grads, normalize_with_counts
from ..utils.device import resolve_device, to_device
from ..utils.profiling import nan_debugging, nonfinite_leaf
from . import adam
from ._run import Run, make_val_fn
from .checkpoint import make_ckpt_saver
from .state import (
    TrainConfig,
    TrainState,
    apply_step,
    guard_nonfinite,
    guard_nonfinite_device,
)

Tensor = torch.Tensor

__all__ = [
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


def reshuffle_dataset(data: ResidualDataset, perm: Tensor) -> ResidualDataset:
    """Physically permute the rows of every tensor of the dataset by
    ``perm`` (a new dataset; the old tensors are left as they are)."""
    perm = torch.as_tensor(perm, dtype=torch.long, device=data.delta.device)
    return ResidualDataset(*(
        None if x is None else torch.index_select(x, 0, perm) for x in data
    ))


# ---- per-step engines ------------------------------------------------------


def make_step_fn(config: TrainConfig) -> Callable:
    """Training step ``(state, batch) -> (state, loss)`` on
    ``models.qfa.loss_and_grads`` (``torch.autograd``): the batch loss and
    normalized gradients, Adam, clip and the non-finite guard. ``loss`` is
    a 0-d tensor on the batch's device; nothing syncs the host."""
    adam_cfg = config.adam_config()

    def step_fn(state: TrainState, batch: SpectraBatch):
        loss, grads = loss_and_grads(state.params, batch, config.options,
                                     reference_norm=config.reference_norm)
        return apply_step(config, adam_cfg, state, loss, grads)

    return step_fn


def make_fused_step_fn(config: TrainConfig, tile_batch: int = 256,
                       plain: bool = False) -> Callable:
    """Training step on the step kernel (``ops.fused_step``), the JAX
    package's ``make_pallas_step_fn``: one call gives the summed loss,
    gradients and counts; the normalization (per-element counts, or the
    real rows), Adam, clip and the guard follow on the device. Same
    contract as :func:`make_step_fn`; swap it into :func:`fit_streaming`
    with ``step_fn=``. ``plain=True`` runs ``fused_loss_grads_plain`` on
    any device (the counterpart of JAX's ``interpret=``); otherwise CUDA
    batches launch the kernel and CPU batches take the plain version.
    ``config.options.tau_which`` must name a tau law."""
    from ..ops.fused_step import fused_loss_grads, fused_loss_grads_plain

    engine = fused_loss_grads_plain if plain else fused_loss_grads
    adam_cfg = config.adam_config()

    def step_fn(state: TrainState, batch: SpectraBatch):
        out = engine(state.params, batch, tau_which=config.options.tau_which,
                     tile_batch=tile_batch)
        n_real = torch.clamp(batch.weight.to(torch.float32).sum(), min=1.0)
        loss = out.loss_sum / n_real
        if config.reference_norm:
            grads = normalize_with_counts(out.grads, out.counts)
        else:
            grads = QFAParams(*(getattr(out.grads, k) / n_real
                                for k in PARAM_NAMES)).requires_grad_(False)
        return apply_step(config, adam_cfg, state, loss, grads)

    return step_fn


# ---- pieces of the per-epoch trainers -------------------------------------


def _state_to(state: TrainState, device: torch.device) -> TrainState:
    def to(p: QFAParams) -> QFAParams:
        return QFAParams(**{k: getattr(p, k).detach().to(device)
                            for k in PARAM_NAMES})

    opt = state.opt_state
    return TrainState(to(state.params), adam.AdamState(
        m=to(opt.m).requires_grad_(False), v=to(opt.v).requires_grad_(False),
        epoch=opt.epoch))


@contextlib.contextmanager
def _nan_watch(where: str, state: TrainState):
    """With NaN debugging on (``utils.profiling.enable_nan_debugging``),
    run the block under ``torch.autograd``'s anomaly mode and raise its
    error as ``FloatingPointError``, naming the first non-finite leaf of
    ``state`` (the state the block started from); nothing when off."""
    if not nan_debugging():
        yield
        return
    try:
        with torch.autograd.set_detect_anomaly(True):
            yield
    except RuntimeError as e:
        if "nan" not in str(e).lower():
            raise
        bad = nonfinite_leaf(params=state.params, opt_state=state.opt_state)
        raise FloatingPointError(
            f"invalid value (nan or inf) encountered in {where}"
            + (f": first non-finite leaf {bad}" if bad else "")
            + f" (anomaly mode: {e})") from e


# ---- the host-streaming trainer ------------------------------------------


def fit_streaming(
    params: QFAParams | None,
    host_data,
    mu,
    config: TrainConfig,
    *,
    seed: int = 0,
    logger: logging.Logger | None = None,
    prefetch: int = 2,
    sharding=None,
    step_fn: Callable | None = None,
    output_dir: str | None = None,
    val_data: ResidualDataset | None = None,
    initial_state: TrainState | None = None,
    metrics_cb: Callable[[int, float, float], None] | None = None,
    save_full_state: bool = True,
    device="cuda",
) -> tuple[QFAParams, list]:
    """Training from host RAM with asynchronous batch prefetch.

    ``host_data`` is a ``data.streaming.HostResiduals``; batches stream to
    ``device`` (default ``"cuda"``: a run asked for the GPU raises where
    there is none; ``"cpu"`` trains on the CPU). The semantics of
    ``qfa_tpu.train.fit_streaming``: epoch ``e`` shuffles with
    ``np.random.default_rng(seed + e)`` (so a resumed run continues the
    uninterrupted trajectory), the tail batch trains with weight-0 padding,
    the epoch loss is the sum of batch means over ``max(N // B, 1)``,
    smoothing every ``smooth_interval`` epochs, checkpoints every
    ``save_interval`` (reference npz plus the full state), a negative loss
    smooths, saves and stops, ``val_data`` (moved to ``device``) is
    evaluated after every epoch, ``initial_state`` resumes. ``step_fn``
    swaps the engine (default :func:`make_step_fn`; the step kernel is
    :func:`make_fused_step_fn`). The host syncs once per epoch, for the
    loss.

    ``sharding`` (a ``parallel.mesh.DataMesh``, one process per device;
    ``device`` is then the mesh's) trains data-parallel: every rank draws the same permutation and
    streams only its rows of each batch to the mesh's device
    (``stream_batches(sharding=)``, JAX's ``P('data')`` placement), the
    state is broadcast from rank 0, and the default step is
    ``parallel.make_dp_step_fn(config, sharding)``, exact per-step DP
    (one ``all_reduce`` per batch; ``engine="pallas"`` for the step
    kernel). A ``step_fn`` passed with ``sharding`` must be such a
    mesh-aware step: it sees only this rank's rows. The batch size must
    divide by the world size. Only rank 0 validates, logs and writes.
    Returns (final params, per-epoch losses of the epochs run here).
    """
    from ..data.streaming import stream_batches

    dev = resolve_device(device if sharding is None else sharding.device)
    run = Run("fit_streaming", params, config, mu, mesh=sharding,
              initial_state=initial_state, output_dir=output_dir,
              save_full_state=save_full_state, logger=logger,
              metrics_cb=metrics_cb, val_data=val_data, val_device=dev)
    state = _state_to(run.state, dev)
    if sharding is not None:
        from ..parallel import make_dp_step_fn  # parallel imports train

        if step_fn is None:
            step_fn = make_dp_step_fn(config, sharding)
    elif step_fn is None:
        step_fn = make_step_fn(config)
    niter = max(host_data.size // config.batch_size, 1)
    for epoch in range(run.start, config.n_epochs):
        rng = np.random.default_rng(seed + epoch)
        t0 = time.perf_counter()
        losses = []
        with _nan_watch(run.where(epoch), state):
            for batch in stream_batches(host_data, config.batch_size, rng,
                                        prefetch=prefetch, device=dev,
                                        sharding=sharding):
                state, loss = step_fn(state, batch)
                losses.append(loss)
        # reference epoch-loss bookkeeping: sum of batch means / floor(N/B);
        # the epoch's one host sync
        epoch_loss = float(torch.stack(losses).sum()) / niter
        dt = time.perf_counter() - t0
        state = TrainState(state.params, adam.next_epoch(state.opt_state))
        if run.end_epoch(epoch, epoch_loss, dt, state):
            break
    return state.params, run.history


# ---- the resident plain autograd trainer ---------------------------------


def make_epoch_fn(config: TrainConfig) -> Callable:
    """One-epoch function ``(state, data, idx, wt=None) -> (state,
    epoch_loss)`` of :func:`make_step_fn` updates over a resident
    ``ResidualDataset``: batch ``i`` gathers rows ``idx[i]`` (weights
    ``wt[i]``, 0 on tail-batch pad entries; see
    ``data.loader.epoch_indices``). ``epoch_loss`` (a 0-d tensor) is the
    reference's bookkeeping, the sum of batch means over ``max(N // B,
    1)``; the returned state has the Adam counter advanced."""
    step = make_step_fn(config)

    def epoch_fn(state: TrainState, data: ResidualDataset, idx, wt=None):
        dev = data.delta.device
        idx = to_device(idx, dev, torch.long)
        if wt is not None:
            wt = to_device(wt, dev)
        losses = []
        for i in range(idx.shape[0]):
            batch = data.gather(idx[i], None if wt is None else wt[i])
            state, loss = step(state, batch)
            losses.append(loss)
        niter = max(data.size // config.batch_size, 1)
        return (TrainState(state.params, adam.next_epoch(state.opt_state)),
                torch.stack(losses).sum() / niter)

    return epoch_fn


def make_sliced_epoch_fn(config: TrainConfig) -> Callable:
    """Epoch function ``(state, data, offsets) -> (state, mean_loss)``
    serving batches as contiguous row slices (views, no gather): batch
    ``i`` is rows ``offsets[i] : offsets[i] + batch_size``, weight 1. The
    composition of batches is fixed between physical reshuffles
    (:func:`reshuffle_dataset`); ``offsets`` orders them."""
    step = make_step_fn(config)
    b = config.batch_size

    def epoch_fn(state: TrainState, data: ResidualDataset, offsets):
        weight = torch.ones((b,), dtype=torch.float32,
                            device=data.delta.device)
        losses = []
        for off in torch.as_tensor(offsets).reshape(-1).tolist():
            sl = slice(off, off + b)
            batch = SpectraBatch(
                delta=as_f32(data.delta[sl]), error=as_f32(data.error[sl]),
                zabs=as_f32(data.zabs[sl]), mask=data.mask[sl], weight=weight)
            state, loss = step(state, batch)
            losses.append(loss)
        return (TrainState(state.params, adam.next_epoch(state.opt_state)),
                torch.stack(losses).mean())

    return epoch_fn


def train_epoch(
    state: TrainState,
    data: ResidualDataset,
    generator: torch.Generator | None,
    config: TrainConfig,
    epoch_fn: Callable | None = None,
    *,
    perm=None,
) -> tuple[TrainState, float]:
    """Run one shuffled epoch, tail batch included; returns (state, loss).
    The rows are shuffled by ``generator``, or by ``perm`` (a permutation
    of the rows drawn elsewhere)."""
    if epoch_fn is None:
        epoch_fn = make_epoch_fn(config)
    if data.size % config.batch_size:
        ei = epoch_indices(generator, data.size, config.batch_size, perm=perm)
        state, loss = epoch_fn(state, data, ei.idx, ei.weight)
    else:
        idx = batch_indices(generator, data.size, config.batch_size,
                            perm=perm)
        state, loss = epoch_fn(state, data, idx)
    return state, float(loss)


def fit(
    params: QFAParams | None,
    data: ResidualDataset,
    mu,
    config: TrainConfig,
    *,
    seed: int = 0,
    shuffler=None,
    output_dir: str | None = None,
    logger: logging.Logger | None = None,
    metrics_cb: Callable[[int, float, float], None] | None = None,
    val_data: ResidualDataset | None = None,
    mesh=None,
    initial_state: TrainState | None = None,
    save_full_state: bool = True,
    dp_engine: str = "xla",
) -> tuple[QFAParams, list]:
    """Full training run on the plain autograd step over a resident
    dataset, with the epoch-boundary semantics of ``qfa_tpu.train.fit``:
    smoothing every ``smooth_interval`` epochs, checkpoints every
    ``save_interval`` (reference npz plus the full state), a negative loss
    smooths, saves and stops, held-out validation after every epoch, and
    resume from ``initial_state``.

    ``data`` lies on the training device, ``params`` (or
    ``initial_state``) on the same one. Epoch ``e`` shuffles the rows by
    ``shuffler.rows(e, N)`` (a ``data.shuffle.Shuffler``; default
    ``SeededShuffler(seed)``), so a permutation depends only on the seed
    and the epoch and a resumed run continues the uninterrupted
    trajectory.

    ``mesh`` (``parallel.make_mesh``, one process per device) runs each
    epoch data-parallel on ``parallel.dp`` (one ``all_reduce`` per batch):
    ``data`` is this rank's rows of the set, those
    ``parallel.rank_rows(n_real, None, mesh)`` gives it (contiguous
    shards of ``ceil(n_real / size)`` rows, padded here with zero-weight
    rows); the state is broadcast from rank 0, and each rank shuffles its
    shard
    (``shuffler.rows(epoch, shard rows)``; the default shuffler adds the
    rank to its seed from rank 1 on). ``dp_engine`` picks the per-rank
    sums: ``"xla"`` (autograd) or ``"pallas"`` (the step kernel). Only
    rank 0 logs, validates and writes.
    Returns (final params, per-epoch losses of the epochs run here).
    """
    shuffler = SeededShuffler(seed, 0 if mesh is None else mesh.rank) \
        if shuffler is None else shuffler
    run = Run("fit", params, config, mu, mesh=mesh,
              initial_state=initial_state, output_dir=output_dir,
              save_full_state=save_full_state, logger=logger,
              metrics_cb=metrics_cb, val_data=val_data)
    state = run.state
    if mesh is not None:
        from ..parallel import (  # parallel imports train
            local_shard,
            make_dp_epoch_fn,
            shard_epoch_indices,
        )

        data, n_real = local_shard(data, None, mesh)
        dp_fn = make_dp_epoch_fn(config, mesh, engine=dp_engine,
                                 n_real=n_real)

        def run_epoch(state, epoch):
            ei = shard_epoch_indices(
                None, data.size * mesh.size, config.batch_size, mesh,
                n_real=n_real, perm=shuffler.rows(epoch, data.size))
            state, loss = dp_fn(state, data, ei)
            return state, float(loss)
    else:
        epoch_fn = make_epoch_fn(config)

        def run_epoch(state, epoch):
            return train_epoch(state, data, None, config, epoch_fn,
                               perm=shuffler.rows(epoch, data.size))
    for epoch in range(run.start, config.n_epochs):
        t0 = time.perf_counter()
        with _nan_watch(run.where(epoch), state):
            state, loss = run_epoch(state, epoch)
        if run.end_epoch(epoch, loss, time.perf_counter() - t0, state):
            break
    return state.params, run.history
