"""Training loops and the pieces the trainers share.

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
* ``TrainConfig``, ``TrainState``, ``guard_nonfinite``,
  ``make_ckpt_saver``, ``make_val_fn`` and ``reshuffle_dataset``.

The production trainer on the whole-epoch kernel is
``train.fused_engine.fit_fused``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass
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
from ..models.params import (
    PARAM_NAMES,
    ParamBounds,
    QFAParams,
    clip_params,
    save_npz,
    smooth_params,
)
from ..models.qfa import ModelOptions, loss_and_grads, normalize_with_counts
from ..utils.device import resolve_device, to_device
from ..utils.profiling import nan_debugging, nonfinite_leaf, raise_if_nonfinite
from . import adam

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

_A10 = ("{} is not ported yet: sharding the host-streaming trainer is "
        "ROADMAP A10 (parallel/ serves the resident trainers)")


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
                           loss: Tensor) -> tuple[TrainState, Tensor]:
    """:func:`guard_nonfinite` without a host sync: ``ok`` is a 0-d bool
    tensor (the loss and every new parameter finite) and every tensor of
    the returned state is ``torch.where(ok, new, old)``, moments included,
    as in the JAX package's elementwise guard. The step functions use it,
    so a step never waits for the card."""
    ok = torch.isfinite(loss).all()
    for k in PARAM_NAMES:
        ok = ok & torch.isfinite(getattr(new_state.params, k)).all()

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


# ---- per-step engines ------------------------------------------------------


def _apply(config: TrainConfig, adam_cfg: adam.AdamConfig,
           state: TrainState, loss: Tensor, grads: QFAParams):
    """Adam, clip and the device-side guard of one batch update."""
    new_params, new_opt = adam.apply_update(state.params, grads,
                                            state.opt_state, adam_cfg)
    new_state = TrainState(clip_params(new_params, config.bounds), new_opt)
    if config.reject_nonfinite:
        new_state, _ = guard_nonfinite_device(new_state, state, loss)
    return new_state, loss


def make_step_fn(config: TrainConfig) -> Callable:
    """Training step ``(state, batch) -> (state, loss)`` on
    ``models.qfa.loss_and_grads`` (``torch.autograd``): the batch loss and
    normalized gradients, Adam, clip and the non-finite guard. ``loss`` is
    a 0-d tensor on the batch's device; nothing syncs the host."""
    adam_cfg = config.adam_config()

    def step_fn(state: TrainState, batch: SpectraBatch):
        loss, grads = loss_and_grads(state.params, batch, config.options,
                                     reference_norm=config.reference_norm)
        return _apply(config, adam_cfg, state, loss, grads)

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
        return _apply(config, adam_cfg, state, loss, grads)

    return step_fn


# ---- shared epoch-boundary pieces ---------------------------------------


def _state_to(state: TrainState, device: torch.device) -> TrainState:
    def to(p: QFAParams) -> QFAParams:
        return QFAParams(**{k: getattr(p, k).detach().to(device)
                            for k in PARAM_NAMES})

    opt = state.opt_state
    return TrainState(to(state.params), adam.AdamState(
        m=to(opt.m).requires_grad_(False), v=to(opt.v).requires_grad_(False),
        epoch=opt.epoch))


def _report(logger, metrics_cb, epoch: int, n_epochs: int, loss: float,
            dt: float, val_loss: float | None) -> None:
    msg = (f"epoch: {epoch:03d}/{n_epochs:03d}  ;  "
           f"loss:  {loss:.2f}  ;  time:  {dt:.2f} s")
    if val_loss is not None:
        msg += f"  ;  val_loss:  {val_loss:.2f}"
    if logger is not None:
        logger.info(msg)
    if metrics_cb is not None:
        metrics_cb(epoch, loss, dt)


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


def _check_epoch(where: str, loss, state: TrainState) -> None:
    raise_if_nonfinite(where, loss, params=state.params,
                       opt_state=state.opt_state)


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
    loss. ``sharding`` raises: multi-device training is ROADMAP A10.
    Returns (final params, per-epoch losses of the epochs run here).
    """
    if sharding is not None:
        raise NotImplementedError(_A10.format("sharding"))
    from ..data.streaming import stream_batches

    dev = resolve_device(device)
    state = initial_state if initial_state is not None \
        else TrainState(params, adam.init(params))
    state = _state_to(state, dev)
    start_epoch = int(state.opt_state.epoch)
    if step_fn is None:
        step_fn = make_step_fn(config)
    niter = max(host_data.size // config.batch_size, 1)
    if val_data is not None:
        val_data = ResidualDataset(*(None if x is None else x.to(dev)
                                     for x in val_data))
    val_fn = make_val_fn(val_data, config.options)
    _save = make_ckpt_saver(output_dir, mu, save_full_state)
    history: list = []
    for epoch in range(start_epoch, config.n_epochs):
        rng = np.random.default_rng(seed + epoch)
        t0 = time.perf_counter()
        losses = []
        where = f"fit_streaming epoch {epoch}"
        with _nan_watch(where, state):
            for batch in stream_batches(host_data, config.batch_size, rng,
                                        prefetch=prefetch, device=dev):
                state, loss = step_fn(state, batch)
                losses.append(loss)
        # reference epoch-loss bookkeeping: sum of batch means / floor(N/B);
        # the epoch's one host sync
        epoch_loss = float(torch.stack(losses).sum()) / niter
        _check_epoch(where, epoch_loss, state)
        dt = time.perf_counter() - t0
        history.append(epoch_loss)
        val_loss = None if val_fn is None else val_fn(state.params)
        _report(logger, metrics_cb, epoch, config.n_epochs, epoch_loss, dt,
                val_loss)
        state = TrainState(state.params, adam.next_epoch(state.opt_state))
        ckpt = epoch + 1
        if config.stop_on_negative_loss and epoch_loss < 0.0:
            state.params = smooth_params(state.params)
            if output_dir:
                _save(state, ckpt)
            break
        if ckpt % config.smooth_interval == 0:
            state.params = smooth_params(state.params)
        if output_dir and ckpt % config.save_interval == 0:
            _save(state, ckpt)
    return state.params, history


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
    ``shuffler.rows(e, N)`` (a ``train.fused_engine.Shuffler``; default
    ``SeededShuffler(seed)``), so a permutation depends only on the seed
    and the epoch and a resumed run continues the uninterrupted
    trajectory.

    ``mesh`` (``parallel.make_mesh``, one process per device) runs each
    epoch data-parallel on ``parallel.dp`` (one ``all_reduce`` per batch):
    ``data`` is the whole dataset on every rank, padded with zero-weight
    rows to a multiple of the world size and split by rows; the state is
    broadcast from rank 0, and each rank shuffles its shard
    (``shuffler.rows(epoch, shard rows)``; the default shuffler adds the
    rank to its seed from rank 1 on). ``dp_engine`` picks the per-rank
    sums: ``"xla"`` (autograd) or ``"pallas"`` (the step kernel). Only
    rank 0 logs, validates and writes.
    Returns (final params, per-epoch losses of the epochs run here).
    """
    from .fused_engine import SeededShuffler

    rank = 0 if mesh is None else mesh.rank
    shuffler = SeededShuffler(seed, rank) if shuffler is None else shuffler
    state = initial_state if initial_state is not None \
        else TrainState(params, adam.init(params))
    start_epoch = int(state.opt_state.epoch)
    if mesh is not None:
        from ..parallel import (
            make_dp_epoch_fn,
            replicated,
            shard_dataset,
            shard_epoch_indices,
        )

        ndev, n_real = mesh.size, data.size
        if config.batch_size % ndev:
            raise ValueError(f"batch size {config.batch_size} not divisible "
                             f"by the {ndev}-device mesh")
        data = shard_dataset(ResidualDataset(*(
            None if x is None else torch.cat([x, x.new_zeros(
                (-n_real % ndev,) + tuple(x.shape[1:]))]) for x in data)),
            mesh)
        state = replicated(state, mesh)
        dp_fn = make_dp_epoch_fn(config, mesh, engine=dp_engine,
                                 n_real=n_real)

        def run_epoch(state, epoch):
            ei = shard_epoch_indices(
                None, data.size * ndev, config.batch_size, mesh,
                n_real=n_real, perm=shuffler.rows(epoch, data.size))
            state, loss = dp_fn(state, data, ei)
            return state, float(loss)
    else:
        epoch_fn = make_epoch_fn(config)

        def run_epoch(state, epoch):
            return train_epoch(state, data, None, config, epoch_fn,
                               perm=shuffler.rows(epoch, data.size))
    writer = rank == 0
    val_fn = make_val_fn(val_data, config.options) if writer else None
    _save = make_ckpt_saver(output_dir, mu, save_full_state)
    if not writer:
        output_dir = logger = metrics_cb = None
    history: list = []
    for epoch in range(start_epoch, config.n_epochs):
        t0 = time.perf_counter()
        where = f"fit epoch {epoch}"
        with _nan_watch(where, state):
            state, loss = run_epoch(state, epoch)
        _check_epoch(where, loss, state)
        dt = time.perf_counter() - t0
        history.append(loss)
        val_loss = None if val_fn is None else val_fn(state.params)
        _report(logger, metrics_cb, epoch, config.n_epochs, loss, dt,
                val_loss)
        ckpt = epoch + 1
        if config.stop_on_negative_loss and loss < 0.0:
            state.params = smooth_params(state.params)
            if output_dir:
                _save(state, ckpt)
            break
        if ckpt % config.smooth_interval == 0:
            state.params = smooth_params(state.params)
        if output_dir and ckpt % config.save_interval == 0:
            _save(state, ckpt)
    return state.params, history
