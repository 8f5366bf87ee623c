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
through a tile permutation (by default ``data.shuffle.batch_window``'s
tile, which pads no batch); ``reshuffle_interval > 0`` also permutes the
rows physically every K epochs. Both come from a ``data.shuffle.Shuffler``
(default ``SeededShuffler``: a permutation depends only on the seed and the
epoch number).

The set-up, the chunk rule and the epoch-boundary policy are the run
skeleton's (``train._run``). Each chunk runs on one epoch function
``(state, data, perms) -> (state, per-epoch losses)``, picked once by the
placement: the epoch kernel on one device, ``parallel.epoch_dp`` or
``parallel.sync_dp`` on a mesh.

With a ``mesh`` (``parallel.make_mesh``, one process per device) each
rank is handed its own rows only (``parallel.rank_rows``: contiguous
shards, the inert pad rows at the global tail); the whole set's size
comes from one ``all_reduce`` of the ranks' counts, each rank pads its
own shard (``parallel.local_shard``), and the state is broadcast from
rank 0. Each epoch runs on ``parallel.epoch_dp`` (local SGD, one
collective per call) or, with ``dp_exact``, ``parallel.sync_dp`` (exact
DP, ``batches_per_launch`` batches per call and collective). Each rank
draws its own tile permutations (the default shuffler adds the rank to
its seed from rank 1 on); only rank 0 logs, validates and writes.

Lookahead: on one device the loop keeps the device one chunk ahead of
the host. Before it reads a chunk's losses back it enqueues that
chunk's epoch-boundary work (the smoothing, the checkpoint's copy to
the host) and launches the next chunk from the state the chunk leaves,
so no call between two launches waits for the device (:data:`AHEAD`
counts those epochs). The held-out loss is then taken on the chunk's
own state, which the next chunk's engine does not write. A rejected or
stopping chunk drops what was enqueued on its state (:data:`DISCARDED`),
then restores, smooths, saves or stops as the loop without lookahead
does, and launches the next chunk again on the permutations already
drawn. An error in the next chunk's shuffle or launch is raised once
this chunk is read, reported and saved (and dropped when this chunk
stops the run, which never reaches the next). With a mesh (its calls
wait inside their collectives) each chunk is read back before the next
is drawn.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

import numpy as np
import torch

from ..data.loader import ResidualDataset, pad_rows
from ..data.shuffle import SeededShuffler, Shuffler, batch_window
from ..models.params import PARAM_NAMES, QFAParams, smooth_params
from ..ops.epoch_kernel import (
    epoch_loss,
    fused_train_epoch,
    fused_train_epoch_plain,
    kernel_kwargs,
    upload,
)
from ..utils.profiling import span
from . import adam
from ._run import Run, chunk_length
from .loop import reshuffle_dataset
from .state import TrainConfig, TrainState

__all__ = ["fit_fused", "AHEAD", "DISCARDED"]

#: Epochs launched by :func:`fit_fused` before the losses of the chunk
#: before them were read back (module docstring).
AHEAD = 0
#: ... of them dropped because that chunk was rejected or stopped the run.
DISCARDED = 0


def _to_host(tensors: list[torch.Tensor]) -> Callable[[], list]:
    """Enqueue host copies of ``tensors`` (on one device) and return a
    function that waits for them and gives them. On CUDA the copies go to
    pinned memory behind the stream's work, and nothing waits for the
    device until that function is called; elsewhere they are the tensors
    themselves."""
    tensors = [t.detach() for t in tensors]
    dev = tensors[0].device
    if dev.type != "cuda":
        return lambda: tensors
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))

    def wait() -> list:
        done.synchronize()
        return host

    return wait


def _state_to_host(state: TrainState) -> Callable[[], TrainState]:
    """:func:`_to_host` of a whole state: the wait gives it as a
    ``TrainState`` of host tensors (what the checkpoint writers take)."""
    trees = (state.params, state.opt_state.m, state.opt_state.v)
    wait = _to_host([getattr(t, k) for t in trees for k in PARAM_NAMES])
    n = len(PARAM_NAMES)

    def get() -> TrainState:
        host = wait()
        p, m, v = (QFAParams.wrap(*host[i:i + n]) for i in (0, n, 2 * n))
        return TrainState(p, adam.AdamState(m=m, v=v,
                                            epoch=state.opt_state.epoch))

    return get


def _smooth(params: QFAParams) -> QFAParams:
    with span("qfa.fit_fused.smooth"):
        return smooth_params(params)


def _device_epoch_fn(engine, config: TrainConfig, loglam, n_batches: int,
                     n_real: int, tile_batch: int) -> Callable:
    """The epoch function of one device: ``engine`` (the epoch kernel or
    its plain version) over ``perms.shape[0]`` epochs in one call, and the
    reference's loss of each."""
    kw = kernel_kwargs(config, loglam)

    def epoch_fn(state: TrainState, data: ResidualDataset, perms):
        ep0, n = int(state.opt_state.epoch), perms.shape[0]
        out = engine(state.params, state.opt_state.m, state.opt_state.v,
                     data.delta, data.error, data.zabs, perms, data.mask,
                     epoch=ep0, n_batches=n_batches, n_epochs=n,
                     tile_batch=tile_batch, **kw)
        return (TrainState(out.params, adam.AdamState(m=out.m, v=out.v,
                                                      epoch=ep0 + n)),
                epoch_loss(out.loss_sums.reshape(n, -1),
                           out.n_real.reshape(n, -1), n_real,
                           config.batch_size))

    return epoch_fn


def _local_sgd_epoch_fn(make: Callable, config: TrainConfig, mesh,
                        kw: dict) -> Callable:
    """The local-SGD epoch function: ``make(config, mesh,
    epochs_per_launch=n, **kw)``'s for a chunk of n epochs, each built
    once."""
    fns: dict = {}

    def epoch_fn(state: TrainState, data: ResidualDataset, perms):
        n = perms.shape[0]
        if n not in fns:
            fns[n] = make(config, mesh, epochs_per_launch=n, **kw)
        return fns[n](state, data, perms)

    return epoch_fn


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
    batches_per_launch: int = 1,
) -> tuple[QFAParams, list]:
    """Full training run on the whole-epoch engine.

    ``data`` lies on the training device (CUDA: the kernel; CPU: the plain
    version); ``params`` (or ``initial_state``) on the same device.
    ``derive_mask`` drops the mask (the engine derives ``error > 0``);
    ``loglam`` switches to the derived layout, where ``data.zabs`` is the
    (N, 2) zq column. ``plain=True`` runs the plain version on any device.
    ``mesh`` trains over a data mesh (module docstring): ``data`` is this
    rank's rows of the set, those ``parallel.rank_rows(n_real,
    config.batch_size, mesh, tile_batch=tile_batch)`` gives it, on any
    device (each rank moves its shard to the mesh's device and pads it
    there), ``dp_exact`` selects exact DP at
    ``batches_per_launch`` batches per call (it needs a mesh and one
    epoch per call), and ``reshuffle_interval`` is refused (each rank
    reshuffles its shard through its tile permutations).
    Returns (final params, per-epoch loss history of the epochs run here).
    """
    global AHEAD, DISCARDED
    with span("qfa.fit_fused"):
        if dp_exact and mesh is None:
            raise ValueError("dp_exact=True requires a mesh")
        if dp_exact and epochs_per_launch > 1:
            raise ValueError(
                "dp_exact is incompatible with epochs_per_launch > 1: "
                "exact-DP windows are sub-epoch (use batches_per_launch to "
                "amortize calls instead)")
        if mesh is not None and reshuffle_interval:
            raise ValueError(
                "reshuffle_interval is not supported with a mesh (the shards "
                "reshuffle locally via the per-rank tile permutation)")
        run = Run("fit_fused", params, config, mu, mesh=mesh,
                  initial_state=initial_state, output_dir=output_dir,
                  save_full_state=save_full_state, logger=logger,
                  metrics_cb=metrics_cb, val_data=val_data)
        state, b = run.state, config.batch_size
        if shuffler is None:
            shuffler = SeededShuffler(seed, 0 if mesh is None else mesh.rank)
        if derive_mask:
            data = data._replace(mask=None)
        # the tile, and the rows of a batch on each rank
        tb, rows = batch_window(b // run.ndev, tile_batch)
        if mesh is None:
            n_real = data.size  # before padding: the loss divisor
            n_batches = max(-(-n_real // b), 1)
            data = pad_rows(data, n_batches * rows)
            epoch_fn = _device_epoch_fn(
                fused_train_epoch_plain if plain else fused_train_epoch,
                config, loglam, n_batches, n_real, tb)
        else:
            from ..parallel import (  # parallel imports train
                local_shard,
                make_epoch_dp_fn,
                make_sync_dp_epoch_fn,
            )

            # this rank's rows, padded to its whole shard; the loss
            # divisor counts every rank's real rows
            with span("qfa.fit_fused.shard"):
                data, n_real = local_shard(data, b, mesh,
                                           tile_batch=tile_batch)
            dp_kw = dict(tile_batch=tb, batch_rows=rows * mesh.size,
                         loglam=None if loglam is None
                         else loglam.to(mesh.device),
                         n_real=n_real, plain=plain)
            epoch_fn = make_sync_dp_epoch_fn(
                config, mesh, batches_per_launch=batches_per_launch,
                **dp_kw) if dp_exact else _local_sgd_epoch_fn(
                    make_epoch_dp_fn, config, mesh, dp_kw)
        n_tiles = data.size // tb  # this rank's
        epl = max(1, int(epochs_per_launch))
        lookahead = mesh is None

        def prepare(epoch):
            """The chunk from ``epoch``: its length and permutations,
            after the physical reshuffle that starts it."""
            nonlocal data
            chunk = chunk_length(epoch, config, epl, saves=run.saves,
                                 reshuffle=reshuffle_interval)
            with span("qfa.fit_fused.shuffle"):
                if reshuffle_interval and epoch \
                        and epoch % reshuffle_interval == 0:
                    data = reshuffle_dataset(data, upload(
                        shuffler.rows(epoch, data.size), data.delta.device))
                return chunk, torch.stack([
                    torch.as_tensor(shuffler.tiles(epoch + k, n_tiles))
                    for k in range(chunk)])

        def launch(state, perms):
            """Enqueue the chunk on ``perms``: (state after it, a function
            that reads its losses back)."""
            state, losses = epoch_fn(state, data, perms)
            wait = _to_host([losses.reshape(-1)])

            def read():
                with span("qfa.fit_fused.readback"):
                    return [float(x) for x in wait()[0]]

            return state, read

        def save(state, ckpt):
            with span("qfa.fit_fused.save"):
                run.save(state, ckpt)

        if reshuffle_interval and run.start:
            # exact resume: replay the reshuffles of the uninterrupted run
            for past in range(reshuffle_interval, run.start,
                              reshuffle_interval):
                data = reshuffle_dataset(data, upload(
                    shuffler.rows(past, data.size), data.delta.device))

        epoch = run.start
        # the chunk from ``epoch`` when the last one prepared it:
        # (chunk, perms, (state after it, read) or None when not launched)
        todo = None
        t_last = time.perf_counter()
        while epoch < config.n_epochs:
            chunk, perms, launched = todo or (*prepare(epoch), None)
            todo = failed = None
            prev_state = state  # rollback anchor
            state, read = launched or launch(state, perms)
            ckpt = epoch + chunk
            smooth_now, save_now = run.actions(ckpt)
            if lookahead:
                # the state the next chunk starts from, its checkpoint's
                # copy and the next chunk, all enqueued before the read
                nxt = state
                if smooth_now:
                    nxt = TrainState(_smooth(state.params), state.opt_state)
                if save_now:
                    snapshot = _state_to_host(nxt)
                if ckpt < config.n_epochs:
                    try:
                        n_chunk, n_perms = prepare(ckpt)
                        todo = (n_chunk, n_perms, launch(nxt, n_perms))
                    except Exception as e:
                        failed = e  # raised once this chunk is saved
                    else:
                        AHEAD += n_chunk
            losses = read()
            now = time.perf_counter()
            dt, t_last = now - t_last, now
            with span("qfa.fit_fused.check"):
                stop = run.check(epoch, losses, state)
                rejected = config.reject_nonfinite and not all(
                    np.isfinite(x) for x in losses)
                if rejected:
                    # epoch-level non-finite guard: restore params and
                    # moments, keep the advanced counter (a rejected step
                    # still counts)
                    state = TrainState(prev_state.params, adam.AdamState(
                        m=prev_state.opt_state.m, v=prev_state.opt_state.v,
                        epoch=state.opt_state.epoch))
                    if run.logger is not None:
                        run.logger.warning(
                            "epoch%s %03d%s produced non-finite loss %s: "
                            "update rejected, parameters and moments rolled"
                            " back", "s" if chunk > 1 else "", epoch,
                            f"-{epoch + chunk - 1:03d}" if chunk > 1 else "",
                            losses)
                ahead_kept = lookahead and not (rejected or stop)
                if lookahead and not ahead_kept and todo is not None:
                    # drop the next chunk's launch; keep its permutations
                    DISCARDED += todo[0]
                    todo = (*todo[:2], None)
            with span("qfa.fit_fused.report"):
                run.report(epoch, losses, dt, state.params, rejected)
            if ahead_kept:
                state = nxt
                if save_now:
                    save(snapshot(), ckpt)
            else:
                run.boundary(state, ckpt, stop, _smooth, save)
            if stop:
                break
            if failed is not None:
                raise failed
            epoch = ckpt
        return state.params, run.history
