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

With a ``mesh`` (``parallel.make_mesh``, one process per device) the
padded dataset is split by rows over the ranks and the state broadcast
from rank 0; each epoch runs on ``parallel.epoch_dp`` (local SGD, one
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
from typing import Callable, Protocol

import numpy as np
import torch

from ..data.loader import ResidualDataset
from ..models.params import PARAM_NAMES, QFAParams, smooth_params
from ..ops.epoch_kernel import (
    fused_train_epoch,
    fused_train_epoch_plain,
    upload,
)
from ..utils.profiling import raise_if_nonfinite, span
from . import adam
from .loop import (
    TrainConfig,
    TrainState,
    make_ckpt_saver,
    make_val_fn,
    reshuffle_dataset,
)

__all__ = ["Shuffler", "SeededShuffler", "pick_tiling", "fit_fused",
           "AHEAD", "DISCARDED"]

#: Epochs launched by :func:`fit_fused` before the losses of the chunk
#: before them were read back (module docstring).
AHEAD = 0
#: ... of them dropped because that chunk was rejected or stopped the run.
DISCARDED = 0


class Shuffler(Protocol):
    """Source of the per-epoch permutations of :func:`fit_fused`."""

    def tiles(self, epoch: int, n_tiles: int) -> torch.Tensor:
        """Tile permutation of ``epoch``: ``n_tiles`` int64 indices."""

    def rows(self, epoch: int, n_rows: int) -> torch.Tensor:
        """Row permutation of the physical reshuffle at ``epoch``."""


class SeededShuffler:
    """Permutations from ``torch.Generator``s seeded with (seed, epoch,
    stream): tile permutations on stream 0, row reshuffles on stream 1;
    ``rank`` > 0 (a rank of a data mesh) joins the seed, so that every
    rank shuffles its shard its own way and rank 0 the single-device
    way."""

    def __init__(self, seed: int = 0, rank: int = 0):
        self.seed = int(seed)
        self.rank = int(rank)

    def _generator(self, epoch: int, stream: int) -> torch.Generator:
        entropy = [self.seed, int(epoch), stream]
        if self.rank:
            entropy.append(self.rank)
        state = np.random.SeedSequence(entropy)
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
    batches_per_launch: int = 1,
) -> tuple[QFAParams, list]:
    """Full training run on the whole-epoch engine.

    ``data`` lies on the training device (CUDA: the kernel; CPU: the plain
    version); ``params`` (or ``initial_state``) on the same device.
    ``derive_mask`` drops the mask (the engine derives ``error > 0``);
    ``loglam`` switches to the derived layout, where ``data.zabs`` is the
    (N, 2) zq column. ``plain=True`` runs the plain version on any device.
    ``mesh`` trains over a data mesh (module docstring): ``data`` is the
    whole dataset on every rank (on any device; each rank keeps its rows
    on the mesh's device), ``dp_exact`` selects exact DP at
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
        ndev = 1 if mesh is None else mesh.size
        writer = mesh is None or mesh.rank == 0  # logs, validates, writes
        if shuffler is None:
            shuffler = SeededShuffler(seed, 0 if mesh is None else mesh.rank)
        state = initial_state if initial_state is not None \
            else TrainState(params, adam.init(params))
        start_epoch = int(state.opt_state.epoch)
        b = config.batch_size
        if b % ndev:
            raise ValueError(f"batch size {b} not divisible by the "
                             f"{ndev}-device mesh")
        n_real = data.size  # before padding: the loss divisor
        if derive_mask:
            data = data._replace(mask=None)
        b_shard = b // ndev  # real rows of a batch on each rank
        if tile_batch is None:
            tb, shard_rows = pick_tiling(b_shard)
        else:
            tb = max(1, min(int(tile_batch), b_shard))
            shard_rows = -(-b_shard // tb) * tb
        batch_rows = shard_rows * ndev  # rows each update spans, all ranks
        n_batches = max(-(-n_real // b), 1)
        data = _pad_rows(data, n_batches * batch_rows - data.size)
        engine = fused_train_epoch_plain if plain else fused_train_epoch
        if mesh is not None:
            from ..parallel import (
                make_epoch_dp_fn,
                make_sync_dp_epoch_fn,
                replicated,
                shard_dataset,
            )

            data = shard_dataset(data, mesh)
            if loglam is not None:
                loglam = loglam.to(mesh.device)
            state = replicated(state, mesh)
            dp_kw = dict(tile_batch=tb, batch_rows=batch_rows, loglam=loglam,
                         n_real=n_real, plain=plain)
            sync_fn = make_sync_dp_epoch_fn(
                config, mesh, batches_per_launch=batches_per_launch,
                **dp_kw) if dp_exact else None
            chunk_fns: dict = {}  # chunk size -> local-SGD epoch function
        n_tiles = data.size // tb  # this rank's
        val_fn = make_val_fn(val_data, config.options) if writer else None
        if isinstance(mu, torch.Tensor):
            mu = mu.detach().cpu()  # once, not a device read per save
        _save = make_ckpt_saver(output_dir, mu, save_full_state)
        save_dir = output_dir if writer else None  # chunks end alike on all
        if not writer:
            logger = metrics_cb = None
        lookahead = mesh is None

        def draw(epoch, chunk):
            """The tile permutations of ``chunk`` epochs from ``epoch``."""
            return torch.stack([torch.as_tensor(shuffler.tiles(epoch + k,
                                                               n_tiles))
                                for k in range(chunk)])

        def prepare(epoch):
            """The chunk from ``epoch``, ending exactly at the next
            epoch-boundary action: its length and permutations, after the
            physical reshuffle that starts it."""
            nonlocal data
            chunk = min(epl, config.n_epochs - epoch,
                        config.smooth_interval
                        - epoch % config.smooth_interval)
            if output_dir:
                chunk = min(chunk, config.save_interval
                            - epoch % config.save_interval)
            if reshuffle_interval:
                chunk = min(chunk,
                            reshuffle_interval - epoch % reshuffle_interval)
            with span("qfa.fit_fused.shuffle"):
                if reshuffle_interval and epoch \
                        and epoch % reshuffle_interval == 0:
                    data = reshuffle_dataset(data, upload(
                        shuffler.rows(epoch, data.size), data.delta.device))
                return chunk, draw(epoch, chunk)

        def launch(state, epoch, chunk, perms):
            """Enqueue ``chunk`` epochs from ``epoch`` on ``perms``: (state
            after them, a function that reads their losses back)."""
            if mesh is not None:
                if sync_fn is not None:
                    state, loss = sync_fn(state, data, perms[0])
                else:
                    fn = chunk_fns.get(chunk)
                    if fn is None:
                        fn = chunk_fns[chunk] = make_epoch_dp_fn(
                            config, mesh, epochs_per_launch=chunk, **dp_kw)
                    state, loss = fn(state, data, perms)
                wait = _to_host([loss.reshape(-1)])
            else:
                out = engine(
                    state.params, state.opt_state.m, state.opt_state.v,
                    data.delta, data.error, data.zabs, perms, data.mask,
                    epoch=epoch, n_batches=n_batches, n_epochs=chunk,
                    loglam=loglam, derive_zabs=loglam is not None,
                    tile_batch=tb, learning_rate=config.learning_rate,
                    weight_decay=config.weight_decay,
                    decay_alpha=config.decay_alpha,
                    decay_step=config.decay_step, b1=config.b1,
                    b2=config.b2, eps=config.eps, bounds=config.bounds,
                    tau_which=config.options.tau_which,
                    reference_norm=config.reference_norm,
                    mxu_bf16=config.mxu_bf16, bwd_wide=config.bwd_wide,
                )
                state = TrainState(out.params, adam.AdamState(
                    m=out.m, v=out.v, epoch=epoch + chunk))
                # reference epoch loss: sum of batch means over
                # floor(N_real / B)
                means = out.loss_sums.reshape(chunk, -1) / torch.clamp(
                    out.n_real.reshape(chunk, -1), min=1.0)
                wait = _to_host([means.sum(dim=1) / max(n_real // b, 1)])

            def read():
                with span("qfa.fit_fused.readback"):
                    return [float(x) for x in wait()[0]]

            return state, read

        if reshuffle_interval and start_epoch:
            # exact resume: replay the reshuffles of the uninterrupted run
            for past in range(reshuffle_interval, start_epoch,
                              reshuffle_interval):
                data = reshuffle_dataset(data, upload(
                    shuffler.rows(past, data.size), data.delta.device))

        history: list = []
        epl = max(1, int(epochs_per_launch))
        epoch = start_epoch
        # the chunk from ``epoch`` when the last one prepared it:
        # (chunk, perms, (state after it, read) or None when not launched)
        todo = None
        t_last = time.perf_counter()
        while epoch < config.n_epochs:
            chunk, perms, launched = todo or (*prepare(epoch), None)
            todo = failed = None
            prev_state = state  # rollback anchor
            state, read = launched or launch(state, epoch, chunk, perms)
            ckpt = epoch + chunk
            smooth_now = ckpt % config.smooth_interval == 0
            save_now = save_dir and ckpt % config.save_interval == 0
            if lookahead:
                # the state the next chunk starts from, its checkpoint's
                # copy and the next chunk, all enqueued before the read
                nxt = state
                if smooth_now:
                    with span("qfa.fit_fused.smooth"):
                        nxt = TrainState(smooth_params(state.params),
                                         state.opt_state)
                if save_now:
                    snapshot = _state_to_host(nxt)
                if ckpt < config.n_epochs:
                    try:
                        n_chunk, n_perms = prepare(ckpt)
                        todo = (n_chunk, n_perms,
                                launch(nxt, ckpt, n_chunk, n_perms))
                    except Exception as e:
                        failed = e  # raised once this chunk is saved
                    else:
                        AHEAD += n_chunk
            losses = read()
            now = time.perf_counter()
            dt, t_last = now - t_last, now
            with span("qfa.fit_fused.check"):
                raise_if_nonfinite(
                    f"fit_fused epoch{'s' if chunk > 1 else ''} {epoch}"
                    + (f"-{epoch + chunk - 1}" if chunk > 1 else ""), losses,
                    params=state.params, opt_state=state.opt_state)
                history.extend(losses)
                rejected = config.reject_nonfinite and not all(
                    np.isfinite(x) for x in losses)
                if rejected:
                    # epoch-level non-finite guard: restore params and
                    # moments, keep the advanced counter (a rejected step
                    # still counts)
                    state = TrainState(prev_state.params, adam.AdamState(
                        m=prev_state.opt_state.m, v=prev_state.opt_state.v,
                        epoch=state.opt_state.epoch))
                    if logger is not None:
                        logger.warning(
                            "epoch%s %03d%s produced non-finite loss %s: "
                            "update rejected, parameters and moments rolled"
                            " back", "s" if chunk > 1 else "", epoch,
                            f"-{epoch + chunk - 1:03d}" if chunk > 1 else "",
                            losses)
                stop = config.stop_on_negative_loss and any(x < 0.0
                                                            for x in losses)
                ahead_kept = lookahead and not (rejected or stop)
                if lookahead and not ahead_kept and todo is not None:
                    # drop the next chunk's launch; keep its permutations
                    DISCARDED += todo[0]
                    todo = (*todo[:2], None)
            with span("qfa.fit_fused.report"):
                val_loss = None if val_fn is None or rejected \
                    else val_fn(state.params)
                for k, loss in enumerate(losses):
                    if logger is not None and not rejected:
                        msg = (f"epoch: {epoch + k:03d}/"
                               f"{config.n_epochs:03d}  ;  loss:  "
                               f"{loss:.2f}  ;  time:  {dt / chunk:.2f} s")
                        if val_loss is not None and k == chunk - 1:
                            msg += f"  ;  val_loss:  {val_loss:.2f}"
                        logger.info(msg)
                    if metrics_cb is not None:
                        metrics_cb(epoch + k, loss, dt / chunk)
            if ahead_kept:
                state = nxt
                if save_now:
                    with span("qfa.fit_fused.save"):
                        _save(snapshot(), ckpt)
            else:
                if stop or smooth_now:
                    with span("qfa.fit_fused.smooth"):
                        state.params = smooth_params(state.params)
                if save_dir and (stop or save_now):
                    with span("qfa.fit_fused.save"):
                        _save(state, ckpt)
            if stop:
                break
            if failed is not None:
                raise failed
            epoch = ckpt
        return state.params, history
