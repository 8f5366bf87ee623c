"""Multi-device whole-epoch training: local SGD with per-epoch averaging.

The counterpart of ``qfa_tpu.parallel.epoch_dp``. Every rank runs the
epoch kernel (``ops.epoch_kernel.fused_train_epoch``) over its own shard
with local batches of ``batch_size / size`` rows, then ONE ``all_reduce``
per epoch (or per chunk of ``epochs_per_launch`` epochs) sums the
parameters and Adam moments scaled by 1 / size (their mean) and the raw
per-batch loss books, all packed into one flat float32 vector.

Local SGD with per-epoch model averaging: not the exact-DP trajectory
(each update sees 1 / size of the global batch; ``parallel.sync_dp`` is
the exact engine), but the same step count and the reference's epoch
loss, summed per global batch across ranks before the batch means.

The collective, with its pack and unpack, is the span
``qfa.epoch_dp.all_reduce`` (``utils.profiling.span``); :data:`ALL_REDUCES`
counts the calls and :data:`REDUCED_BYTES` the bytes they reduced.
"""

from __future__ import annotations

import torch

from ..data.loader import ResidualDataset
from ..ops.epoch_kernel import fused_train_epoch, fused_train_epoch_plain
from ..train import adam
from ..train.state import TrainConfig, TrainState
from ..utils.profiling import span
from ._common import (
    epoch_loss,
    kernel_kwargs,
    local_window,
    resolve_tile,
    tile_perm,
)
from .mesh import DataMesh, pack, unpack

__all__ = ["make_epoch_dp_fn", "epoch_dp_train_epoch", "ALL_REDUCES",
           "REDUCED_BYTES"]

#: ``all_reduce`` calls of the epoch functions (one per call of one)
ALL_REDUCES = 0
#: ... and the bytes of the vectors they reduced
REDUCED_BYTES = 0


def make_epoch_dp_fn(
    config: TrainConfig,
    mesh: DataMesh,
    *,
    tile_batch: int | None = None,
    batch_rows: int | None = None,
    loglam=None,
    n_real: int | None = None,
    epochs_per_launch: int = 1,
    plain: bool = False,
):
    """Multi-device epoch ``(state, data, perm) -> (state, loss)``.

    ``data`` is this rank's shard, a multiple of the local batch window
    ``(batch_rows or batch_size) / size`` (``batch_rows``: the caller's
    padded rows per update; the padding rows are inert) and of the tile:
    the rows ``parallel.rank_rows`` gives the rank, padded to
    ``parallel.shard_size`` (``parallel.local_shard``; ``fit_fused(mesh=
    ...)`` does this); the state is replicated. ``perm`` is this rank's tile
    permutation, ``(epochs_per_launch, n_local / tile)``, or a
    ``torch.Generator`` to draw it from. A ``None`` mask selects the
    derived-mask layout, as in ``fused_train_epoch``. ``loss`` is a 0-d
    tensor, or one per epoch with ``epochs_per_launch > 1`` (the replicas
    then average only at the chunk's end). ``plain=True`` runs the epoch
    kernel's plain version.
    """
    ndev = mesh.size
    b_local, b_local_rows = local_window(config, mesh, batch_rows)
    epl = int(epochs_per_launch)
    if epl < 1:
        raise ValueError(f"epochs_per_launch must be >= 1, got {epl}")
    engine = fused_train_epoch_plain if plain else fused_train_epoch
    kw = kernel_kwargs(config, loglam)

    def epoch_fn(state: TrainState, data: ResidualDataset, perm):
        global ALL_REDUCES, REDUCED_BYTES
        n_local = data.size
        tb = resolve_tile(tile_batch, b_local_rows)
        if n_local % b_local_rows or n_local % tb or not n_local:
            raise ValueError(
                f"local shard of {n_local} rows is not a whole number of "
                f"{b_local_rows}-row batch windows ({tb}-row tiles; global "
                f"batch {config.batch_size} over {ndev} devices): hand "
                "each rank the rows parallel.rank_rows gives it, padded by "
                "parallel.local_shard")
        perm = tile_perm(perm, (epl, n_local // tb), n_local // tb)
        ep0 = int(state.opt_state.epoch)
        out = engine(state.params, state.opt_state.m, state.opt_state.v,
                     data.delta, data.error, data.zabs, perm, data.mask,
                     epoch=ep0, n_batches=n_local // b_local_rows,
                     n_epochs=epl, tile_batch=tb, **kw)
        # the epoch's one collective: the mean state and the raw books
        with span("qfa.epoch_dp.all_reduce"):
            trees = (out.params, out.m, out.v)
            n_books = out.loss_sums.numel()
            vec = mesh.all_reduce(torch.cat([
                pack(trees, 1.0 / ndev), out.loss_sums.reshape(-1),
                out.n_real.reshape(-1)]))
            n_state = vec.numel() - 2 * n_books
            params, m, v = unpack(vec[:n_state], trees)
            books = vec[n_state:].view(2, epl, -1)
        ALL_REDUCES += 1
        REDUCED_BYTES += vec.numel() * vec.element_size()
        n_total = n_local * ndev if n_real is None else n_real
        loss = epoch_loss(books[0], books[1], n_total, config.batch_size)
        return (TrainState(params, adam.AdamState(m=m, v=v, epoch=ep0 + epl)),
                loss[0] if epl == 1 else loss)

    return epoch_fn


def epoch_dp_train_epoch(state: TrainState, data: ResidualDataset, perm,
                         config: TrainConfig, mesh: DataMesh, epoch_fn=None,
                         **kwargs) -> tuple[TrainState, float]:
    """Run one multi-device call; returns (state, loss), the LAST epoch's
    loss when the call runs several."""
    if epoch_fn is None:
        epoch_fn = make_epoch_dp_fn(config, mesh, **kwargs)
    state, loss = epoch_fn(state, data, perm)
    return state, float(loss.reshape(-1)[-1])
