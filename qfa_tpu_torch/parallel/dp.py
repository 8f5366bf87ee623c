"""Per-batch exact data-parallel training.

The counterpart of ``qfa_tpu.parallel.dp``, the cross-check engine of the
whole-epoch ones (``parallel.sync_dp`` is the production exact DP),
what ``train.fit(mesh=...)`` runs, and (its step,
:func:`make_dp_step_fn`) what ``train.fit_streaming(sharding=...)`` runs.
The dataset is sharded over the ranks by rows (:func:`shard_dataset`),
the state replicated; every batch, each rank gathers its local
sub-batch from its shard, computes its summed loss, real rows, gradients
and counts, and ONE ``all_reduce`` of all of them, packed into one flat
float32 vector, gives every rank the global sums the single-device step
normalizes: per-element counts (the reference's
averaging) or the real rows. Adam, the clip and the non-finite guard
follow on the device; nothing waits on the host within the epoch.

``engine="xla"`` takes the sums from autograd (``models.qfa.summed_stats``),
``engine="pallas"`` from the step kernel (``ops.fused_step``). Each rank
shuffles its own shard: shard assignment and a per-shard permutation
make a valid global shuffle of i.i.d. data.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..data.batch import SpectraBatch
from ..data.loader import EpochIndices, ResidualDataset, as_f32, pad_rows
from ..data.shuffle import local_batch
from ..models.params import PARAM_NAMES, QFAParams
from ..models.qfa import GradCounts, normalize_with_counts, summed_stats
from ..train import adam
from ..train.state import TrainConfig, TrainState, apply_step
from .mesh import DataMesh, count_rows, shard_leaves, shard_size

__all__ = [
    "local_shard",
    "shard_dataset",
    "shard_epoch_indices",
    "make_dp_epoch_fn",
    "make_dp_step_fn",
    "dp_train_epoch",
]


def shard_dataset(data: ResidualDataset, mesh: DataMesh) -> ResidualDataset:
    """This rank's rows of the (padded) dataset, on its device; ``None``
    leaves pass."""
    return ResidualDataset(*(shard_leaves(x, mesh) for x in data))


def local_shard(data: ResidualDataset, batch_size: int | None,
                mesh: DataMesh, *, tile_batch: int | None = None
                ) -> tuple[ResidualDataset, int]:
    """``(shard, n_real)``: this rank's rows of the set (``data``: the rows
    :func:`~qfa_tpu_torch.parallel.mesh.rank_rows` gives it, and no
    other) on the mesh's device, padded with inert zero rows to
    :func:`~qfa_tpu_torch.parallel.mesh.shard_size`; and the whole set's
    real rows, learned from the ranks' counts
    (:func:`~qfa_tpu_torch.parallel.mesh.count_rows`, one
    ``all_reduce``). ``None`` leaves pass."""
    n_real = count_rows(data.size, batch_size, mesh, tile_batch=tile_batch)
    data = ResidualDataset(*(None if x is None else
                             x.to(mesh.device).contiguous() for x in data))
    return pad_rows(data, shard_size(n_real, batch_size, mesh.size,
                                     tile_batch=tile_batch)), n_real


def shard_epoch_indices(generator: torch.Generator | None, n: int,
                        batch_size: int, mesh: DataMesh, *,
                        n_real: int | None = None, perm=None
                        ) -> EpochIndices:
    """This rank's shuffled epoch indices and weights, each
    ``(n_batches, batch_size / size)``: local rows of its shard, drawn by
    ``torch.randperm(n / size, generator=generator)`` or given as
    ``perm``. Weights are 0 on the tail batch's pad entries and on the
    dataset's padding rows (global rows ``>= n_real``), so every real
    spectrum trains once per epoch."""
    ndev = mesh.size
    if n % ndev:
        raise ValueError(f"dataset size {n} not divisible by {ndev} devices")
    local_bs = local_batch(batch_size, ndev)
    n_real = n if n_real is None else n_real
    shard_n = n // ndev
    n_batches = -(-shard_n // local_bs)
    pad = n_batches * local_bs - shard_n
    p = torch.randperm(shard_n, generator=generator) if perm is None \
        else torch.tensor(np.asarray(perm), dtype=torch.int64).reshape(-1)
    if p.numel() != shard_n:
        raise ValueError(f"perm has {p.numel()} entries, the shard "
                         f"{shard_n} rows")
    real = (p + mesh.rank * shard_n < n_real).to(torch.float32)
    idx = torch.cat([p, torch.zeros((pad,), dtype=p.dtype)])
    wt = torch.cat([real, torch.zeros((pad,), dtype=torch.float32)])
    return EpochIndices(idx=idx.reshape(n_batches, local_bs),
                        weight=wt.reshape(n_batches, local_bs))


def make_dp_step_fn(config: TrainConfig, mesh: DataMesh, *,
                    engine: str = "xla", tile_batch: int | None = None
                    ) -> Callable:
    """Exact data-parallel training step ``(state, batch) -> (state,
    loss)``: ``batch`` holds this rank's rows of the global batch, the
    state is replicated. The rank's summed loss, real rows, gradients and
    counts go through ONE ``all_reduce``, packed into one flat float32
    vector; every rank then normalizes the global sums as the
    single-device step does, and Adam, the clip and the non-finite guard
    follow on the device. ``loss`` (a 0-d tensor) is the global batch's
    mean, equal on every rank. ``engine="xla"`` takes the sums from
    autograd (``models.qfa.summed_stats``), ``engine="pallas"`` from the
    step kernel (``ops.fused_step``, with ``tile_batch``)."""
    if engine not in ("xla", "pallas"):
        raise ValueError(f"unknown dp engine {engine!r}")
    adam_cfg = config.adam_config()

    def local_sums(params: QFAParams, batch: SpectraBatch):
        if engine == "pallas":
            from ..ops.fused_step import fused_loss_grads

            out = fused_loss_grads(params, batch, config.options.tau_which,
                                   tile_batch or 256)
            return (out.loss_sum, batch.weight.sum(), out.grads,
                    out.counts)
        return summed_stats(params, batch, config.options)

    def step(state: TrainState, batch: SpectraBatch):
        total, n_batch, grads, counts = local_sums(state.params, batch)
        # the step's one collective: every global sum at once
        vec = mesh.all_reduce(torch.cat(
            [total.reshape(1), n_batch.reshape(1).to(torch.float32)]
            + [getattr(grads, k).reshape(-1) for k in PARAM_NAMES]
            + [counts.pix.reshape(-1), counts.scalar.reshape(1)]))
        total, n_batch = vec[0], vec[1]
        off, g = 2, {}
        for k in PARAM_NAMES:
            ref = getattr(state.params, k)
            g[k] = vec[off:off + ref.numel()].view(ref.shape)
            off += ref.numel()
        counts = GradCounts(pix=vec[off:-1], scalar=vec[-1])
        grads = QFAParams(**g).requires_grad_(False)
        n_batch = torch.clamp(n_batch, min=1.0)
        if config.reference_norm:
            grads = normalize_with_counts(grads, counts)
        else:
            grads = QFAParams(*(getattr(grads, k) / n_batch
                                for k in PARAM_NAMES)).requires_grad_(False)
        return apply_step(config, adam_cfg, state, total / n_batch, grads)

    return step


def make_dp_epoch_fn(config: TrainConfig, mesh: DataMesh, *,
                     engine: str = "xla", tile_batch: int | None = None,
                     n_real: int | None = None) -> Callable:
    """One-epoch function ``(state, data, ei) -> (state, mean_loss)`` of
    :func:`make_dp_step_fn` updates: ``data`` is this rank's shard
    (:func:`shard_dataset`, with its mask plane), ``ei`` its
    :func:`shard_epoch_indices`; the state stays replicated.
    ``mean_loss`` is a 0-d tensor (the sum of the batch means over
    ``floor(n_real / batch_size)``) and the Adam counter advances by one.
    ``tile_batch`` is passed to the step kernel."""
    ndev = mesh.size
    local_bs = config.batch_size // ndev
    if tile_batch is not None and local_bs % min(tile_batch, local_bs):
        raise ValueError(
            f"tile_batch {tile_batch} does not divide the per-device batch "
            f"{local_bs} (global batch {config.batch_size} over {ndev} "
            "devices)")
    step = make_dp_step_fn(config, mesh, engine=engine, tile_batch=tile_batch)

    def epoch_fn(state: TrainState, data: ResidualDataset, ei: EpochIndices):
        dev = data.delta.device
        idx = ei.idx.to(dev, torch.long)
        wt = ei.weight.to(dev, torch.float32)
        losses = []
        for i in range(idx.shape[0]):
            b_idx, b_wt = idx[i], wt[i]
            batch = SpectraBatch(
                delta=as_f32(data.delta[b_idx]),
                error=as_f32(data.error[b_idx]),
                zabs=as_f32(data.zabs[b_idx]),
                mask=data.mask[b_idx] * b_wt[:, None],
                weight=b_wt)
            state, loss = step(state, batch)
            losses.append(loss)
        n_total = n_real if n_real is not None else data.size * ndev
        niter = max(n_total // config.batch_size, 1)
        return (TrainState(state.params, adam.next_epoch(state.opt_state)),
                torch.stack(losses).sum() / niter)

    return epoch_fn


def dp_train_epoch(state: TrainState, data: ResidualDataset,
                   generator: torch.Generator | None, config: TrainConfig,
                   mesh: DataMesh, epoch_fn=None) -> tuple[TrainState, float]:
    """Run one data-parallel epoch; returns (state, mean loss)."""
    if epoch_fn is None:
        epoch_fn = make_dp_epoch_fn(config, mesh)
    ei = shard_epoch_indices(generator, data.size * mesh.size,
                             config.batch_size, mesh)
    state, loss = epoch_fn(state, data, ei)
    return state, float(loss)
