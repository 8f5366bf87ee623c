"""Pieces the data-parallel engines share: the per-rank batch window and
tile, the per-rank tile permutation, and the engines' hyper-parameters of
the epoch kernel."""

from __future__ import annotations

import numpy as np
import torch

from ..train.fused_engine import pick_tiling


def local_window(config, mesh, batch_rows: int | None) -> tuple[int, int]:
    """``(b_local, b_local_rows)``: real rows of a batch on each rank, and
    the rows each local update spans (``batch_rows`` / size when the
    caller padded batches; ``fit_fused`` passes ``batch_rows``)."""
    ndev = mesh.size
    if config.batch_size % ndev:
        raise ValueError(f"batch size {config.batch_size} not divisible by "
                         f"the {ndev}-device mesh")
    if batch_rows is not None and batch_rows % ndev:
        raise ValueError(f"batch_rows {batch_rows} not divisible by the "
                         f"{ndev}-device mesh")
    b_local = config.batch_size // ndev
    return b_local, b_local if batch_rows is None else batch_rows // ndev


def resolve_tile(tile_batch: int | None, b_local_rows: int) -> int:
    """The tile of the per-rank batch window: ``pick_tiling``'s power of
    two when None, else ``tile_batch`` capped at the window; it must
    divide the window (this layer does not pad)."""
    tb = pick_tiling(b_local_rows)[0] if tile_batch is None \
        else min(int(tile_batch), b_local_rows)
    if b_local_rows % tb:
        raise ValueError(
            f"tile_batch {tb} does not divide the local batch window of "
            f"{b_local_rows} rows: pass batch_rows from the caller's "
            "padding (fit_fused(mesh=...) does this)")
    return tb


def tile_perm(perm, shape, n_tiles: int) -> torch.Tensor:
    """This rank's tile permutation, int64 on the CPU, its values checked
    to lie in ``[0, n_tiles)``: ``perm`` as given (a tensor or an array),
    or drawn from ``perm`` when it is a ``torch.Generator`` (one
    ``randperm(n_tiles)`` per row of ``shape``)."""
    if isinstance(perm, torch.Generator):
        rows = shape[0] if len(shape) > 1 else 1
        perm = torch.stack([torch.randperm(n_tiles, generator=perm)
                            for _ in range(rows)])
    # a tensor stays a tensor: on the card's host a torch.tensor of the
    # numpy copy took most of a graph epoch's host time
    # (dp_host_profile.py)
    perm = (perm.detach().to("cpu", torch.int64) if isinstance(
        perm, torch.Tensor) else torch.as_tensor(
            np.asarray(perm), dtype=torch.int64)).reshape(shape)
    if perm.numel() and (int(perm.min()) < 0 or int(perm.max()) >= n_tiles):
        raise ValueError(f"tile_perm values must lie in [0, {n_tiles})")
    return perm


def kernel_kwargs(config, loglam) -> dict:
    """The epoch kernel's keyword arguments of a run's configuration."""
    return dict(
        loglam=loglam, derive_zabs=loglam is not None,
        learning_rate=config.learning_rate,
        weight_decay=config.weight_decay, decay_alpha=config.decay_alpha,
        decay_step=config.decay_step, b1=config.b1, b2=config.b2,
        eps=config.eps, bounds=config.bounds,
        tau_which=config.options.tau_which,
        reference_norm=config.reference_norm, mxu_bf16=config.mxu_bf16,
        bwd_wide=config.bwd_wide)


def epoch_loss(loss_sums, n_reals, n_total: int, batch_size: int):
    """The reference's epoch loss (a tensor): the sum of the batch means
    over ``max(n_total // batch_size, 1)``, along the last axis."""
    means = loss_sums / torch.clamp(n_reals, min=1.0)
    return means.sum(dim=-1) / max(n_total // batch_size, 1)
