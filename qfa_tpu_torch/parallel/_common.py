"""Pieces the data-parallel engines share: the per-rank batch window and
tile, and the per-rank tile permutation (the epoch kernel's keywords and
loss books come from ``ops.epoch_kernel``)."""

from __future__ import annotations

import numpy as np
import torch

from ..data.shuffle import batch_window, local_batch
from ..ops.epoch_kernel import epoch_loss, kernel_kwargs

__all__ = ["local_window", "resolve_tile", "tile_perm", "kernel_kwargs",
           "epoch_loss"]


def local_window(config, mesh, batch_rows: int | None) -> tuple[int, int]:
    """``(b_local, b_local_rows)``: real rows of a batch on each rank, and
    the rows each local update spans (``batch_rows`` / size when the
    caller padded batches; ``fit_fused`` passes ``batch_rows``)."""
    ndev = mesh.size
    b_local = local_batch(config.batch_size, ndev)
    if batch_rows is not None and batch_rows % ndev:
        raise ValueError(f"batch_rows {batch_rows} not divisible by the "
                         f"{ndev}-device mesh")
    return b_local, b_local if batch_rows is None else batch_rows // ndev


def resolve_tile(tile_batch: int | None, b_local_rows: int) -> int:
    """The tile of the per-rank batch window (``data.shuffle.batch_window``);
    it must divide the window (this layer does not pad)."""
    tb = batch_window(b_local_rows, tile_batch)[0]
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
