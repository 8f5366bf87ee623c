"""The epoch shuffles and the batch tiling of the trainers: a
permutation depends only on the seed and the epoch number, and on the GPU
the tile is only the shuffle's granule."""

from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

__all__ = ["Shuffler", "SeededShuffler", "pick_tiling", "batch_window",
           "local_batch"]


class Shuffler(Protocol):
    """Source of the per-epoch permutations of the trainers."""

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


def batch_window(batch_rows: int, tile_batch: int | None = None
                 ) -> tuple[int, int]:
    """``(tile, window rows)`` of a batch of ``batch_rows`` real rows:
    :func:`pick_tiling`'s when ``tile_batch`` is None (the window is the
    batch), else ``tile_batch`` capped at the batch, with the window
    rounded up to whole tiles (its extra rows are inert padding)."""
    if tile_batch is None:
        return pick_tiling(batch_rows)
    tb = max(1, min(int(tile_batch), batch_rows))
    return tb, -(-batch_rows // tb) * tb


def local_batch(batch_size: int, size: int) -> int:
    """The real rows of a batch on each rank of a ``size``-device mesh;
    the batch has to divide by the mesh."""
    if batch_size % size:
        raise ValueError(f"batch size {batch_size} not divisible by the "
                         f"{size}-device mesh")
    return batch_size // size
