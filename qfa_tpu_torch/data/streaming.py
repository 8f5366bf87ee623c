"""Streaming training data for datasets larger than device memory.

The resident trainers keep the whole survey on the card (four planes, ~120
KB per spectrum at DESI width). This module keeps the residual planes in
host RAM as numpy arrays and serves shuffled fixed-size batches, with the
semantics of ``qfa_tpu.data.streaming``: the permutation is drawn from the
caller's numpy ``Generator``, the tail batch is padded with copies of row 0
at weight 0, and each batch's rows are sorted (the pad entries stay last).

On a CUDA device each batch is gathered on the host into a reused pinned
staging buffer (``np.take(..., out=)``), copied to the card on a side
stream with ``non_blocking=True``, and the consumer's stream waits on the
copy's event; a staging buffer is overwritten only after its copy's event
has completed. So up to ``prefetch`` gathers and copies run ahead of the
consumer's kernels, and nothing in the iterator waits for the card's
compute. On the CPU (``device="cpu"``) batches are plain tensors.
Across ranks (``sharding``) each rank gathers and copies only its own
rows of every batch.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .batch import SpectraBatch
from .grid import WavelengthGrid
from .loader import SpectraDataset, as_f32, make_residuals
from .shuffle import local_batch

__all__ = ["HostResiduals", "make_host_residuals", "stream_batches"]

_PLANES = ("delta", "error", "zabs", "mask")


class HostResiduals(NamedTuple):
    """Residual training arrays in host RAM (numpy)."""

    delta: np.ndarray  #: (N, Npix) float32
    error: np.ndarray  #: (N, Npix) float32
    zabs: np.ndarray  #: (N, Nb) float32
    mask: np.ndarray  #: (N, Npix) float32

    @property
    def size(self) -> int:
        return self.delta.shape[0]


def make_host_residuals(
    dataset: SpectraDataset,
    grid: WavelengthGrid,
    mu: np.ndarray,
    *,
    tau_which: str = "becker",
    taus: np.ndarray | None = None,
) -> HostResiduals:
    """Host-side :func:`~qfa_tpu_torch.data.loader.make_residuals`: the
    same planes, computed on the CPU and kept as numpy arrays."""
    res = make_residuals(dataset, grid, mu, tau_which=tau_which,
                         device="cpu", taus=taus)
    return HostResiduals(*(x.numpy() for x in res))


class _PinnedStager:
    """``slots`` pinned host buffers per plane, a side stream for the
    copies, and the event of each slot's last copy."""

    def __init__(self, host: HostResiduals, batch_size: int, slots: int,
                 device: torch.device):
        self.host = host
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.bufs = [{
            k: torch.empty((batch_size,) + getattr(host, k).shape[1:],
                           dtype=torch.from_numpy(getattr(host, k)[:0]).dtype,
                           pin_memory=True)
            for k in _PLANES} for _ in range(slots)]
        self.events: list[torch.cuda.Event | None] = [None] * slots

    def put(self, slot: int, idx: np.ndarray) -> tuple[dict, torch.cuda.Event]:
        ev = self.events[slot]
        if ev is not None:
            ev.synchronize()  # the slot's previous copy has finished
        buf = self.bufs[slot]
        for k in _PLANES:
            # idx is a valid permutation slice: "clip" only skips the
            # buffered copy that "raise" makes with out=
            np.take(getattr(self.host, k), idx, axis=0, out=buf[k].numpy(),
                    mode="clip")
        with torch.cuda.stream(self.stream):
            planes = {k: buf[k].to(self.device, non_blocking=True)
                      for k in _PLANES}
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.events[slot] = ev
        return planes, ev


def stream_batches(
    host: HostResiduals,
    batch_size: int,
    rng: np.random.Generator,
    *,
    prefetch: int = 2,
    device="cuda",
    sharding=None,
    drop_remainder: bool = False,
) -> Iterator[SpectraBatch]:
    """Shuffled epoch iterator over ``host`` with device prefetch.

    Yields :class:`SpectraBatch` objects on ``device`` (a visible CUDA
    device, or ``"cpu"``; a CUDA device that is not visible raises here);
    up to ``prefetch`` batches are gathered and copied ahead of the
    consumer. The tail batch is padded with weight-0 copies of row 0 so
    every spectrum trains each epoch; ``drop_remainder=True`` drops the
    tail instead. ``rng.permutation`` is drawn once per call, as in the
    JAX package, so the same ``np.random.default_rng(seed)`` gives the
    same batches.

    ``sharding`` (a ``parallel.mesh.DataMesh``) yields only this rank's
    rows of every batch, on the mesh's device: rank ``d`` of ``D`` gets
    rows ``[d B / D, (d + 1) B / D)`` of the sorted batch, pad entries
    and their zero weights included, where JAX's ``device_put`` with
    ``P('data')`` puts them on device ``d``. ``B`` must divide by ``D``.
    """
    if sharding is not None:
        local_batch(batch_size, sharding.size)
        device = sharding.device
    dev = resolve_device(device)
    n = host.size
    if drop_remainder:
        n_batches, tail = n // batch_size, 0
    else:
        n_batches = -(-n // batch_size)
        tail = n_batches * batch_size - n
    perm = rng.permutation(n)
    if tail:
        perm = np.concatenate([perm, np.zeros((tail,), perm.dtype)])
    perm = perm[: n_batches * batch_size].reshape(n_batches, batch_size)
    local = slice(0, batch_size) if sharding is None else \
        slice(sharding.rank * batch_size // sharding.size,
              (sharding.rank + 1) * batch_size // sharding.size)
    return _iterate(host, perm, tail, max(int(prefetch), 0), dev, local)


def _iterate(host, perm, tail, prefetch, dev, local
             ) -> Iterator[SpectraBatch]:
    n_batches, batch_size = perm.shape
    rows_here = local.stop - local.start
    cuda = dev.type == "cuda"
    stager = _PinnedStager(host, rows_here, prefetch + 1, dev) if cuda \
        else None
    full_weight = torch.ones((rows_here,), dtype=torch.float32, device=dev)

    def rows(i):
        if tail and i == n_batches - 1:
            # pad entries sit at the end of the last batch; keep them last
            # through the sort so the weights line up
            real = np.sort(perm[i][: batch_size - tail])
            return np.concatenate([real, perm[i][batch_size - tail:]])[local]
        return np.sort(perm[i])[local]

    def put(i):
        idx = rows(i)
        if cuda:
            return stager.put(i % (prefetch + 1), idx)
        return {k: torch.from_numpy(getattr(host, k)[idx]) for k in _PLANES}, \
            None

    queue = [put(i) for i in range(min(prefetch, n_batches))]
    for i in range(n_batches):
        if i + prefetch < n_batches:
            queue.append(put(i + prefetch))
        planes, ev = queue.pop(0)
        if tail and i == n_batches - 1:
            weight = torch.ones((batch_size,), dtype=torch.float32,
                                device=dev)
            weight[batch_size - tail:] = 0.0
            weight = weight[local]
        else:
            weight = full_weight
        if cuda:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(ev)
            for t in planes.values():
                # allocated on the side stream, used on the consumer's
                t.record_stream(consumer)
        yield SpectraBatch(
            delta=as_f32(planes["delta"]),
            error=as_f32(planes["error"]),
            zabs=as_f32(planes["zabs"]),
            mask=planes["mask"],
            weight=weight,
        )
