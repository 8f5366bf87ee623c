"""Fixed-shape batch container for spectra.

Every spectrum lives on the full wavelength grid; missing pixels are
carried entirely by ``mask``. Padding rows are all-masked with
``weight = 0`` and contribute exactly zero to the likelihood.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

__all__ = ["SpectraBatch", "pad_batch"]


class SpectraBatch(NamedTuple):
    """A batch of residual spectra ready for the likelihood.

    ``delta`` is the residual field ``flux - mu * A`` (masked pixels
    zeroed), as produced by the data layer or :func:`models.qfa.make_delta`.
    """

    delta: Tensor  #: (B, Npix) residual flux.
    error: Tensor  #: (B, Npix) per-pixel noise sigma (0 where masked).
    zabs: Tensor  #: (B, Nb) per-pixel absorber redshifts (blue side).
    mask: Tensor  #: (B, Npix) 1 = observed, 0 = missing.
    weight: Tensor  #: (B,) 1 = real spectrum, 0 = padding row.

    @property
    def batch_size(self) -> int:
        return self.delta.shape[0]

    @property
    def npix(self) -> int:
        return self.delta.shape[-1]

    @property
    def nb(self) -> int:
        return self.zabs.shape[-1]


def pad_batch(batch: SpectraBatch, target: int) -> SpectraBatch:
    """Pad a batch with all-masked zero-weight rows up to ``target`` rows."""
    b = batch.batch_size
    if b == target:
        return batch
    if b > target:
        raise ValueError(f"batch of {b} rows cannot be padded down to {target}")
    extra = target - b

    def pad(x: Tensor) -> Tensor:
        return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])

    return SpectraBatch(*(pad(x) for x in batch))
