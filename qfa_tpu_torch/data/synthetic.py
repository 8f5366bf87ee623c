"""Synthetic spectra drawn from the QFA generative model:

    h ~ N(0, I)
    C = mu + F h                      (continuum)
    S = A * C + sqrt(D_noise) * eps   (observed flux)

with ``A = exp(-tau_lya(zabs))`` on the blue side and
``D_noise = A^2 Psi + omega * zdep + error^2``. The counterpart of
``qfa_tpu.data.synthetic``; the draws come from a ``torch.Generator``,
so they differ from ``jax.random``'s for the same seed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.params import QFAParams
from ..models.qfa import absorption
from ..physics.tau import omega_func
from .batch import SpectraBatch
from .grid import LYA_WAVELENGTH, WavelengthGrid
from .loader import SpectraDataset

Tensor = torch.Tensor

__all__ = ["SyntheticSpectra", "generate"]


class SyntheticSpectra(NamedTuple):
    flux: Tensor  #: (N, Npix) observed (absorbed, noisy) flux.
    error: Tensor  #: (N, Npix) per-pixel noise sigma used.
    mask: Tensor  #: (N, Npix) float mask.
    zqso: Tensor  #: (N,)
    zabs: Tensor  #: (N, Nb)
    h: Tensor  #: (N, Nh) true latent factors.
    continuum: Tensor  #: (N, Npix) true unabsorbed continuum.

    def to_dataset(self) -> SpectraDataset:
        """Host dataset with masked pixels zeroed (the reader's layout)."""
        m = self.mask.detach().cpu().numpy() > 0
        flux = self.flux.detach().cpu().numpy()
        error = self.error.detach().cpu().numpy()
        return SpectraDataset(
            flux=np.where(m, flux, 0.0).astype(np.float32),
            error=np.where(m, error, 0.0).astype(np.float32),
            mask=m,
            zqso=self.zqso.detach().cpu().numpy().astype(np.float32),
            paths=(),
            flux_ok=m,  # synthetic masking hits flux and error together
        )

    def to_batch(self, mu, tau_which: str = "becker") -> SpectraBatch:
        """Residual batch ``delta = flux - mu * A`` ready for the
        likelihood."""
        nr = self.flux.shape[-1] - self.zabs.shape[-1]
        amp = absorption(self.zabs, nr, tau_which)
        mu = torch.as_tensor(mu, dtype=self.flux.dtype,
                             device=self.flux.device)
        return SpectraBatch(
            delta=(self.flux - mu * amp) * self.mask,
            error=self.error * self.mask,
            zabs=self.zabs,
            mask=self.mask,
            weight=torch.ones(self.flux.shape[:-1], dtype=self.flux.dtype,
                              device=self.flux.device),
        )


@torch.no_grad()
def generate(
    params: QFAParams,
    mu,
    grid: WavelengthGrid,
    n: int,
    *,
    generator: torch.Generator | None = None,
    z_range: tuple[float, float] = (2.0, 3.5),
    error_scale: float = 0.1,
    mask_frac: float = 0.0,
    tau_which: str = "becker",
) -> SyntheticSpectra:
    """Draw ``n`` spectra from the generative model on the parameters'
    device (``generator`` must live there too).

    ``mask_frac`` masks a random contiguous chunk of that fractional length
    per spectrum (emulating sky-line or bad-CCD masking).
    """
    dev = params.F.device
    f32 = dict(dtype=torch.float32, device=dev)
    npix, nh = params.F.shape
    F = params.F.detach()
    mu = torch.as_tensor(mu, **f32)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, **f32)

    zqso = uniform((n,), *z_range)
    blue = torch.as_tensor(grid.blue, **f32)
    zabs = (1.0 + zqso)[:, None] * blue / LYA_WAVELENGTH - 1.0
    h = torch.randn((n, nh), generator=generator, **f32)
    continuum = mu + h @ F.T

    amp = absorption(zabs, grid.nr, tau_which)
    zdep = omega_func(zabs, params.tau0.detach(), params.beta.detach(),
                      params.c0.detach())
    omega_full = torch.cat([params.omega.detach() * zdep,
                            torch.zeros((n, grid.nr), **f32)], dim=-1)
    error = error_scale * (0.5 + torch.rand((n, npix), generator=generator,
                                            **f32))
    # total marginal variance given h is A^2 Psi + omega zdep + error^2
    d_noise = amp * amp * params.Psi.detach() + omega_full + error * error
    noise = torch.randn((n, npix), generator=generator, **f32)
    flux = amp * continuum + torch.sqrt(d_noise) * noise

    if mask_frac > 0:
        span = max(int(mask_frac * npix), 1)
        # the chunk may reach the red edge (and the range is non-empty when
        # span == npix)
        start = torch.randint(0, npix - span + 1, (n, 1), generator=generator,
                              device=dev)
        cols = torch.arange(npix, device=dev)[None, :]
        mask = (~((cols >= start) & (cols < start + span))).to(torch.float32)
    else:
        mask = torch.ones((n, npix), **f32)

    return SyntheticSpectra(flux=flux, error=error, mask=mask, zqso=zqso,
                            zabs=zabs, h=h, continuum=continuum)
