"""Inputs of every cell, made on the device from the seed.

A plain-torch copy of the QFA generative model (arXiv:2207.02788), written
for the benchmark and independent of the program:

    h ~ N(0, I_Nh),   C = mu + F h               (continuum)
    S = A(z) C + sqrt(A^2 Psi + omega zdep(z) + sigma^2) eps

with the Ly-alpha absorption ``A = exp(-tau_becker(zabs))`` on the blue
side, ``zdep = (1 - c0 - exp(-tau0 (1+zabs)^beta))^2``, pixel noise
``sigma`` drawn per pixel from the traffic's range, and one contiguous
chunk of ``mask_frac`` of the pixels masked in every spectrum. Masked
pixels carry flux 0 and error 0 (the readers' sanitized layout), so the
mask is ``error > 0``.

Everything is drawn by one ``torch.Generator`` on the device in chunks of
rows, so no full-size temporary exists beside the planes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LYA = 1215.6701  # Ly-alpha rest wavelength, Angstrom

#: Becker et al. 2012 (arXiv:1208.2584) mean optical depth
BECKER = (0.751, 2.90, -0.132, 3.5)


class Grid(NamedTuple):
    wav: np.ndarray  #: (Npix,) rest-frame wavelengths, log-uniform
    nb: int  #: pixels bluer than Ly-alpha

    @property
    def npix(self) -> int:
        return len(self.wav)


def make_grid(cfg: dict) -> Grid:
    """``10^arange(log10 lam_min, log10 lam_max, dloglam)``; checks the
    configuration's stated widths."""
    wav = 10.0 ** np.arange(np.log10(cfg["lam_min"]), np.log10(cfg["lam_max"]),
                            cfg["dloglam"])
    grid = Grid(wav, int(np.sum(wav < LYA)))
    if (grid.npix, grid.nb) != (cfg["npix"], cfg["nb"]):
        raise ValueError(f"{cfg['name']}: grid gives Npix {grid.npix}, Nb "
                         f"{grid.nb}; the file states {cfg['npix']}, "
                         f"{cfg['nb']}")
    return grid


def tau_becker(z: torch.Tensor) -> torch.Tensor:
    t0, beta, c, z0 = BECKER
    return t0 * ((1.0 + z) / (1.0 + z0)) ** beta + c


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of one seed (any whole
    number: it is folded to 64 bits)."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), stream])
    return torch.Generator(device=device).manual_seed(
        int(state.generate_state(1, np.uint64)[0]) & (2**63 - 1))


def mean_continuum(grid: Grid, device) -> torch.Tensor:
    """A quasar-like mean continuum: a power law with Ly-alpha and C IV
    emission lines, normalized near 1."""
    wav = torch.as_tensor(grid.wav, dtype=torch.float64, device=device)
    mu = (wav / 1450.0) ** -0.5
    for centre, amp, width in ((LYA, 1.5, 12.0), (1549.06, 0.5, 15.0),
                               (1033.8, 0.3, 8.0)):
        mu = mu + amp * torch.exp(-0.5 * ((wav - centre) / width) ** 2)
    return mu.float()


def model_params(grid: Grid, nh: int, seed: int, device, *, f_scale=0.5,
                 psi=1.0, omega=1.0, tau0=0.02, c0=0.3, beta=2.0) -> dict:
    """Parameters from the seed, as the CLI initializes a run: F uniform
    in (-f_scale, f_scale), Psi and omega constant, the three scalars."""
    f32 = dict(dtype=torch.float32, device=device)
    g = generator(seed, 1, device)
    return dict(
        F=(torch.rand((grid.npix, nh), generator=g, **f32) - 0.5)
        * (2.0 * f_scale),
        Psi=torch.full((grid.npix,), psi, **f32),
        omega=torch.full((grid.nb,), omega, **f32),
        tau0=torch.tensor(tau0, **f32), c0=torch.tensor(c0, **f32),
        beta=torch.tensor(beta, **f32))


def truth_params(grid: Grid, nh: int, seed: int, device, truth: dict) -> dict:
    """The parameters the spectra are drawn from (the traffic's
    ``truth``), F from its own stream."""
    p = model_params(grid, nh, seed, device, **truth)
    g = generator(seed, 2, device)
    p["F"] = (torch.rand(p["F"].shape, generator=g, device=device)
              - 0.5) * (2.0 * truth["f_scale"])
    return p


@torch.no_grad()
def fill_spectra(out_flux, out_error, zqso, p: dict, mu, grid: Grid,
                 g: torch.Generator, *, z_range, error_range, mask_frac,
                 chunk: int = 8192, residual: bool = False) -> None:
    """Draw ``len(zqso)`` spectra into the preallocated planes, ``chunk``
    rows at a time. ``residual`` stores ``delta = flux - mu A`` (the
    training residual) in place of the flux; masked pixels are 0 in both
    planes."""
    n, npix = out_flux.shape
    nb = grid.nb
    dev = out_flux.device
    f32 = dict(dtype=torch.float32, device=dev)
    blue = torch.as_tensor(grid.wav[:nb], **f32)
    span = max(int(mask_frac * npix), 1) if mask_frac > 0 else 0
    cols = torch.arange(npix, device=dev)[None, :]
    zqso.copy_(z_range[0] + (z_range[1] - z_range[0])
               * torch.rand((n,), generator=g, **f32))
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        b = e - s
        zq = zqso[s:e]
        zabs = (1.0 + zq)[:, None] * blue / LYA - 1.0
        amp = torch.ones((b, npix), **f32)
        amp[:, :nb] = torch.exp(-tau_becker(zabs))
        h = torch.randn((b, p["F"].shape[1]), generator=g, **f32)
        cont = mu + h @ p["F"].T
        root = 1.0 - p["c0"] - torch.exp(-p["tau0"] * (1.0 + zabs) ** p["beta"])
        var = amp * amp * p["Psi"]
        var[:, :nb] += p["omega"] * root * root
        sigma = error_range[0] + (error_range[1] - error_range[0]) * torch.rand(
            (b, npix), generator=g, **f32)
        var += sigma * sigma
        flux = amp * cont + torch.sqrt(var) * torch.randn(
            (b, npix), generator=g, **f32)
        if residual:
            flux -= mu * amp
        if span:
            start = torch.randint(0, npix - span + 1, (b, 1), generator=g,
                                  device=dev)
            keep = ~((cols >= start) & (cols < start + span))
            flux *= keep
            sigma *= keep
        out_flux[s:e] = flux
        out_error[s:e] = sigma


def traffic_truth(traffic: dict) -> dict:
    """The truth the spectra are drawn from, with the traffic's own values
    over the defaults."""
    return {**dict(f_scale=0.3, psi=0.2, omega=0.1, tau0=0.0023, c0=0.0,
                   beta=3.65), **traffic.get("truth", {})}


def spectra(n: int, grid: Grid, nh: int, seed: int, device, traffic: dict, *,
            residual: bool = False, chunk: int = 8192):
    """``(flux or delta, error, zqso, mu)`` of ``n`` spectra drawn from the
    traffic's truth on ``device``."""
    mu = mean_continuum(grid, device)
    truth = truth_params(grid, nh, seed, device, traffic_truth(traffic))
    flux = torch.empty((n, grid.npix), dtype=torch.float32, device=device)
    error = torch.empty_like(flux)
    zqso = torch.empty((n,), dtype=torch.float32, device=device)
    fill_spectra(flux, error, zqso, truth, mu, grid,
                 generator(seed, 3, device),
                 z_range=traffic.get("z_range", (2.0, 3.5)),
                 error_range=traffic.get("error_range", (0.05, 0.5)),
                 mask_frac=traffic.get("mask_frac", 0.1), chunk=chunk,
                 residual=residual)
    return flux, error, zqso, mu

