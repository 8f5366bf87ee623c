"""Rest-frame wavelength grid construction (numpy only).

The model is defined on a fixed log-uniform rest-frame wavelength grid:
pixels bluer than Ly-alpha (1215.67 A) carry forest absorption ("blue
side", ``Nb`` pixels), the rest are the "red side" (``Nr`` pixels). Same
grid as ``qfa_tpu.data.grid``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..physics.lyman import LYA_WAVELENGTH

__all__ = [
    "WavelengthGrid",
    "make_grid",
    "LYA_WAVELENGTH",
    "DEFAULT_LAMMIN",
    "DEFAULT_LAMMAX",
    "DEFAULT_DLOGLAM",
]

#: canonical SDSS grid bounds/step — the single source of truth for every
#: default grid in the package (config schema, serving CLI).
DEFAULT_LAMMIN = 1030.0
DEFAULT_LAMMAX = 1600.0
DEFAULT_DLOGLAM = 1e-4


class WavelengthGrid(NamedTuple):
    """Static description of the rest-frame wavelength grid."""

    wav: np.ndarray  #: (Npix,) wavelengths in Angstrom, log-uniform.
    nb: int  #: number of blue-side pixels (lambda < Ly-alpha).
    nr: int  #: number of red-side pixels.

    @property
    def npix(self) -> int:
        return self.nb + self.nr

    @property
    def blue(self) -> np.ndarray:
        return self.wav[: self.nb]

    @property
    def red(self) -> np.ndarray:
        return self.wav[self.nb :]

    def zabs(self, zqso: np.ndarray) -> np.ndarray:
        """Per-pixel Ly-alpha absorber redshifts for blue-side pixels,
        ``zabs = (1 + zqso) * lambda / lambda_lya - 1``. Shape
        ``zqso.shape + (Nb,)``."""
        zqso = np.asarray(zqso)
        return (1.0 + zqso)[..., None] * self.blue / LYA_WAVELENGTH - 1.0


def make_grid(
    lam_min: float = DEFAULT_LAMMIN,
    lam_max: float = DEFAULT_LAMMAX,
    dloglam: float = DEFAULT_DLOGLAM,
) -> WavelengthGrid:
    """Build the log-uniform wavelength grid ``10^arange(log lam_min, log
    lam_max, dloglam)``. Defaults reproduce the SDSS grid (Npix=1913, Nb=720).
    """
    wav = 10.0 ** np.arange(np.log10(lam_min), np.log10(lam_max), dloglam)
    nb = int(np.sum(wav < LYA_WAVELENGTH))
    return WavelengthGrid(wav=wav, nb=nb, nr=len(wav) - nb)
