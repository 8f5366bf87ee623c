"""Data layer: wavelength grid, batches, spectrum reading, the residual
planes (resident or streamed from host RAM), synthetic spectra."""

from .batch import SpectraBatch, pad_batch
from .grid import WavelengthGrid, make_grid

__all__ = ["SpectraBatch", "pad_batch", "WavelengthGrid", "make_grid"]
