"""Data layer: wavelength grid, batch container, spectrum reading."""

from .batch import SpectraBatch
from .grid import WavelengthGrid, make_grid

__all__ = ["SpectraBatch", "WavelengthGrid", "make_grid"]
