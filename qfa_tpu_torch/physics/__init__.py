"""Domain physics: optical-depth laws, Lyman-series data, smoothing."""

from .smoothing import sliding_mean, smooth_curve
from .lyman import COEFF, LYA_WAVELENGTH, N_LINES, OSCILLATOR_STRENGTH, WAVELENGTH
from .tau import (
    TAU_LAWS,
    get_tau_law,
    n_contributing_lines,
    omega_func,
    resolve_tau,
    tau,
    tau_becker,
    tau_fg,
    tau_hi,
    tau_kamble,
    tau_mock,
    tau_total,
)

__all__ = [
    "COEFF",
    "LYA_WAVELENGTH",
    "N_LINES",
    "OSCILLATOR_STRENGTH",
    "WAVELENGTH",
    "TAU_LAWS",
    "get_tau_law",
    "n_contributing_lines",
    "omega_func",
    "resolve_tau",
    "sliding_mean",
    "smooth_curve",
    "tau",
    "tau_becker",
    "tau_fg",
    "tau_hi",
    "tau_kamble",
    "tau_mock",
    "tau_total",
]
