"""Lyman-series line data for effective-optical-depth calculations.

Hydrogen Lyman-series oscillator strengths ``f`` and rest wavelengths
``lambda`` (Angstrom), used to scale the mean optical depth of higher-order
Lyman lines relative to Ly-alpha following arXiv:2003.11036 Eq. 17:

    tau_n(z) = tau_alpha(z) * (lambda_n * f_n) / (lambda_alpha * f_alpha)

The same table as ``qfa_tpu.physics.lyman`` (Wiese & Fuhr 2009
compilation), kept as numpy constants so the port never imports the JAX
package.
"""

from __future__ import annotations

import numpy as np

# (name, oscillator strength f, rest wavelength [A])
_LYMAN_TABLE = (
    ("HI_1215", 4.1620e-01, 1215.6701),
    ("HI_1025", 7.9140e-02, 1025.7222),
    ("HI_972", 2.9010e-02, 972.5367),
    ("HI_949", 1.3950e-02, 949.7430),
    ("HI_937", 7.8030e-03, 937.8034),
    ("HI_930", 4.8160e-03, 930.7482),
    ("HI_926", 3.1850e-03, 926.2256),
    ("HI_923", 2.2170e-03, 923.1503),
    ("HI_920", 1.6060e-03, 920.9630),
    ("HI_919", 1.2010e-03, 919.3513),
    ("HI_918", 9.2190e-04, 918.1293),
    ("HI_917", 7.2310e-04, 917.1805),
    ("HI_916", 5.7770e-04, 916.4291),
    ("HI_915", 4.6890e-04, 915.8238),
    ("HI_915b", 3.8580e-04, 915.3289),
    ("HI_914", 3.2120e-04, 914.9192),
    ("HI_914b", 2.7030e-04, 914.5762),
    ("HI_914c", 2.2970e-04, 914.2861),
    ("HI_914d", 1.9680e-04, 914.0385),
    ("HI_913", 1.6990e-04, 913.8256),
    ("HI_913b", 1.4770e-04, 913.6411),
    ("HI_913c", 1.2930e-04, 913.4803),
    ("HI_913d", 1.1370e-04, 913.3391),
    ("HI_913e", 1.0060e-04, 913.2146),
    ("HI_913f", 8.9360e-05, 913.1042),
    ("HI_913g", 7.9780e-05, 913.0059),
    ("HI_912", 7.1480e-05, 912.9179),
    ("HI_912b", 6.4350e-05, 912.8389),
    ("HI_912c", 5.8120e-05, 912.7676),
    ("HI_912d", 5.2640e-05, 912.7032),
)

#: Ly-alpha rest wavelength in Angstrom.
LYA_WAVELENGTH: float = _LYMAN_TABLE[0][2]

#: Oscillator strengths, shape (n_lines,), float64.
OSCILLATOR_STRENGTH: np.ndarray = np.array([row[1] for row in _LYMAN_TABLE])

#: Rest wavelengths [A], shape (n_lines,), float64.
WAVELENGTH: np.ndarray = np.array([row[2] for row in _LYMAN_TABLE])

#: Relative optical-depth coefficient per line:
#: ``lambda_n f_n / (lambda_alpha f_alpha)`` (arXiv:2003.11036 Eq. 17).
COEFF: np.ndarray = (WAVELENGTH * OSCILLATOR_STRENGTH) / (
    WAVELENGTH[0] * OSCILLATOR_STRENGTH[0]
)

N_LINES: int = len(_LYMAN_TABLE)


def line_names() -> tuple:
    """Names of the bundled Lyman-series lines, strongest first."""
    return tuple(row[0] for row in _LYMAN_TABLE)
