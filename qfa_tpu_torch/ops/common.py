"""Shared pieces of the kernel wrappers: tau-law coefficients, the zq
column and the loglam row, and the lower-triangle index helpers."""

from __future__ import annotations

import numpy as np
import torch

from ..data.grid import LYA_WAVELENGTH

Tensor = torch.Tensor

__all__ = [
    "TAU_LAW_ABC",
    "ZQ_WIDTH",
    "tau_law_abc",
    "loglam_row",
    "zq_column",
    "tri_pairs",
    "tri_idx",
]

#: Power-law form ``a * (1+z)^b + c`` covering every supported tau law
#: (the same coefficients as ``qfa_tpu.ops.fused_step.TAU_LAW_ABC``).
TAU_LAW_ABC = {
    "becker": (0.751 / 4.5**2.90, 2.90, -0.132),
    "fg": (0.0018, 3.92, 0.0),
    "kamble": (5.54e-3, 3.182, 0.0),
    "mock": (0.2231435513142097 / 3.25**3.2, 3.2, 0.0),
}

#: Width of the ``derive_zabs`` zq column: ``[log1p(zqso), weight]``.
ZQ_WIDTH = 2


def tau_law_abc(tau_which) -> tuple[float, float, float]:
    """Power-law coefficients for a NAMED tau law. The kernels hard-code
    the family ``a (1+z)^b + c``, so an arbitrary tau callable (which the
    plain path accepts) must fail loudly here instead of silently using
    the wrong law."""
    if not isinstance(tau_which, str):
        raise ValueError(
            "the fused prediction kernel supports only the named "
            f"mean-optical-depth laws {sorted(TAU_LAW_ABC)} (power-law "
            f"form a(1+z)^b + c); got {tau_which!r} — use the plain path "
            "(models.qfa.predict) for arbitrary tau callables, or pass "
            "tau=partial(tau, which='<law>') so the law name can be "
            "recovered (physics.tau.resolve_tau)"
        )
    try:
        return TAU_LAW_ABC[tau_which]
    except KeyError:
        raise NotImplementedError(
            f"unknown mean optical depth law {tau_which!r}; "
            f"available: {sorted(TAU_LAW_ABC)}"
        ) from None


def loglam_row(wav, device=None) -> Tensor:
    """Static ``log(lam / lam_lya)`` row for ``derive_zabs`` (float64 host
    math, cast once). With :func:`zq_column`,
    ``log(1 + zabs) = log1p(zqso) + loglam`` on the blue pixels."""
    row = np.log(np.asarray(wav, np.float64) / LYA_WAVELENGTH)
    return torch.tensor(row, dtype=torch.float32, device=device)


def zq_column(zqso, weight=None) -> Tensor:
    """Pack quasar redshifts into the ``(N, 2)`` float32 ``derive_zabs``
    column ``[log1p(zqso), weight]`` (weight defaults to 1 for every row).

    The JAX package pads the same two values to 128 lanes for the TPU;
    column 1 is not read by the prediction kernel.
    """
    z = torch.as_tensor(zqso).to(torch.float32)
    w = torch.ones_like(z) if weight is None else \
        torch.as_tensor(weight, device=z.device).to(torch.float32)
    return torch.stack([torch.log1p(z), w], dim=1)


def tri_pairs(nh: int) -> list[tuple[int, int]]:
    """Lower-triangle index pairs ``[(a, b) with a >= b]`` in packed order."""
    return [(a, b) for a in range(nh) for b in range(a + 1)]


def tri_idx(a: int, b: int) -> int:
    """Packed index of ``(a, b)`` in :func:`tri_pairs` order (symmetric)."""
    a, b = (a, b) if a >= b else (b, a)
    return a * (a + 1) // 2 + b
