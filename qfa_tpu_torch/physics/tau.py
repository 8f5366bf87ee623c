"""Mean-optical-depth laws and forest-noise redshift evolution, in torch.

Counterpart of ``qfa_tpu.physics.tau``:

* ``tau_becker`` / ``tau_fg`` / ``tau_kamble`` / ``tau_mock`` — published
  mean-optical-depth measurements of the Ly-alpha forest.
* ``tau`` — a law scaled to an arbitrary Lyman-series line.
* ``tau_total`` — summed optical depth of all Lyman lines covering a
  rest-frame wavelength grid.
* ``tau_hi`` / ``omega_func`` — the trainable power law ``tau0 (1+z)^beta``
  and the forest-noise evolution ``(1 - c0 - exp(-tau_hi))^2``.

Every function takes and returns torch tensors; callables ``tau(z)`` stay
accepted wherever a law name is (:func:`resolve_tau`).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from .lyman import COEFF, LYA_WAVELENGTH, N_LINES, WAVELENGTH

Tensor = torch.Tensor

__all__ = [
    "tau_becker",
    "tau_fg",
    "tau_kamble",
    "tau_mock",
    "tau",
    "tau_total",
    "tau_hi",
    "omega_func",
    "TAU_LAWS",
    "get_tau_law",
    "resolve_tau",
]


def tau_becker(z: Tensor) -> Tensor:
    """Becker et al. 2012 (arXiv:1208.2584) mean optical depth."""
    tau0, beta, c, z0 = 0.751, 2.90, -0.132, 3.5
    return tau0 * ((1.0 + z) / (1.0 + z0)) ** beta + c


def tau_fg(z: Tensor) -> Tensor:
    """Faucher-Giguere et al. 2008 mean optical depth."""
    tau0, beta = 0.0018, 3.92
    return tau0 * (1.0 + z) ** beta


def tau_kamble(z: Tensor) -> Tensor:
    """Kamble et al. 2020 mean optical depth."""
    tau0, beta = 5.54e-3, 3.182
    return tau0 * (1.0 + z) ** beta


def tau_mock(z: Tensor) -> Tensor:
    """Mock-catalog optical depth (Bautista et al. 2015)."""
    return 0.2231435513142097 * ((1.0 + z) / 3.25) ** 3.2


TAU_LAWS: dict = {
    "becker": tau_becker,
    "fg": tau_fg,
    "kamble": tau_kamble,
    "mock": tau_mock,
}


def get_tau_law(which: str) -> Callable[[Tensor], Tensor]:
    """Look up a mean-optical-depth law by name."""
    try:
        return TAU_LAWS[which]
    except KeyError:
        raise NotImplementedError(
            f"unknown mean optical depth law {which!r}; "
            f"available: {sorted(TAU_LAWS)}"
        ) from None


def resolve_tau(tau_spec) -> str | Callable[[Tensor], Tensor]:
    """Normalize a mean-optical-depth spec to a law NAME where possible.

    * a law name — validated and returned as-is;
    * a ``functools.partial`` of a ``tau`` dispatcher carrying only
      ``which=`` (and ``series=1``) — resolved to that name;
    * one of the :data:`TAU_LAWS` functions — resolved to its name;
    * any other callable ``tau(z) -> tau`` — returned verbatim: the plain
      torch path evaluates it exactly; the CUDA kernel rejects it
      (``ops.common.tau_law_abc``).
    """
    if isinstance(tau_spec, str):
        get_tau_law(tau_spec)
        return tau_spec
    if isinstance(tau_spec, functools.partial):
        # only the dispatcher idiom resolves to a name; a partial of a
        # user callable keeps the callable
        func = tau_spec.func
        which = tau_spec.keywords.get("which")
        extras = set(tau_spec.keywords) - {"which", "series"}
        dispatcher = func is tau or getattr(func, "__name__", "") == "tau"
        if (
            dispatcher
            and isinstance(which, str)
            and not tau_spec.args
            and not extras
            and tau_spec.keywords.get("series", 1) == 1
        ):
            get_tau_law(which)
            return which
    for name, fn in TAU_LAWS.items():
        if tau_spec is fn:
            return name
    if callable(tau_spec):
        return tau_spec
    raise TypeError(
        f"tau must be a law name or a callable tau(z); got {tau_spec!r}"
    )


def tau(z: Tensor, which: str = "becker", series: int = 1) -> Tensor:
    """Mean optical depth of Lyman line ``series`` (1 = alpha) at redshift
    z: the Ly-alpha law scaled by the line's ``lambda f`` coefficient."""
    coeff = float(COEFF[series - 1])
    return get_tau_law(which)(z) * coeff


def n_contributing_lines(wav_start: float) -> int:
    """Number of Lyman lines with rest wavelength above ``wav_start``."""
    n = int(np.sum(WAVELENGTH > wav_start))
    if n == 0:
        raise ValueError(
            "wavelength grid does not cover any Lyman series line "
            f"(grid starts at {wav_start} A > Ly-limit)"
        )
    return min(n, N_LINES)


def tau_total(
    wav_grid,
    zqso: Tensor,
    which: str = "becker",
    wav_start: float | None = None,
) -> Tensor:
    """Total Lyman-series optical depth over the blue-side grid.

    ``wav_grid`` is the (Npix,) rest-frame grid (numpy or tensor), ``zqso``
    a tensor of shape ``(...,)``. Returns ``zqso.shape + (Nb,)`` in
    ``zqso``'s floating dtype (float32 for integer input), on its device.
    """
    wav_np = np.asarray(
        wav_grid.cpu() if isinstance(wav_grid, torch.Tensor) else wav_grid
    )
    start = float(wav_np[0]) if wav_start is None else float(wav_start)
    n_lines = n_contributing_lines(start)

    z = torch.as_tensor(zqso)
    dtype = z.dtype if z.is_floating_point() else torch.float32
    z = z.to(dtype)[..., None]
    nb = int(np.sum(wav_np < LYA_WAVELENGTH))
    blue = torch.as_tensor(wav_np[:nb], dtype=dtype, device=z.device)

    law = get_tau_law(which)
    total = torch.zeros(z.shape[:-1] + (nb,), dtype=dtype, device=z.device)
    for i in range(n_lines):
        lam_i = float(WAVELENGTH[i])
        coeff_i = float(COEFF[i])
        zabs_i = (1.0 + z) * (blue / lam_i) - 1.0
        contrib = law(zabs_i) * coeff_i
        total = total + torch.where(blue < lam_i, contrib, 0.0)
    return total


def tau_hi(z: Tensor, tau0: Tensor, beta: Tensor) -> Tensor:
    """Trainable power-law effective optical depth ``tau0 (1+z)^beta``."""
    return tau0 * (1.0 + z) ** beta


def omega_func(z: Tensor, tau0: Tensor, beta: Tensor, c0: Tensor) -> Tensor:
    """Forest-noise redshift evolution ``(1 - c0 - exp(-tau_hi(z)))^2``."""
    root = 1.0 - c0 - torch.exp(-tau_hi(z, tau0, beta))
    return root * root
