"""QFA model parameters: module definition, init, checkpoints.

The generative model (arXiv:2207.02788) is

    continuum  C = mu + F h + noise(Psi),   h ~ N(0, I_Nh)
    observed   S = A(z) * C + forest noise(omega * zdep(z)) + pixel noise

with trainable parameters F (Npix, Nh), Psi (Npix,), omega (Nb,) and the
scalars tau0, c0, beta of the forest power law ``tau0 (1+z)^beta``. ``mu``
is estimated from data, not trained, and is stored beside the parameters
in checkpoints. Checkpoints use the same npz schema as ``qfa_tpu``, so
either package loads the other's files.
"""

from __future__ import annotations

import os
from typing import Mapping, NamedTuple

import numpy as np
import torch
from torch import nn

from ..physics.smoothing import sliding_mean

Tensor = torch.Tensor

__all__ = [
    "QFAParams",
    "ParamBounds",
    "DEFAULT_BOUNDS",
    "PARAM_NAMES",
    "num_params",
    "random_init",
    "clip_params",
    "smooth_params",
    "save_npz",
    "load_npz",
]

#: parameter names, in the order of ``qfa_tpu.models.QFAParams``
PARAM_NAMES = ("F", "Psi", "omega", "tau0", "c0", "beta")


class QFAParams(nn.Module):
    """Trainable QFA parameters as an ``nn.Module``.

    Attribute access (``params.F``, ``params.tau0``, ...) matches the JAX
    package's ``QFAParams`` NamedTuple, so the model functions read the
    same in both.
    """

    def __init__(self, F, Psi, omega, tau0, c0, beta):  # noqa: N803
        super().__init__()
        self.F = nn.Parameter(torch.as_tensor(F))
        self.Psi = nn.Parameter(torch.as_tensor(Psi))
        self.omega = nn.Parameter(torch.as_tensor(omega))
        self.tau0 = nn.Parameter(torch.as_tensor(tau0))
        self.c0 = nn.Parameter(torch.as_tensor(c0))
        self.beta = nn.Parameter(torch.as_tensor(beta))

    @classmethod
    def wrap(cls, F, Psi, omega, tau0, c0, beta,  # noqa: N803
             requires_grad: bool = True) -> "QFAParams":
        """The module over these tensors as they are (no copy), built
        without ``nn.Module``'s per-attribute bookkeeping: a third of the
        constructor's host time, for wrappers that return three per call
        (the epoch kernel's, once per exact-DP window)."""
        obj = cls.__new__(cls)
        nn.Module.__init__(obj)
        for k, x in zip(PARAM_NAMES, (F, Psi, omega, tau0, c0, beta)):
            obj._parameters[k] = nn.Parameter(x, requires_grad=requires_grad)
        return obj

    @property
    def npix(self) -> int:
        return self.F.shape[0]

    @property
    def nh(self) -> int:
        return self.F.shape[1]

    @property
    def nb(self) -> int:
        return self.omega.shape[0]

    @classmethod
    def from_numpy(
        cls,
        mapping: Mapping[str, np.ndarray],
        *,
        device=None,
        dtype: torch.dtype = torch.float32,
    ) -> "QFAParams":
        """Build from a name -> array mapping, e.g. the JAX package's
        ``{k: np.asarray(v) for k, v in params.as_dict().items()}``."""
        return cls(**{
            k: torch.tensor(np.asarray(mapping[k]), dtype=dtype, device=device)
            for k in PARAM_NAMES
        })

    def as_dict(self) -> dict:
        """Name -> tensor (detached, on the parameters' device), the JAX
        package's ``QFAParams.as_dict``."""
        return {k: getattr(self, k).detach() for k in PARAM_NAMES}

    def to_numpy(self) -> dict:
        """The parameters as a name -> float32 numpy array dict (the inverse
        of :meth:`from_numpy`)."""
        return {
            k: getattr(self, k).detach().cpu().numpy().astype(np.float32)
            for k in PARAM_NAMES
        }


class ParamBounds(NamedTuple):
    """Box constraints applied after every update."""

    var_min: float = 1e-3  #: lower bound for omega and Psi
    var_max: float = 2.0  #: upper bound for omega and Psi
    tau0_min: float = 0.0
    tau0_max: float = 1.0
    beta_min: float = 0.1
    beta_max: float = 5.0
    c0_min: float = -5.0
    c0_max: float = 5.0


DEFAULT_BOUNDS = ParamBounds()


def random_init(
    npix: int,
    nb: int,
    nh: int,
    *,
    generator: torch.Generator | None = None,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> QFAParams:
    """Random initialization: F ~ U(-0.5, 0.5), Psi = omega = 1,
    tau0 = 0.02, c0 = 0.3, beta = 2 (the JAX package's strategy; the
    random draws differ, since ``torch.Generator`` is not ``jax.random``).
    """
    f = torch.rand((npix, nh), generator=generator, dtype=dtype,
                   device=device) - 0.5
    return QFAParams(
        F=f,
        Psi=torch.ones((npix,), dtype=dtype, device=device),
        omega=torch.ones((nb,), dtype=dtype, device=device),
        tau0=torch.tensor(0.02, dtype=dtype, device=device),
        c0=torch.tensor(0.3, dtype=dtype, device=device),
        beta=torch.tensor(2.0, dtype=dtype, device=device),
    )


def clip_params(params: QFAParams,
                bounds: ParamBounds = DEFAULT_BOUNDS) -> QFAParams:
    """Project the parameters back into their numerical-stability box (a
    new module; F is not bounded)."""
    return QFAParams(
        F=params.F.detach(),
        Psi=torch.clamp(params.Psi.detach(), bounds.var_min, bounds.var_max),
        omega=torch.clamp(params.omega.detach(), bounds.var_min,
                          bounds.var_max),
        tau0=torch.clamp(params.tau0.detach(), bounds.tau0_min,
                         bounds.tau0_max),
        c0=torch.clamp(params.c0.detach(), bounds.c0_min, bounds.c0_max),
        beta=torch.clamp(params.beta.detach(), bounds.beta_min,
                         bounds.beta_max),
    )


def smooth_params(params: QFAParams) -> QFAParams:
    """Periodic wavelength-axis smoothing of omega, Psi (window 15) and F
    (window 31): edge-truncated sliding means (a new module)."""
    with torch.no_grad():
        return QFAParams(
            F=sliding_mean(params.F, 31, axis=0),
            Psi=sliding_mean(params.Psi, 15, axis=0),
            omega=sliding_mean(params.omega, 15, axis=0),
            tau0=params.tau0.detach(),
            c0=params.c0.detach(),
            beta=params.beta.detach(),
        )


def num_params(npix: int, nb: int, nh: int) -> int:
    """Total trainable parameter count: F, Psi, omega and three scalars."""
    return npix * nh + npix + nb + 3


def save_npz(path: str, params: QFAParams, mu) -> None:
    """Write a checkpoint in the reference npz schema (keys ``mu, F, Psi,
    omega, tau0, c0, beta``, all float32)."""
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    if isinstance(mu, torch.Tensor):
        mu = mu.detach().cpu().numpy()
    np.savez(path, mu=np.asarray(mu, np.float32), **params.to_numpy())


def load_npz(
    path: str,
    *,
    compat_c0_bug: bool = False,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> tuple[QFAParams, Tensor]:
    """Load a reference-schema npz checkpoint onto ``device``.

    ``compat_c0_bug``: the reference loader assigns ``beta`` into ``c0``
    and its bundled golden outputs were produced under that bug. Set True
    to reproduce them; the default loads the file faithfully.

    Returns ``(params, mu)``.
    """
    with np.load(path) as f:
        arrays = {k: f[k] for k in PARAM_NAMES}
        if compat_c0_bug:
            arrays["c0"] = f["beta"]
        mu = torch.tensor(f["mu"], dtype=dtype, device=device)
    return QFAParams.from_numpy(arrays, device=device, dtype=dtype), mu
