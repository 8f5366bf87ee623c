"""Fused prediction: the whole predict stack for a batch in ONE kernel launch.

Per spectrum the predict path needs the marginal NLL (OOD score), the
posterior latents ``hmean = K^-1 w`` / ``hcov = K^-1``, the unabsorbed
continuum ``F hmean + mu`` and its uncertainty ``sqrt(diag(F hcov F^T))``.
:func:`fused_predict` computes all of them:

* on a CUDA tensor, in the hand-written CUDA kernel ``csrc/predict.cu``
  (the port of ``qfa_tpu.ops.infer_kernel._predict_kernel``), built at
  first use by :mod:`._build`; a launch that fails raises;
* on a CPU tensor, in :func:`fused_predict_plain`, the same function in
  plain torch ops — the reference the kernel is held against on the card.

Modes: an explicit mask plane or a mask derived as ``error > 0``; a zabs
plane (width Nb, Npix or round_up(Npix, 128)) or the (N, 2) zq column plus
the ``loglam`` row; ``stats_only``. bfloat16 planes run on the plain
version only.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from ..linalg import smallchol
from ..linalg.lowrank import LOG_2PI
from ..models.params import QFAParams
from .common import ZQ_WIDTH, tau_law_abc, tri_idx, tri_pairs

Tensor = torch.Tensor

__all__ = [
    "FusedPredictOutputs",
    "LAUNCHES",
    "fused_predict",
    "fused_predict_plain",
]

#: Launches of the CUDA prediction kernel in this process. Incremented
#: where the wrapper launches the kernel, and nowhere else.
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()

#: the kernel is instantiated for 1 <= nh <= 10 (nh*nh + nh + 2 <= 128,
#: the JAX kernel's stats-row bound)
MAX_NH = 10

_BF16_ROADMAP = (
    "bfloat16 planes are not supported by the CUDA prediction kernel yet "
    "(ROADMAP B1b); pass float32, or run on the CPU plain version"
)


class FusedPredictOutputs(NamedTuple):
    ll: Tensor  #: (N,) per-spectrum NLL (OOD score).
    hmean: Tensor  #: (N, Nh) posterior latent means.
    hcov: Tensor  #: (N, Nh, Nh) posterior covariances.
    continuum: Tensor | None  #: (N, Npix) continuum; None when stats_only.
    continuum_std: Tensor | None  #: (N, Npix) uncertainty; None when stats_only.
    n_obs: Tensor  #: (N,) observed-pixel counts.


def _check_args(params, flux, error, zabs, mask, loglam, derive_zabs):
    npix, nh = params.F.shape
    nb = params.omega.shape[0]
    if nh < 1 or nh * nh + nh + 2 > 128:
        raise ValueError(
            f"fused_predict supports 1 <= nh and nh*nh+nh+2 <= 128 "
            f"(nh <= {MAX_NH}); got nh={nh}"
        )
    n = flux.shape[0]
    if flux.ndim != 2 or flux.shape[1] != npix or error.shape != flux.shape:
        raise ValueError(
            f"flux {tuple(flux.shape)} and error {tuple(error.shape)} must "
            f"both be (N, Npix={npix})"
        )
    if mask is not None and mask.shape != flux.shape:
        raise ValueError(
            f"mask {tuple(mask.shape)} must match flux {tuple(flux.shape)}"
        )
    if derive_zabs:
        if loglam is None:
            raise ValueError("derive_zabs=True requires the loglam row")
        if zabs.ndim != 2 or zabs.shape[1] != ZQ_WIDTH:
            # exact width: a zabs PLANE must not be misread as a column
            raise ValueError(
                f"derive_zabs=True expects the (N, {ZQ_WIDTH}) zq_column "
                f"buffer, got {tuple(zabs.shape)}"
            )
        if zabs.shape[0] != n:
            raise ValueError(
                f"zq column has {zabs.shape[0]} rows but the batch planes "
                f"have {n}"
            )
        if loglam.shape != (npix,):
            raise ValueError(
                f"loglam {tuple(loglam.shape)} must be (Npix={npix},)"
            )
    else:
        p = -(-npix // 128) * 128
        if zabs.ndim != 2 or zabs.shape[0] != n or \
                zabs.shape[1] not in (nb, npix, p):
            raise ValueError(
                f"zabs plane {tuple(zabs.shape)} matches neither (N, Nb={nb})"
                f" nor (N, Npix={npix}); if this is a zq_column buffer, pass "
                "derive_zabs=True (and loglam)"
            )


@torch.no_grad()
def fused_predict_plain(
    params: QFAParams,
    mu: Tensor,
    flux: Tensor,
    error: Tensor,
    zabs: Tensor,
    mask: Tensor | None = None,
    *,
    tau_which: str = "becker",
    stats_only: bool = False,
    loglam: Tensor | None = None,
    derive_zabs: bool = False,
    out_dtype: torch.dtype = torch.float32,
) -> FusedPredictOutputs:
    """:func:`fused_predict` in plain torch ops, on any device.

    The same arithmetic as the CUDA kernel, in fp32: the contractions are
    matrix products against the lower-triangle Gram rows ``F_a F_b``.
    Takes float32 or bfloat16 planes; ``out_dtype`` sets the dtype of the
    continuum and std planes.
    """
    _check_args(params, flux, error, zabs, mask, loglam, derive_zabs)
    law_a, law_b, law_c = tau_law_abc(tau_which)
    f32 = torch.float32
    npix, nh = params.F.shape
    nb = params.omega.shape[0]
    n = flux.shape[0]
    flux = flux.to(f32)
    err = error.to(f32)
    m = (err > 0.0).to(f32) if mask is None else mask.to(f32)
    tau0, c0, beta = params.tau0, params.c0, params.beta

    if derive_zabs:
        logzp1 = zabs[:, :1].to(f32) + loglam[:nb].to(f32)  # (N, Nb)
        tau_line = law_a * torch.exp(law_b * logzp1) + law_c
        zp1b = torch.exp(beta * logzp1)
    else:
        zp1 = 1.0 + zabs[:, :nb].to(f32)
        tau_line = law_a * zp1**law_b + law_c
        zp1b = zp1**beta
    root = 1.0 - c0 - torch.exp(-(tau0 * zp1b))
    red = (n, npix - nb)
    amp = torch.cat([torch.exp(-tau_line), flux.new_ones(red)], dim=1)
    forest = torch.cat([params.omega * (root * root), flux.new_zeros(red)],
                       dim=1)
    d = amp * amp * params.Psi + forest + err * err
    delta = (flux - mu * amp) * m
    d_safe = torch.where(m > 0, d, 1.0)
    dinv = m / d_safe
    w = amp * amp * dinv
    u = amp * dinv * delta
    ql = delta * delta * dinv + m * torch.log(d_safe)

    pairs = tri_pairs(nh)
    ia = [a for a, _ in pairs]
    ib = [b for _, b in pairs]
    f = params.F
    gram = f[:, ia] * f[:, ib]  # (Npix, ntri) lower-triangle Gram rows
    k_tri = w @ gram  # (N, ntri)
    full = torch.tensor([[tri_idx(a, b) for b in range(nh)]
                         for a in range(nh)], device=flux.device)
    k = k_tri[:, full] + torch.eye(nh, dtype=f32, device=flux.device)
    chol = smallchol.cholesky_small(k)
    y = smallchol.solve_lower_small(chol, u @ f)
    hmean = smallchol.solve_upper_small(chol, y)
    n_obs = m.sum(dim=1)
    ll = 0.5 * (ql.sum(dim=1) - (y * y).sum(dim=-1) + n_obs * LOG_2PI
                + smallchol.logdet_from_chol(chol))
    hcov = smallchol.inverse_from_chol(chol)
    cont = std = None
    if not stats_only:
        cont = (hmean @ f.T + mu).to(out_dtype)
        # diag(F K^-1 F^T) over the symmetric triangle, off-diagonal doubled
        scale = torch.tensor([1.0 if a == b else 2.0 for a, b in pairs],
                             device=flux.device)
        var = (hcov[:, ia, ib] * scale) @ gram.T
        std = torch.sqrt(torch.clamp(var, min=0.0)).to(out_dtype)
    return FusedPredictOutputs(ll=ll, hmean=hmean, hcov=hcov, continuum=cont,
                               continuum_std=std, n_obs=n_obs)


def _launch(params, mu, flux, error, zabs, mask, *, law, stats_only, loglam,
            derive_zabs, out_dtype) -> FusedPredictOutputs:
    from ._build import device_and_stream, load_library

    dev = flux.device
    if out_dtype != torch.float32:
        raise NotImplementedError(_BF16_ROADMAP)
    tensors = {
        "flux": flux, "error": error, "zabs": zabs, "mask": mask, "mu": mu,
        "F": params.F, "Psi": params.Psi, "omega": params.omega,
        "tau0": params.tau0, "c0": params.c0, "beta": params.beta,
        "loglam": loglam if derive_zabs else None,
    }
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device} but flux on {dev}")
        if t.dtype == torch.bfloat16:
            raise NotImplementedError(_BF16_ROADMAP)
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    npix, nh = params.F.shape
    nb = params.omega.shape[0]
    if mu.shape != (npix,):
        raise ValueError(f"mu {tuple(mu.shape)} must be (Npix={npix},)")
    n = flux.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    ll = torch.empty((n,), **f32)
    n_obs = torch.empty((n,), **f32)
    hmean = torch.empty((n, nh), **f32)
    hcov = torch.empty((n, nh, nh), **f32)
    cont = std = None
    if not stats_only:
        cont = torch.empty((n, npix), **f32)
        std = torch.empty((n, npix), **f32)
    out = FusedPredictOutputs(ll=ll, hmean=hmean, hcov=hcov, continuum=cont,
                              continuum_std=std, n_obs=n_obs)
    if n == 0:
        return out

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = load_library()
    index, stream = device_and_stream(dev)
    rc = lib.qfa_predict_f32(
        ptr(flux), ptr(error), ptr(zabs), zabs.shape[1], ptr(mask),
        ptr(mu), ptr(params.F), ptr(params.Psi), ptr(params.omega),
        ptr(tensors["loglam"]),
        ptr(params.tau0), ptr(params.c0), ptr(params.beta),
        *law, n, npix, nb, nh, int(mask is None), int(derive_zabs),
        ptr(ll), ptr(n_obs), ptr(hmean), ptr(hcov), ptr(cont), ptr(std),
        index, stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"CUDA prediction kernel launch failed: error {rc} "
            f"({lib.qfa_cuda_error_string(rc).decode()})"
        )
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    return out


@torch.no_grad()
def fused_predict(
    params: QFAParams,
    mu: Tensor,
    flux: Tensor,
    error: Tensor,
    zabs: Tensor,
    mask: Tensor | None = None,
    *,
    tau_which: str = "becker",
    stats_only: bool = False,
    loglam: Tensor | None = None,
    derive_zabs: bool = False,
    out_dtype: torch.dtype = torch.float32,
) -> FusedPredictOutputs:
    """Predict continua, posteriors and OOD scores for a batch in one call.

    ``flux``/``error``/``mask`` are (N, Npix); N needs no divisibility.
    ``mask=None`` derives the mask from ``error > 0`` (the data layer
    sanitizes masked pixels to 0). ``derive_zabs=True`` takes the (N, 2)
    :func:`~qfa_tpu_torch.ops.common.zq_column` in place of the zabs plane,
    plus ``loglam`` (:func:`~qfa_tpu_torch.ops.common.loglam_row`).
    ``stats_only=True`` skips the continuum and std planes (they come back
    as None): the survey-scale OOD sweep.

    Tensors on the CPU run :func:`fused_predict_plain`. Tensors on a CUDA
    device launch the CUDA kernel, or raise: float32, contiguous, all on
    one device.
    """
    _check_args(params, flux, error, zabs, mask, loglam, derive_zabs)
    law = tau_law_abc(tau_which)
    kw = dict(stats_only=stats_only, loglam=loglam, derive_zabs=derive_zabs,
              out_dtype=out_dtype)
    if flux.device.type == "cpu":
        return fused_predict_plain(params, mu, flux, error, zabs, mask,
                                   tau_which=tau_which, **kw)
    if flux.device.type != "cuda":
        raise ValueError(f"fused_predict runs on cpu or cuda, not {flux.device}")
    return _launch(params, mu, flux, error, zabs, mask, law=law, **kw)
