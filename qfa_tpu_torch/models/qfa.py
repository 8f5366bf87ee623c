"""QFA likelihood and posterior inference — the plain batched torch path.

Forward half of ``qfa_tpu.models.qfa``:

1. elementwise assembly of the absorption amplitude ``A`` and the noise
   diagonal ``D = A^2 Psi + omega * zdep + error^2``;
2. one (B, 5, Npix) @ (Npix, Nh^2 + Nh + 1) product for every capacitance
   matrix and data projection at once (``linalg.lowrank``);
3. batched Nh x Nh Cholesky factorizations and triangular solves.

This is the reference the CUDA prediction kernel (``ops.infer_kernel``)
is held against, and the path the CLI and server take off the GPU. The
training loss (:func:`mean_nll`) and its gradients by ``torch.autograd``
(:func:`loss_and_grads`, :func:`summed_stats`) serve held-out validation
and the autograd training step, and are the independent check of the
epoch and step kernels' analytic backward.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..data.batch import SpectraBatch
from ..linalg import lowrank
from ..physics.tau import omega_func, tau as tau_line
from .params import QFAParams

Tensor = torch.Tensor

__all__ = [
    "ModelOptions",
    "PredictResult",
    "absorption",
    "noise_diagonal",
    "batch_factors",
    "batch_nll",
    "mean_nll",
    "loss_and_grads",
    "GradCounts",
    "grad_counts",
    "normalize_with_counts",
    "normalize_grads",
    "summed_stats",
    "make_delta",
    "predict",
]


class ModelOptions(NamedTuple):
    """Static model configuration.

    ``tau_which`` is a law name or a callable ``tau(z)``; normalize user
    input with :func:`qfa_tpu_torch.physics.tau.resolve_tau`. The plain
    path evaluates a callable exactly; the CUDA kernel takes names only.
    """

    tau_which: str | Callable = "becker"


class PredictResult(NamedTuple):
    """Outputs of continuum prediction for a batch of spectra."""

    ll: Tensor  #: (B,) negative log-likelihood (OOD score).
    hmean: Tensor  #: (B, Nh) posterior mean of the latent factors.
    hcov: Tensor  #: (B, Nh, Nh) posterior covariance.
    continuum: Tensor  #: (B, Npix) predicted unabsorbed continuum F hmean + mu.
    continuum_std: Tensor  #: (B, Npix) predictive std sqrt(diag(F hcov F^T)).


def absorption(
    zabs: Tensor, nr: int, tau_which: str | Callable = "becker"
) -> Tensor:
    """Per-pixel absorption amplitude ``A = [exp(-tau_lya(zabs)), 1...]``,
    shape (..., Nb + nr): blue pixels are attenuated by the Ly-alpha mean
    optical depth at their absorber redshift, red pixels pass through."""
    if callable(tau_which):
        a_blue = torch.exp(-torch.as_tensor(tau_which(zabs)))
    else:
        a_blue = torch.exp(-tau_line(zabs, which=tau_which, series=1))
    ones = torch.ones(zabs.shape[:-1] + (nr,), dtype=a_blue.dtype,
                      device=a_blue.device)
    return torch.cat([a_blue, ones], dim=-1)


def noise_diagonal(
    params: QFAParams, batch: SpectraBatch, amp: Tensor
) -> tuple[Tensor, Tensor, Tensor]:
    """Masked noise diagonal ``D = A^2 Psi + omega * zdep + error^2``.

    Returns ``(dinv, log_d, zdep)`` where masked pixels have ``dinv = 0``
    and ``log_d = 0`` (the masked-precision encoding of row deletion).
    """
    nr = batch.npix - batch.nb
    zdep = omega_func(batch.zabs, params.tau0, params.beta, params.c0)
    omega_full = torch.cat(
        [params.omega * zdep,
         torch.zeros(zdep.shape[:-1] + (nr,), dtype=zdep.dtype,
                     device=zdep.device)],
        dim=-1,
    )
    mask = batch.mask.to(amp.dtype)
    d = amp * amp * params.Psi + omega_full + batch.error * batch.error
    safe_d = torch.where(mask > 0, d, 1.0)
    dinv = mask / safe_d
    log_d = mask * torch.log(safe_d)
    return dinv, log_d, zdep


def batch_factors(
    params: QFAParams,
    batch: SpectraBatch,
    options: ModelOptions = ModelOptions(),
    *,
    gram: Tensor | None = None,
) -> tuple[lowrank.LowRankFactors, Tensor]:
    """Factorize the masked likelihood for every spectrum in the batch.

    Returns the low-rank factors and the absorption amplitude ``A``.
    """
    nr = batch.npix - batch.nb
    amp = absorption(batch.zabs, nr, options.tau_which)
    dinv, log_d, _ = noise_diagonal(params, batch, amp)
    mask = batch.mask.to(amp.dtype)
    factors = lowrank.factorize(
        params.F, batch.delta * mask, amp, dinv, log_d, mask, gram=gram
    )
    return factors, amp


def batch_nll(
    params: QFAParams,
    batch: SpectraBatch,
    options: ModelOptions = ModelOptions(),
) -> Tensor:
    """Per-spectrum negative log-likelihood, shape (B,); all-masked rows
    evaluate to exactly 0."""
    factors, _ = batch_factors(params, batch, options)
    return lowrank.nll(factors)


def mean_nll(
    params: QFAParams,
    batch: SpectraBatch,
    options: ModelOptions = ModelOptions(),
) -> Tensor:
    """Weighted batch-mean NLL (padding-aware): the training loss."""
    per = batch_nll(params, batch, options)
    w = batch.weight.to(per.dtype)
    return torch.sum(per * w) / torch.clamp(torch.sum(w), min=1.0)


def loss_and_grads(
    params: QFAParams,
    batch: SpectraBatch,
    options: ModelOptions = ModelOptions(),
    reference_norm: bool = True,
) -> tuple[Tensor, QFAParams]:
    """Batch loss and parameter gradients by ``torch.autograd``.

    The summed weighted NLL is differentiated; with ``reference_norm`` the
    gradients are divided per element by the number of spectra that could
    have contributed (:func:`normalize_grads`), otherwise by the count of
    real rows. Returns (mean NLL over real rows, gradients as a
    :class:`QFAParams` of plain tensors).
    """
    from .params import PARAM_NAMES

    total, n_real, grads, counts = summed_stats(params, batch, options)
    n_real = torch.clamp(n_real, min=1.0)
    if reference_norm:
        grads = normalize_with_counts(grads, counts)
    else:
        grads = QFAParams(*(getattr(grads, k).detach() / n_real
                            for k in PARAM_NAMES))
    return total / n_real, grads.requires_grad_(False)


def summed_stats(
    params: QFAParams,
    batch: SpectraBatch,
    options: ModelOptions = ModelOptions(),
) -> tuple[Tensor, Tensor, QFAParams, "GradCounts"]:
    """``(nll_sum, n_real, grads_sum, counts)`` of one batch: the weighted
    NLL sum, the sum of the weights, the gradients of the NLL sum by
    ``torch.autograd`` and :func:`grad_counts`, all plain sums with no
    normalization. The contract of the step kernel
    (``ops.fused_step.fused_loss_grads``) and the independent check of its
    analytic backward."""
    from .params import PARAM_NAMES

    # a fresh module: its nn.Parameters are the leaves differentiated
    leaf = QFAParams(**{k: getattr(params, k).detach().clone()
                        for k in PARAM_NAMES})
    with torch.enable_grad():
        per = batch_nll(leaf, batch, options)
        w = batch.weight.to(per.dtype)
        total = torch.sum(per * w)
        grads = torch.autograd.grad(
            total, [getattr(leaf, k) for k in PARAM_NAMES])
    grads = QFAParams(*(g.detach() for g in grads)).requires_grad_(False)
    return total.detach(), torch.sum(w), grads, grad_counts(batch)


class GradCounts(NamedTuple):
    """Per-element contribution counts for the reference-style gradient
    averaging."""

    pix: Tensor  #: (Npix,) spectra observing each pixel.
    scalar: Tensor  #: () spectra with at least one observed blue pixel.


def grad_counts(batch: SpectraBatch) -> GradCounts:
    """Count, per gradient element, how many spectra contributed."""
    mask = batch.mask.to(torch.float32)
    w = batch.weight.to(mask.dtype)[:, None]
    pix = torch.sum(mask * w, dim=0)
    any_blue = torch.sum(mask[:, : batch.nb] * w, dim=1) > 0
    return GradCounts(pix=pix, scalar=torch.sum(any_blue.to(mask.dtype)))


def normalize_with_counts(grads: QFAParams, counts: GradCounts) -> QFAParams:
    """Divide summed gradients by per-element contribution counts; an
    element no spectrum contributed to gets gradient 0 (not 0/0)."""

    def div(g, c):
        return torch.where(c > 0, g / torch.clamp(c, min=1.0),
                           torch.zeros_like(g))

    g = {k: getattr(grads, k).detach() for k in
         ("F", "Psi", "omega", "tau0", "c0", "beta")}
    nb = g["omega"].shape[0]
    return QFAParams(
        F=div(g["F"], counts.pix[:, None]),
        Psi=div(g["Psi"], counts.pix),
        omega=div(g["omega"], counts.pix[:nb]),
        tau0=div(g["tau0"], counts.scalar),
        c0=div(g["c0"], counts.scalar),
        beta=div(g["beta"], counts.scalar),
    ).requires_grad_(False)


def normalize_grads(grads: QFAParams, batch: SpectraBatch) -> QFAParams:
    """Reference-compatible per-element gradient averaging: each element
    over the spectra observing that pixel (:func:`grad_counts`)."""
    return normalize_with_counts(grads, grad_counts(batch))


def make_delta(flux: Tensor, mu: Tensor, amp: Tensor, mask: Tensor) -> Tensor:
    """Residual field ``delta = flux - mu * A`` with masked pixels zeroed
    (the prediction path's single-line Ly-alpha absorption)."""
    m = mask.to(amp.dtype)
    return (flux - mu * amp) * m


@torch.no_grad()
def predict(
    params: QFAParams,
    mu: Tensor,
    flux: Tensor,
    error: Tensor,
    zabs: Tensor,
    mask: Tensor,
    options: ModelOptions = ModelOptions(),
) -> PredictResult:
    """Batched continuum prediction and OOD scoring: likelihood (OOD
    score), posterior latents, the unabsorbed continuum ``F hmean + mu`` on
    the full grid, and its uncertainty. Array arguments may carry
    arbitrary leading batch dimensions."""
    nb = zabs.shape[-1]
    nr = flux.shape[-1] - nb
    amp = absorption(zabs, nr, options.tau_which)
    delta = make_delta(flux, mu, amp, mask)
    batch = SpectraBatch(
        delta=delta,
        error=error,
        zabs=zabs,
        mask=mask,
        weight=torch.ones(flux.shape[:-1], dtype=flux.dtype,
                          device=flux.device),
    )
    factors, _ = batch_factors(params, batch, options)
    ll = lowrank.nll(factors)
    hmean, hcov = lowrank.solve_posterior(factors)
    continuum = torch.matmul(hmean, params.F.T) + mu
    fh = torch.matmul(hcov, params.F.T)  # (B, Nh, Npix)
    var = torch.einsum("...hp,ph->...p", fh, params.F)
    return PredictResult(
        ll=ll,
        hmean=hmean,
        hcov=hcov,
        continuum=continuum,
        continuum_std=torch.sqrt(torch.clamp(var, min=0.0)),
    )
