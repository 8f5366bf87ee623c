"""Masked low-rank-plus-diagonal Gaussian core, in torch.

The QFA marginal likelihood is a zero-mean Gaussian with covariance

    Sigma = Ftil Ftil^T + diag(D),     Ftil = diag(A) F,

with ``F`` (Npix, Nh) shared by every spectrum, ``A`` a per-spectrum
absorption amplitude and ``D`` a per-spectrum positive diagonal. Missing
pixels take ``Dinv = 0`` (masked precision), which reproduces the
row-deleted quantities exactly:

* quadratic form: masked pixels contribute 0 to ``delta^T Dinv delta``;
* capacitance: ``K = I + Ftil^T diag(Dinv) Ftil`` ignores masked rows;
* log-determinant: ``sum(mask * log D) + logdet K`` equals the submatrix
  log-determinant (matrix determinant lemma).

Everything is O(Npix * Nh^2) per spectrum; no Npix x Npix matrix is ever
built (except by :func:`dense_masked_nll`, the test reference).
Counterpart of ``qfa_tpu.linalg.lowrank``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import smallchol

Tensor = torch.Tensor

LOG_2PI = 1.8378770664093453

__all__ = [
    "LOG_2PI",
    "LowRankFactors",
    "gram_matrix",
    "factorize",
    "solve_posterior",
    "nll",
    "dense_masked_nll",
]


class LowRankFactors(NamedTuple):
    """Per-spectrum factorization of the masked low-rank Gaussian."""

    chol: Tensor  #: (B, Nh, Nh) lower Cholesky of the capacitance K.
    w: Tensor  #: (B, Nh) projected data ``Ftil^T Dinv delta``.
    quad: Tensor  #: (B,) diagonal quadratic form ``delta^T Dinv delta``.
    logdet_d: Tensor  #: (B,) masked diagonal log-determinant ``sum m log D``.
    n_obs: Tensor  #: (B,) number of observed pixels.


def gram_matrix(f: Tensor) -> Tensor:
    """Flattened symmetric Gram tensor ``G[p, i*Nh+j] = F[p,i]*F[p,j]``,
    shape (Npix, Nh*Nh)."""
    npix, nh = f.shape
    return (f[:, :, None] * f[:, None, :]).reshape(npix, nh * nh)


def factorize(
    f: Tensor,
    delta: Tensor,
    amp: Tensor,
    dinv: Tensor,
    log_d: Tensor,
    mask: Tensor,
    *,
    gram: Tensor | None = None,
) -> LowRankFactors:
    """Factorize a batch of masked low-rank Gaussians.

    Args:
        f: (Npix, Nh) shared factor loadings.
        delta: (..., Npix) observed residual spectra.
        amp: (..., Npix) per-pixel amplitude A (absorption; 1 on red side).
        dinv: (..., Npix) masked inverse diagonal, 0 at masked pixels.
        log_d: (..., Npix) ``log D`` with masked entries already zeroed.
        mask: (..., Npix) observation mask (1 observed / 0 missing).
        gram: optional precomputed :func:`gram_matrix` of ``f``.

    The five per-spectrum contractions run as one stacked product
    ``(..., 5, Npix) @ (Npix, Nh^2 + Nh + 1)``.
    """
    npix, nh = f.shape
    if gram is None:
        gram = gram_matrix(f)
    weights = amp * amp * dinv  # -> K
    u = amp * dinv * delta  # -> w
    q = delta * delta * dinv  # -> quad
    lhs = torch.stack([weights, u, q, log_d, mask], dim=-2)  # (..., 5, Npix)
    ones = torch.ones((npix, 1), dtype=f.dtype, device=f.device)
    rhs = torch.cat([gram, f, ones], dim=1)  # (Npix, nh*nh + nh + 1)
    out = torch.matmul(lhs, rhs)  # (..., 5, nh*nh + nh + 1)
    k = out[..., 0, : nh * nh].reshape(out.shape[:-2] + (nh, nh))
    k = k + torch.eye(nh, dtype=k.dtype, device=k.device)
    w = out[..., 1, nh * nh : nh * nh + nh]
    quad = out[..., 2, -1]
    logdet_d = out[..., 3, -1]
    n_obs = out[..., 4, -1]
    chol = smallchol.cholesky_small(k)
    return LowRankFactors(chol=chol, w=w, quad=quad, logdet_d=logdet_d,
                          n_obs=n_obs)


def nll(factors: LowRankFactors) -> Tensor:
    """Negative log-likelihood ``-log N(delta | 0, Sigma)`` per spectrum,

        nll = 1/2 (delta^T Sigma^-1 delta + N log 2pi + logdet Sigma),

    with Woodbury ``delta^T Sigma^-1 delta = quad - w^T K^-1 w`` and the
    determinant lemma ``logdet Sigma = sum m log D + logdet K``.
    """
    y = smallchol.solve_lower_small(factors.chol, factors.w)
    mahal = factors.quad - torch.sum(y * y, dim=-1)
    logdet_k = smallchol.logdet_from_chol(factors.chol)
    return 0.5 * (mahal + factors.n_obs * LOG_2PI + factors.logdet_d
                  + logdet_k)


def solve_posterior(factors: LowRankFactors) -> tuple[Tensor, Tensor]:
    """Posterior mean and covariance of the latent factors:
    ``hcov = K^-1`` and ``hmean = K^-1 w``, shapes (..., Nh) and
    (..., Nh, Nh)."""
    hcov = smallchol.inverse_from_chol(factors.chol)
    hmean = smallchol.chol_solve_small(factors.chol, factors.w)
    return hmean, hcov


def dense_masked_nll(
    f: Tensor, delta: Tensor, amp: Tensor, d: Tensor, mask: Tensor
) -> Tensor:
    """O(Npix^3) dense-matrix reference for tests (single spectrum): the
    full covariance on the observed submatrix, through ``torch.linalg``."""
    keep = mask.to(torch.bool)
    ftil = (amp[:, None] * f)[keep]
    sigma = ftil @ ftil.T + torch.diag(d[keep])
    sub_delta = delta[keep]
    n = sub_delta.shape[0]
    _, logdet = torch.linalg.slogdet(sigma)
    mahal = sub_delta @ torch.linalg.solve(sigma, sub_delta)
    return 0.5 * (mahal + n * LOG_2PI + logdet)
