"""Unrolled Cholesky factorization and solves for tiny SPD matrices.

For small static Nh the factorization is ~Nh^2/2 scalar formulas; written
out over the batch dimension they run as a few elementwise tensor ops per
entry. The same operation order as ``qfa_tpu.linalg.smallchol`` and the
device helpers in ``csrc/smallchol.cuh``.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

MAX_UNROLL_DIM = 16

__all__ = [
    "MAX_UNROLL_DIM",
    "cholesky_small",
    "solve_lower_small",
    "solve_upper_small",
    "chol_solve_small",
    "logdet_from_chol",
    "inverse_from_chol",
]


def cholesky_small(k: Tensor) -> Tensor:
    """Lower Cholesky of (..., n, n) SPD matrices, unrolled over n (the
    strictly-upper triangle of the result is zero)."""
    n = k.shape[-1]
    if n > MAX_UNROLL_DIM:
        return torch.linalg.cholesky(k)
    col: list[list[Tensor]] = [[None] * n for _ in range(n)]
    for j in range(n):
        s = k[..., j, j]
        for p in range(j):
            s = s - col[j][p] * col[j][p]
        d = torch.sqrt(s)
        inv_d = 1.0 / d
        col[j][j] = d
        for i in range(j + 1, n):
            s = k[..., i, j]
            for p in range(j):
                s = s - col[i][p] * col[j][p]
            col[i][j] = s * inv_d
    zero = torch.zeros_like(k[..., 0, 0])
    rows = [
        torch.stack([col[i][j] if j <= i else zero for j in range(n)], dim=-1)
        for i in range(n)
    ]
    return torch.stack(rows, dim=-2)


def solve_lower_small(chol: Tensor, b: Tensor) -> Tensor:
    """Solve ``L y = b`` by unrolled forward substitution.

    ``chol``: (..., n, n) lower triangular; ``b``: (..., n).
    """
    n = chol.shape[-1]
    y: list[Tensor] = []
    for i in range(n):
        s = b[..., i]
        for j in range(i):
            s = s - chol[..., i, j] * y[j]
        y.append(s / chol[..., i, i])
    return torch.stack(y, dim=-1)


def solve_upper_small(chol: Tensor, y: Tensor) -> Tensor:
    """Solve ``L^T x = y`` by unrolled back substitution (``chol`` lower)."""
    n = chol.shape[-1]
    x: list[Tensor] = [None] * n
    for i in reversed(range(n)):
        s = y[..., i]
        for j in range(i + 1, n):
            s = s - chol[..., j, i] * x[j]
        x[i] = s / chol[..., i, i]
    return torch.stack(x, dim=-1)


def chol_solve_small(chol: Tensor, b: Tensor) -> Tensor:
    """Solve ``K x = b`` given the lower Cholesky of K."""
    return solve_upper_small(chol, solve_lower_small(chol, b))


def logdet_from_chol(chol: Tensor) -> Tensor:
    """``logdet K = 2 sum log diag(L)``."""
    return 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1
    )


def inverse_from_chol(chol: Tensor) -> Tensor:
    """Full inverse ``K^-1`` from the Cholesky (n columns of solves)."""
    n = chol.shape[-1]
    eye = torch.eye(n, dtype=chol.dtype, device=chol.device)
    cols = [
        chol_solve_small(chol, eye[i].expand(chol.shape[:-2] + (n,)))
        for i in range(n)
    ]
    return torch.stack(cols, dim=-1)
