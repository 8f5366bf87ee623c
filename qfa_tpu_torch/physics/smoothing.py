"""Smoothing utilities.

Two smoothers, as in ``qfa_tpu.physics.smoothing``:

* :func:`smooth_curve` — reflect-padded moving average, applied once on the
  host to the data-driven mean continuum (numpy).
* :func:`sliding_mean` — edge-truncated centred sliding-window mean (the
  semantics of ``avg_pool1d(..., count_include_pad=False)``), applied to
  the model parameters every few epochs. One cumulative sum, as the JAX
  package computes it, so both round alike.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

__all__ = ["smooth_curve", "sliding_mean"]


def smooth_curve(s: np.ndarray, window_len: int = 32) -> np.ndarray:
    """Reflect-padded moving average of a 1-D curve (host-side numpy):
    reflect ``window_len - 1`` samples at each end, convolve with a flat
    kernel, crop back to the input length."""
    s = np.asarray(s)
    padded = np.r_[s[window_len - 1 : 0 : -1], s, s[-2 : -window_len - 1 : -1]]
    kernel = np.ones(window_len, dtype=float) / window_len
    y = np.convolve(kernel, padded, mode="valid")
    return y[int(window_len / 2 - 1) : -int(window_len / 2)]


def sliding_mean(x: Tensor, window: int, axis: int = -1) -> Tensor:
    """Edge-truncated centred sliding mean along ``axis``.

    For odd ``window`` = 2k+1, ``out[i] = mean(x[max(0, i-k) : i+k+1])``,
    dividing by the number of in-range samples.
    """
    if window % 2 != 1:
        raise ValueError(f"sliding_mean requires an odd window, got {window}")
    k = window // 2
    x = torch.movedim(x, axis, 0)
    n = x.shape[0]
    zero = torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device)
    csum = torch.cat([zero, torch.cumsum(x, dim=0)], dim=0)  # (n+1, ...)
    idx = torch.arange(n, device=x.device)
    lo = torch.clamp(idx - k, 0, n)  # inclusive start
    hi = torch.clamp(idx + k + 1, 0, n)  # exclusive end
    count = (hi - lo).to(x.dtype).reshape((n,) + (1,) * (x.ndim - 1))
    return torch.movedim((csum[hi] - csum[lo]) / count, 0, axis)
