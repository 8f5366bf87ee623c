"""Conditional density estimation of the latent factors: P(h | z, lum).

The port of ``qfa_tpu.models.mdn``: a mixture density network (a small
tanh MLP emitting a full-covariance Gaussian mixture over the latent
vector ``h``), fit by maximum likelihood, for the mock-continuum
notebook's use (sample ``h`` given quasar redshift and luminosity, then
synthesize ``F h + mu``). The weights live in :class:`MDNParams`, an
``nn.Module`` whose dense layers keep the JAX package's ``(n_in, n_out)``
layout (``x @ W + b``), so :meth:`MDNParams.from_numpy` carries the JAX
package's ``MDNParams`` over unchanged. ``optax.adam`` becomes
``torch.optim.Adam`` (the same defaults: b1 0.9, b2 0.999, eps 1e-8 added
outside the square root), ``jax.random`` keys an explicit
``torch.Generator`` (draws are made on the generator's device and moved
to the model's), and the device is explicit, ``cuda`` by default.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device, to_device

Tensor = torch.Tensor

__all__ = ["MDNConfig", "MDNParams", "init_mdn", "mdn_log_prob",
           "mdn_sample", "fit_mdn", "sample_mock_continua"]


class MDNConfig(NamedTuple):
    """Architecture of the conditional mixture density network."""

    cond_dim: int = 2  #: conditioning variables (z, lum).
    out_dim: int = 8  #: latent dimension Nh.
    n_components: int = 8  #: mixture components.
    hidden: tuple = (64, 64)  #: MLP widths.


class _Dense(nn.Module):
    """``x @ w + b`` with ``w`` of shape (n_in, n_out)."""

    def __init__(self, w: Tensor, b: Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x: Tensor) -> Tensor:
        return x @ self.w + self.b


class MDNParams(nn.Module):
    """The MDN's weights: the trunk's dense ``layers`` and the four heads
    (``head_logits`` -> (K,), ``head_mean`` -> (K*d,), ``head_scale`` ->
    the diagonal log-scales, ``head_tril`` -> the strictly-lower Cholesky
    entries), each ``(W, b)`` as in the JAX package; ``config`` is the
    architecture they were built for. Calling the module gives
    :func:`mdn_log_prob`."""

    def __init__(self, config: MDNConfig, layers, head_logits, head_mean,
                 head_scale, head_tril):
        super().__init__()
        self.config = MDNConfig(*config)
        self.layers = nn.ModuleList(_Dense(*wb) for wb in layers)
        self.head_logits = _Dense(*head_logits)
        self.head_mean = _Dense(*head_mean)
        self.head_scale = _Dense(*head_scale)
        self.head_tril = _Dense(*head_tril)

    def forward(self, cond: Tensor, h: Tensor) -> Tensor:
        return mdn_log_prob(self, cond, h, self.config)

    @classmethod
    def from_numpy(cls, params, *, device=None,
                   dtype: torch.dtype = torch.float32) -> "MDNParams":
        """Build from the JAX package's ``MDNParams`` with numpy leaves
        (``jax.tree.map(np.asarray, params)``), or any 5-sequence
        ``(layers, head_logits, head_mean, head_scale, head_tril)`` of
        ``(W, b)`` pairs; the architecture is read off the shapes."""
        layers, logits, mean, scale, tril = params

        def t(x):
            return torch.tensor(np.asarray(x), dtype=dtype, device=device)

        def pair(wb):
            return t(wb[0]), t(wb[1])

        k = np.shape(logits[0])[1]
        first = layers[0][0] if len(layers) else logits[0]
        config = MDNConfig(
            cond_dim=np.shape(first)[0], out_dim=np.shape(mean[0])[1] // k,
            n_components=k, hidden=tuple(np.shape(w)[1] for w, _ in layers))
        return cls(config, [pair(wb) for wb in layers], pair(logits),
                   pair(mean), pair(scale), pair(tril))


def _draw(fn, *args, generator: torch.Generator | None, device, **kw
          ) -> Tensor:
    """``fn(*args)`` (a torch sampler) drawn on the generator's device,
    moved to ``device``."""
    where = generator.device if generator is not None else device
    return fn(*args, generator=generator, device=where, **kw).to(device)


def _dense_init(generator, n_in: int, n_out: int, device, scale=None):
    scale = scale if scale is not None else (2.0 / (n_in + n_out)) ** 0.5
    w = scale * _draw(torch.randn, (n_in, n_out), generator=generator,
                      device=device, dtype=torch.float32)
    return w, torch.zeros((n_out,), dtype=torch.float32, device=device)


def init_mdn(generator: torch.Generator | None,
             config: MDNConfig = MDNConfig(), *, device="cuda") -> MDNParams:
    """Random weights (the JAX package's scales: Glorot-normal trunk and
    heads, 1e-2 on the scale and Cholesky heads, zero biases), drawn from
    ``generator`` onto ``device``."""
    dev = resolve_device(device)
    layers = []
    n_in = config.cond_dim
    for width in config.hidden:
        layers.append(_dense_init(generator, n_in, width, dev))
        n_in = width
    k, d = config.n_components, config.out_dim
    n_tril = d * (d - 1) // 2
    return MDNParams(
        config, layers,
        head_logits=_dense_init(generator, n_in, k, dev),
        head_mean=_dense_init(generator, n_in, k * d, dev),
        head_scale=_dense_init(generator, n_in, k * d, dev, scale=1e-2),
        head_tril=_dense_init(generator, n_in, k * n_tril, dev, scale=1e-2),
    )


def _heads(params: MDNParams, cond: Tensor, config: MDNConfig):
    """Mixture parameters for each condition: logits, means, scale_tril,
    log_scale."""
    x = cond
    for layer in params.layers:
        x = torch.tanh(layer(x))
    k, d = config.n_components, config.out_dim
    batch = x.shape[:-1]
    logits = params.head_logits(x)
    means = params.head_mean(x).reshape(batch + (k, d))
    log_scale = torch.clamp(params.head_scale(x).reshape(batch + (k, d)),
                            -7.0, 3.0)
    tril_flat = params.head_tril(x).reshape(batch + (k, d * (d - 1) // 2))
    rows, cols = torch.tril_indices(d, d, -1, device=x.device)
    tril = torch.zeros(batch + (k, d, d), dtype=x.dtype, device=x.device)
    tril[..., rows, cols] = tril_flat
    # diagonal exp(log_scale), strictly below it the tril head
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    scale_tril = tril + torch.exp(log_scale)[..., :, None] * eye
    return logits, means, scale_tril, log_scale


def mdn_log_prob(params: MDNParams, cond: Tensor, h: Tensor,
                 config: MDNConfig | None = None) -> Tensor:
    """log P(h | cond) under the mixture; shapes (..., cond_dim),
    (..., d) -> (...). ``config`` defaults to the one ``params`` was built
    for."""
    config = params.config if config is None else config
    logits, means, scale_tril, log_scale = _heads(params, cond, config)
    d = config.out_dim
    diff = h[..., None, :] - means  # (..., k, d)
    y = torch.linalg.solve_triangular(scale_tril, diff[..., None],
                                      upper=False)[..., 0]
    quad = torch.sum(y * y, dim=-1)
    logdet = torch.sum(log_scale, dim=-1)
    comp_lp = -0.5 * (quad + d * math.log(2 * math.pi)) - logdet
    return torch.logsumexp(torch.log_softmax(logits, -1) + comp_lp, dim=-1)


@torch.no_grad()
def mdn_sample(params: MDNParams, generator: torch.Generator | None,
               cond: Tensor, n: int, config: MDNConfig | None = None
               ) -> Tensor:
    """Draw ``n`` samples of h for each condition row; returns (n, ...,
    d). The component is drawn by the Gumbel-max rule (as
    ``jax.random.categorical``), then ``mean + L eps``. ``config``
    defaults to the one ``params`` was built for."""
    config = params.config if config is None else config
    logits, means, scale_tril, _ = _heads(params, cond, config)
    dev = logits.device
    u = _draw(torch.rand, (n,) + logits.shape, generator=generator,
              device=dev, dtype=logits.dtype)
    comp = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)  # (n, ...)
    eps = _draw(torch.randn, (n,) + cond.shape[:-1] + (config.out_dim,),
                generator=generator, device=dev, dtype=logits.dtype)
    mean_sel = torch.take_along_dim(
        means.expand((n,) + means.shape), comp[..., None, None], dim=-2
    )[..., 0, :]
    tril_sel = torch.take_along_dim(
        scale_tril.expand((n,) + scale_tril.shape),
        comp[..., None, None, None], dim=-3)[..., 0, :, :]
    return mean_sel + torch.einsum("...ij,...j->...i", tril_sel, eps)


def fit_mdn(
    generator: torch.Generator | None,
    cond,
    h,
    config: MDNConfig = MDNConfig(),
    *,
    n_steps: int = 2000,
    batch_size: int = 512,
    learning_rate: float = 1e-3,
    normalize: bool = True,
    device="cuda",
) -> tuple[MDNParams, dict]:
    """Maximum-likelihood fit of the MDN on ``device``; returns (params,
    fit_info).

    Each step draws a batch of ``min(batch_size, N)`` rows with
    replacement from ``generator``, and ``torch.optim.Adam`` takes one
    step on the batch's mean negative log-likelihood. ``fit_info`` holds
    the conditioning normalizers (``cond_mean``/``cond_std``; apply the
    same transform to ``cond`` before :func:`mdn_log_prob` /
    :func:`mdn_sample`) and ``losses``, the loss of every 100th step. The
    targets ``h`` are modeled in their raw scale (the scale head is
    bounded at exp(+-3)).
    """
    dev = resolve_device(device)
    cond, h = to_device(cond, dev), to_device(h, dev)
    info: dict = {}
    if normalize:
        info["cond_mean"] = cond.mean(0)
        info["cond_std"] = cond.std(0, unbiased=False) + 1e-6
        cond = (cond - info["cond_mean"]) / info["cond_std"]
    params = init_mdn(generator, config, device=dev)
    opt = torch.optim.Adam(params.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    n = cond.shape[0]
    bs = min(batch_size, n)
    losses = []
    for i in range(n_steps):
        idx = _draw(torch.randint, 0, n, (bs,), generator=generator,
                    device=dev)
        loss = -torch.mean(mdn_log_prob(params, cond[idx], h[idx], config))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if i % 100 == 0:
            losses.append(float(loss.detach()))
    info["losses"] = losses
    return params, info


@torch.no_grad()
def sample_mock_continua(
    mdn_params: MDNParams,
    generator: torch.Generator | None,
    cond,
    f,
    mu,
    n: int,
    config: MDNConfig | None = None,
    fit_info: dict | None = None,
) -> Tensor:
    """Mock continua ``F h + mu`` from MDN samples of h, (n, ..., Npix), on
    the MDN's device (the notebook's last step)."""
    dev = mdn_params.head_logits.w.device
    cond = to_device(cond, dev)
    if fit_info and "cond_mean" in fit_info:
        cond = (cond - fit_info["cond_mean"]) / fit_info["cond_std"]
    h = mdn_sample(mdn_params, generator, cond, n, config)
    return h @ to_device(f, dev).T + to_device(mu, dev)
