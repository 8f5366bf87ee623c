"""The plain reference of QFA (arXiv:2207.02788), in plain PyTorch.

Written for the benchmark from the paper's equations; it imports nothing
of the program and takes nothing the program made. For one spectrum with
residual ``delta = flux - mu A`` on the observed pixels, the marginal
likelihood is Gaussian with covariance ``Ftil Ftil^T + diag(D)``,
``Ftil = diag(A) F`` and ``D = A^2 Psi + omega zdep + sigma^2`` (``omega
zdep`` on the blue side only), so with ``K = I + Ftil^T D^-1 Ftil`` and
``w = Ftil^T D^-1 delta``:

    nll   = 1/2 (delta^T D^-1 delta - w^T K^-1 w + n log 2 pi
                 + sum log D + log det K)
    hmean = K^-1 w,  hcov = K^-1
    continuum = F hmean + mu,  std = sqrt(diag(F hcov F^T))

Training minimizes the batch's summed nll with Adam (L2 weight decay
folded into the gradient, per-element gradients divided by the number of
spectra that observe the pixel, the scalars' by the number of spectra
with an observed blue pixel, the learning rate and bias corrections
stepped per epoch, then a clip to the parameters' box; every
``smooth_interval`` epochs F, Psi and omega are replaced by their
centred sliding means along wavelength, windows of 31, 15 and 15 pixels,
each the mean of the pixels in range); the gradients come from
``torch.autograd``.

Every product goes through ``mm``: float64 ``torch.matmul``, or, where
the configuration states a rounding of the products' operands (training:
bf16 operands, float32 sums) or a control asks for a lower one, a
function that rounds both operands (and, in the backward pass, the
cotangent) and multiplies in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LYA = 1215.6701
LOG_2PI = math.log(2.0 * math.pi)
BECKER = (0.751, 2.90, -0.132, 3.5)
NAMES = ("F", "Psi", "omega", "tau0", "c0", "beta")
#: the parameters' box after every update: (min, max)
BOX = {"Psi": (1e-3, 2.0), "omega": (1e-3, 2.0), "tau0": (0.0, 1.0),
       "c0": (-5.0, 5.0), "beta": (0.1, 5.0)}


class _Rounded(torch.autograd.Function):
    """``a @ b`` on rounded operands; the backward products round their
    operands too."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        ar, br = rnd(a.float()), rnd(b.float())
        ctx.save_for_backward(ar, br)
        ctx.rnd = rnd
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = ctx.rnd(g.float())
        return gr @ br.mT, ar.mT @ gr, None


def rounded_matmul(rnd):
    """A product in the precision of ``rnd`` (operands rounded, float32
    sums) with TF32 off."""
    def mm(a, b):
        out = _Rounded.apply(a, b, rnd)
        return out if a.dtype == torch.float32 else out.to(a.dtype)
    return mm


def round_tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_bf16(x):
    """bfloat16 operands: the stated precision of training's products."""
    return x.to(torch.bfloat16).to(torch.float32)


def round_fp8(x):
    """fp8 e4m3 with one scale per tensor (its largest magnitude at 448)."""
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


ROUNDING = {"tf32": round_tf32, "bf16": round_bf16, "fp8": round_fp8}


def product(precision: str | None):
    """The reference's product: float64 for None, else on operands
    rounded to ``precision`` with float32 sums."""
    return torch.matmul if precision is None else rounded_matmul(
        ROUNDING[precision])


def tau_becker(z):
    t0, beta, c, z0 = BECKER
    return t0 * ((1.0 + z) / (1.0 + z0)) ** beta + c


def blue_zabs(zqso, wav_blue):
    return (1.0 + zqso)[:, None] * wav_blue / LYA - 1.0


def _factor(p, delta, err, mask, zqso, wav_blue, mm):
    """(nll, K, w, n_obs) of a block; ``mask`` is boolean, ``delta`` zero
    where it is False."""
    nb = wav_blue.shape[0]
    m = mask.to(delta.dtype)
    zabs = blue_zabs(zqso, wav_blue)
    amp = torch.ones_like(delta)
    amp[:, :nb] = torch.exp(-tau_becker(zabs))
    root = 1.0 - p["c0"] - torch.exp(-p["tau0"] * (1.0 + zabs) ** p["beta"])
    forest = torch.cat([p["omega"] * root * root,
                        torch.zeros_like(delta[:, nb:])], dim=1)
    d = amp * amp * p["Psi"] + forest + err * err
    d = torch.where(mask, d, torch.ones_like(d))
    dinv = m / d
    nh = p["F"].shape[1]
    gram = (p["F"][:, :, None] * p["F"][:, None, :]).reshape(-1, nh * nh)
    eye = torch.eye(nh, dtype=delta.dtype, device=delta.device)
    k = eye + mm(amp * amp * dinv, gram).reshape(-1, nh, nh)
    w = mm(amp * dinv * delta, p["F"])
    chol = torch.linalg.cholesky(k)
    y = torch.linalg.solve_triangular(chol, w[:, :, None], upper=False)[..., 0]
    n_obs = m.sum(dim=1)
    nll = 0.5 * ((delta * delta * dinv).sum(dim=1) - (y * y).sum(dim=1)
                 + n_obs * LOG_2PI + (m * torch.log(d)).sum(dim=1)
                 + 2.0 * torch.log(torch.diagonal(chol, dim1=1, dim2=2)
                                   ).sum(dim=1))
    return nll, k, w, n_obs


@torch.no_grad()
def predict(p, mu, flux, err, zqso, wav, nb, *, dtype=torch.float64,
            precision=None):
    """The prediction of a block of spectra (flux and error zero, or
    ``-999``, at masked pixels): ll, n_obs, hmean, hcov, continuum, std."""
    mm = product(precision)
    dt = dtype if precision is None else torch.float32
    p = {k: v.to(dt) for k, v in p.items()}
    flux, err = flux.to(dt), err.to(dt)
    mask = (flux != -999.0) & (err != -999.0) & (err > 0)
    flux = torch.where(mask, flux, torch.zeros_like(flux))
    err = torch.where(mask, err, torch.zeros_like(err))
    wav_blue = torch.as_tensor(np.asarray(wav[:nb]), dtype=dt,
                               device=flux.device)
    zqso = zqso.to(dt)
    nb_ = wav_blue.shape[0]
    amp_blue = torch.exp(-tau_becker(blue_zabs(zqso, wav_blue)))
    mu = mu.to(dt)
    amp = torch.cat([amp_blue, torch.ones_like(flux[:, nb_:])], dim=1)
    delta = (flux - mu * amp) * mask
    nll, k, w, n_obs = _factor(p, delta, err, mask, zqso, wav_blue, mm)
    hcov = torch.cholesky_inverse(torch.linalg.cholesky(k))
    hmean = (hcov @ w[:, :, None])[..., 0]
    cont = mm(hmean, p["F"].T) + mu
    fh = mm(hcov.reshape(-1, hcov.shape[-1]), p["F"].T).reshape(
        hcov.shape[0], hcov.shape[1], -1)
    var = (fh * p["F"].T[None]).sum(dim=1)
    return dict(ll=nll, n_obs=n_obs, hmean=hmean, hcov=hcov, continuum=cont,
                continuum_std=torch.sqrt(torch.clamp(var, min=0.0)))


def tile_permutation(seed: int, epoch: int, n_tiles: int) -> torch.Tensor:
    """A frozen copy of the trainer's documented shuffle (a tile
    permutation from a generator seeded by (seed, epoch, stream 0))."""
    state = np.random.SeedSequence([int(seed), int(epoch), 0])
    g = torch.Generator().manual_seed(int(state.generate_state(1, np.uint64)[0]))
    return torch.randperm(n_tiles, generator=g)


def schedule(epoch: int, cfg: dict) -> tuple[float, float, float]:
    """(learning rate, bias corrections) of epoch counter ``epoch``."""
    t = epoch + 1
    lr = cfg["learning_rate"] * cfg["decay_alpha"] ** (t // cfg["decay_step"])
    return lr, 1.0 - cfg["b1"] ** t, 1.0 - cfg["b2"] ** t


def batch_rows(seed: int, epoch: int, n_real: int, batch: int, tile: int
               ) -> list[torch.Tensor]:
    """The rows of each batch of an epoch: the padded set is cut into
    tiles of ``tile`` rows, an epoch's tile permutation groups them into
    batches; padding rows (at ``n_real`` and after) are left out."""
    n_batches = -(-n_real // batch)
    n_tiles = n_batches * batch // tile
    perm = tile_permutation(seed, epoch, n_tiles)
    tpb = batch // tile
    rows = (perm[:, None] * tile + torch.arange(tile)[None, :]).reshape(
        n_batches, tpb * tile)
    return [r[r < n_real] for r in rows]


#: the smoothing's window, in pixels, of each smoothed leaf
SMOOTH = {"F": 31, "Psi": 15, "omega": 15}


def smooth(params: dict) -> dict:
    """The periodic smoothing: each smoothed leaf's centred sliding mean
    along wavelength, over the pixels of the window that are in range."""
    out = dict(params)
    for k, w in SMOOTH.items():
        x = params[k].reshape(params[k].shape[0], -1).T[:, None, :]
        y = torch.nn.functional.avg_pool1d(
            x, w, stride=1, padding=w // 2, count_include_pad=False)
        out[k] = y[:, 0, :].T.reshape(params[k].shape)
    return out


def init_state(p0: dict, dtype=torch.float64, m0=None, v0=None) -> dict:
    """Parameters and Adam's moments (zero unless ``m0``/``v0`` give
    them) in ``dtype``."""
    params = {k: p0[k].detach().to(dtype).clone() for k in NAMES}

    def moment(given):
        return {k: torch.zeros_like(v) if given is None
                else given[k].detach().to(dtype).clone()
                for k, v in params.items()}

    return {"params": params, "m": moment(m0), "v": moment(v0)}


def train_epochs(state: dict, delta, err, zqso, wav, nb, cfg: dict, *,
                 seed: int, first_epoch: int, n_epochs: int,
                 precision=None, keep_fraction: float = 1.0,
                 on_epoch=None) -> list[float]:
    """``n_epochs`` epochs of Adam on the resident set, in place on
    ``state``, smoothing after each epoch counter that reaches a multiple
    of ``cfg["smooth_interval"]`` (if given); returns each epoch's loss
    (the mean over batches of each batch's mean nll, summed and divided
    by ``N // batch``).
    ``keep_fraction`` < 1 trains each batch on its first rows only (a
    fault: part of the batch left out, the mean taken over the rest)."""
    mm = product(precision)
    dt = state["params"]["F"].dtype
    dev = delta.device
    n_real = delta.shape[0]
    wav_blue = torch.as_tensor(np.asarray(wav[:nb]), dtype=dt, device=dev)
    b1, b2, eps, wd = cfg["b1"], cfg["b2"], cfg["eps"], cfg["weight_decay"]
    losses = []
    for e in range(first_epoch, first_epoch + n_epochs):
        lr, bc1, bc2 = schedule(e, cfg)
        total = torch.zeros((), dtype=torch.float64, device=dev)
        for rows in batch_rows(seed, e, n_real, cfg["batch_size"],
                               cfg["tile"]):
            if keep_fraction < 1.0:
                rows = rows[:max(1, int(len(rows) * keep_fraction))]
            rows = rows.to(dev)
            d = delta[rows].to(dt)
            er = err[rows].to(dt)
            mask = er > 0
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in state["params"].items()}
            with torch.enable_grad():
                nll, *_ = _factor(leaves, d, er, mask, zqso[rows].to(dt),
                                  wav_blue, mm)
                loss = nll.sum()
                grads = torch.autograd.grad(loss, [leaves[k] for k in NAMES])
            total += loss.detach().double() / len(rows)
            pix = mask.sum(dim=0).to(dt)
            scal = (mask[:, :nb].sum(dim=1) > 0).sum().to(dt)
            counts = {"F": pix[:, None], "Psi": pix, "omega": pix[:nb],
                      "tau0": scal, "c0": scal, "beta": scal}
            for k, g in zip(NAMES, grads):
                c = counts[k]
                g = torch.where(c > 0, g / torch.clamp(c, min=1.0),
                                torch.zeros_like(g))
                p = state["params"][k]
                g = g + wd * p
                m = b1 * state["m"][k] + (1.0 - b1) * g
                v = b2 * state["v"][k] + (1.0 - b2) * g * g
                p = p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
                if k in BOX:
                    p = torch.clamp(p, *BOX[k])
                state["params"][k], state["m"][k], state["v"][k] = p, m, v
        losses.append(float(total) / (n_real // cfg["batch_size"]))
        every = cfg.get("smooth_interval")
        if every and (e + 1) % every == 0:
            state["params"] = smooth(state["params"])
        if on_epoch is not None:
            on_epoch(e, state)
    return losses
