"""One batch's summed loss, analytic parameter gradients and counts.

:func:`fused_loss_grads` runs

* on CUDA tensors, the hand-written CUDA kernel ``csrc/step.cu`` (the port
  of ``qfa_tpu.ops.fused_step._step_kernel`` with its wrapper's
  lane-direction sums and :func:`finish_f_gradient`), built at first use by
  :mod:`._build`; a launch that fails raises;
* on CPU tensors, :func:`fused_loss_grads_plain`, the same function in
  plain torch ops: the reference the kernel is held against on the card.

The contract is ``models.qfa.summed_stats`` without ``n_real``: the summed
NLL, the summed (not normalized) gradients of every parameter, and the
per-element counts (spectra observing each pixel, spectra with an observed
blue pixel), all after the mask is multiplied by the row weights, so
weight-0 rows (padding, tail duplicates) contribute nothing anywhere. It is
the per-step engine of the host-streaming trainer
(``train.loop.make_fused_step_fn``); the optimizer runs in torch.

``tile_batch`` is accepted for the JAX signature's sake: on the TPU it was
the batch tile of a sequential grid, on the card the tile is no unit of
work (every row is a block of the forward stage), so it has no effect.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..data.batch import SpectraBatch
from ..linalg import smallchol
from ..linalg.lowrank import LOG_2PI
from ..models.params import PARAM_NAMES, QFAParams
from ..models.qfa import GradCounts
from .common import tau_law_abc

Tensor = torch.Tensor

__all__ = [
    "FusedStepOutputs",
    "LAUNCHES",
    "MAX_NH",
    "finish_f_gradient",
    "fused_loss_grads",
    "fused_loss_grads_plain",
]

#: Calls that launched the CUDA step kernel in this process. Incremented
#: where the wrapper launches the kernel, and nowhere else.
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()

#: the CUDA kernel is instantiated for 1 <= nh <= 10
MAX_NH = 10

#: backward batch rows per block of the CUDA kernel (``kChunk`` in step.cu)
_CHUNK_ROWS = 32
#: slots of the kernel's small output
_OUT = ("loss_sum", "scalar_count", "tau0", "c0", "beta")


class FusedStepOutputs(NamedTuple):
    loss_sum: Tensor  #: () summed NLL over the batch.
    grads: QFAParams  #: summed gradients (not normalized).
    counts: GradCounts  #: per-element contribution counts.

    def to_numpy(self) -> dict:
        """``{"loss_sum": float, "grads": {name: array}, "pix": array,
        "scalar": float}``, float32 arrays, for comparisons."""
        return {
            "loss_sum": float(self.loss_sum),
            "grads": self.grads.to_numpy(),
            "pix": self.counts.pix.detach().cpu().numpy().astype(np.float32),
            "scalar": float(self.counts.scalar),
        }


def finish_f_gradient(drhs: Tensor, f: Tensor, npix: int, nh: int) -> Tensor:
    """Combine Gram-space and direct cotangents into dF:
    ``dF[p,i] = sum_j (dG[p,ij] + dG[p,ji]) F[p,j] + dRHS_F[p,i]``, with
    ``drhs`` holding ``[dG (nh*nh) | dRHS_F (nh) | ...]`` columns and at
    least ``npix`` rows (the JAX function's layout)."""
    dg = drhs[:npix, : nh * nh].reshape(npix, nh, nh)
    dg_sym = dg + dg.transpose(-1, -2)
    direct = drhs[:npix, nh * nh : nh * nh + nh]
    return torch.einsum("pij,pj->pi", dg_sym, f) + direct


def _outputs(loss_sum, grads: dict, pix, scalar) -> FusedStepOutputs:
    return FusedStepOutputs(
        loss_sum=loss_sum,
        grads=QFAParams(**grads).requires_grad_(False),
        counts=GradCounts(pix=pix, scalar=scalar),
    )


def _check_batch(params: QFAParams, batch: SpectraBatch) -> None:
    npix, nh = params.F.shape
    nb = params.omega.shape[0]
    b = batch.delta.shape[0]
    if params.Psi.shape != (npix,) or not 0 <= nb <= npix:
        raise ValueError(f"Psi {tuple(params.Psi.shape)} / omega ({nb},) do "
                         f"not fit F ({npix}, {nh})")
    for name in ("delta", "error", "mask"):
        t = getattr(batch, name)
        if t.ndim != 2 or tuple(t.shape) != (b, npix):
            raise ValueError(f"batch.{name} {tuple(t.shape)} must be "
                             f"(B={b}, Npix={npix})")
    if batch.zabs.ndim != 2 or batch.zabs.shape[0] != b or \
            batch.zabs.shape[1] < nb:
        raise ValueError(f"batch.zabs {tuple(batch.zabs.shape)} must be "
                         f"(B={b}, >= Nb={nb})")
    if tuple(batch.weight.shape) != (b,):
        raise ValueError(f"batch.weight {tuple(batch.weight.shape)} must be "
                         f"(B={b},)")


@torch.no_grad()
def fused_loss_grads_plain(
    params: QFAParams,
    batch: SpectraBatch,
    tau_which: str = "becker",
    tile_batch: int = 256,
) -> FusedStepOutputs:
    """:func:`fused_loss_grads` in plain torch ops, on any device.

    The JAX kernel's arithmetic on batched tensors: the elementwise chain,
    the forward contractions against the full ``nh*nh`` Gram rows
    ``F_pi F_pj``, the explicit unrolled Cholesky
    (``linalg.smallchol``), and the analytic backward (``S = 1/2 (K^-1 +
    alpha alpha^T)``, the per-pixel cotangents, ``dd``) of
    ``qfa_tpu/ops/fused_step.py``; not autograd.
    """
    del tile_batch  # no unit of work here; see the module docstring
    _check_batch(params, batch)
    law_a, law_b, law_c = tau_law_abc(tau_which)
    f32 = torch.float32
    F = params.F.detach().to(f32)
    psi = params.Psi.detach().to(f32)
    omega = params.omega.detach().to(f32)
    tau0, c0, beta = (getattr(params, k).detach().to(f32)
                      for k in ("tau0", "c0", "beta"))
    npix, nh = F.shape
    nb = omega.shape[0]
    b = batch.delta.shape[0]

    # the JAX wrapper's inputs: delta * mask, then mask * weight
    mask0 = batch.mask.to(f32)
    delta = batch.delta.to(f32) * mask0
    m = mask0 * batch.weight.to(f32)[:, None]
    err = batch.error.to(f32)
    zp1 = 1.0 + batch.zabs[:, :nb].to(f32)
    # blue-side absorption chain (B, Nb)
    amp_b = torch.exp(-(law_a * zp1**law_b + law_c))
    zp1b = zp1**beta
    exp_neg = torch.exp(-(tau0 * zp1b))
    root = 1.0 - c0 - exp_neg
    zdep = root * root
    eb, er = err[:, :nb], err[:, nb:]
    d = torch.cat([amp_b * amp_b * psi[:nb] + omega * zdep + eb * eb,
                   psi[nb:] + er * er], dim=1)
    amp = torch.cat([amp_b, torch.ones_like(er)], dim=1)
    d_safe = torch.where(m > 0, d, 1.0)
    dinv = m / d_safe
    delta_m = delta * m
    w = amp * amp * dinv
    u = amp * dinv * delta_m
    q = delta_m * delta_m * dinv
    ql = q + m * torch.log(d_safe)

    # forward contractions against the full Gram rows
    gram = (F[:, :, None] * F[:, None, :]).reshape(npix, nh * nh)
    eye = torch.eye(nh, dtype=f32, device=F.device)
    k = (w @ gram).reshape(b, nh, nh) + eye
    wv = u @ F
    n_obs = m.sum(dim=1)
    n_blue = m[:, :nb].sum(dim=1)
    chol = smallchol.cholesky_small(k)
    y = smallchol.solve_lower_small(chol, wv)
    alpha = smallchol.solve_upper_small(chol, y)
    nll = 0.5 * (ql.sum(dim=1) - (y * y).sum(dim=1) + n_obs * LOG_2PI
                 + smallchol.logdet_from_chol(chol))
    scalar = (n_blue > 0.5).to(f32).sum()

    # analytic backward: S = 1/2 (K^-1 + alpha alpha^T)
    kinv = smallchol.inverse_from_chol(chol)
    s = (0.5 * (kinv + alpha[:, :, None] * alpha[:, None, :])).reshape(
        b, nh * nh)
    dw_pix = s @ gram.T  # F_p^T S F_p
    du_pix = -alpha @ F.T
    drhs = torch.cat([w.T @ s, u.T @ -alpha], dim=1)  # [dG | dRHS_F]
    dd = (-(dw_pix * w + du_pix * u + 0.5 * q) + 0.5 * m) * dinv
    dd_b = dd[:, :nb]
    droot2 = dd_b * omega * 2.0 * root
    dtau_hi = droot2 * exp_neg
    grads = {
        "F": finish_f_gradient(drhs, F, npix, nh),
        "Psi": (dd * amp * amp).sum(dim=0),
        "omega": (dd_b * zdep).sum(dim=0),
        "tau0": (dtau_hi * zp1b).sum(dim=0).sum(),
        "c0": (-droot2).sum(dim=0).sum(),
        "beta": (dtau_hi * tau0 * zp1b * torch.log(zp1)).sum(dim=0).sum(),
    }
    return _outputs(nll.sum(), grads, m.sum(dim=0), scalar)


def _launch(params: QFAParams, batch: SpectraBatch, law) -> FusedStepOutputs:
    from ._build import load_library

    dev = batch.delta.device
    npix, nh = params.F.shape
    nb = params.omega.shape[0]
    if nh < 1 or nh > MAX_NH:
        raise ValueError(f"the CUDA step kernel supports 1 <= nh <= "
                         f"{MAX_NH}; got nh={nh}")
    tensors = {k: getattr(batch, k) for k in SpectraBatch._fields}
    tensors.update({k: getattr(params, k) for k in PARAM_NAMES})
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device} but delta on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b = batch.delta.shape[0]
    ntri = nh * (nh + 1) // 2
    n_chunks = -(-b // _CHUNK_ROWS)
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = torch.empty(
        (b * (ntri + nh + 2) + n_chunks * (ntri + nh + 6) * npix + 3 * nb,),
        **f32)
    s_buf, alpha_buf, rowstat, partials, srows = torch.split(
        scratch, [b * ntri, b * nh, b * 2, n_chunks * (ntri + nh + 6) * npix,
                  3 * nb])
    res = torch.empty((npix * nh + 2 * npix + nb + len(_OUT),), **f32)
    g_f, g_psi, counts, g_omega, out = torch.split(
        res, [npix * nh, npix, npix, nb, len(_OUT)])

    def ptr(t):
        return t.data_ptr()

    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.qfa_step_f32(
            ptr(batch.delta), ptr(batch.error), ptr(batch.zabs),
            batch.zabs.shape[1], ptr(batch.mask), ptr(batch.weight),
            ptr(params.F), ptr(params.Psi), ptr(params.omega),
            ptr(params.tau0), ptr(params.c0), ptr(params.beta),
            *law, b, npix, nb, nh,
            ptr(s_buf), ptr(alpha_buf), ptr(rowstat), ptr(partials),
            ptr(srows), ptr(g_f), ptr(g_psi), ptr(g_omega), ptr(counts),
            ptr(out), n_chunks,
            dev.index if dev.index is not None else torch.cuda.current_device(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"CUDA step kernel launch failed: error {rc} "
            f"({lib.qfa_cuda_error_string(rc).decode()})")
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    grads = {"F": g_f.view(npix, nh), "Psi": g_psi, "omega": g_omega,
             "tau0": out[2], "c0": out[3], "beta": out[4]}
    return _outputs(out[0], grads, counts, out[1])


@torch.no_grad()
def fused_loss_grads(
    params: QFAParams,
    batch: SpectraBatch,
    tau_which: str = "becker",
    tile_batch: int = 256,
) -> FusedStepOutputs:
    """Summed loss, summed analytic gradients and counts of one batch.

    Contract of ``models.qfa.summed_stats`` without ``n_real`` (the caller
    takes it from the batch weights). Any batch size is accepted; rows with
    weight 0 or fully masked contribute exactly zero to every output.
    ``tau_which`` must name a law of ``ops.common.TAU_LAW_ABC``;
    ``tile_batch`` has no effect (module docstring). Tensors on the CPU run
    :func:`fused_loss_grads_plain`; tensors on a CUDA device launch the
    CUDA kernel, or raise (float32, contiguous, all on one device,
    1 <= nh <= 10).
    """
    dev = batch.delta.device
    if dev.type == "cpu":
        return fused_loss_grads_plain(params, batch, tau_which, tile_batch)
    if dev.type != "cuda":
        raise ValueError(
            f"fused_loss_grads runs on cpu or cuda, not {dev}")
    _check_batch(params, batch)
    return _launch(params, batch, tau_law_abc(tau_which))
