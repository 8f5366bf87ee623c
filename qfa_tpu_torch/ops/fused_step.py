"""One batch's summed loss, analytic parameter gradients and counts.

:func:`fused_loss_grads` runs

* on CUDA tensors, the hand-written CUDA kernels ``csrc/step.cu`` (the
  port of ``qfa_tpu.ops.fused_step._step_kernel`` with its wrapper's
  lane-direction sums and :func:`finish_f_gradient`: three launches per
  call), built at first use by :mod:`._build`; a launch that fails raises;
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
the batch tile of a sequential grid, on the card the kernels tile the
batch by their own sizes, so it has no effect.

The CUDA branch keeps its host time per call small, since a step's kernels
take ~0.05 ms on an H100 and the card waits for the host until the first
launch: the library is bound once per process, the checks are one pass
over the eleven tensors, the outputs are one allocation, made while the
previous call's kernels ran, and the scratch and the kernels' arrival
counters are kept per (device, stream), made at the first call and
reused while the shapes stay (the kernels leave the counters at zero, so
no call clears them).
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
from . import _build
from .common import tau_law_abc

Tensor = torch.Tensor

__all__ = [
    "EARLY_LAUNCH",
    "FusedStepOutputs",
    "LAUNCHES",
    "MAX_NH",
    "StepGrads",
    "finish_f_gradient",
    "fused_loss_grads",
    "fused_loss_grads_plain",
]

#: Calls that launched the CUDA step kernels in this process. Incremented
#: where the wrapper launches them, and nowhere else.
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()

#: the CUDA kernels are instantiated for 1 <= nh <= 10
MAX_NH = 10

#: Launch the backward and finish kernels early (programmatic dependent
#: launch). False starts each when the one before it has ended, with the
#: same results: for timing each kernel alone.
EARLY_LAUNCH = True

#: per (device index, stream): (shapes, the kernels' scratch, their arrival
#: counters, the two's pointers and lengths for the C entry, a list that
#: holds the next call's output buffer)
_SCRATCH: dict = {}


class StepGrads(NamedTuple):
    """Summed gradients of the parameters, by name (``PARAM_NAMES``)."""

    F: Tensor
    Psi: Tensor
    omega: Tensor
    tau0: Tensor
    c0: Tensor
    beta: Tensor

    def to_numpy(self) -> dict:
        """The gradients as a name -> float32 numpy array dict."""
        return {k: v.detach().cpu().numpy().astype(np.float32)
                for k, v in self._asdict().items()}


class FusedStepOutputs(NamedTuple):
    loss_sum: Tensor  #: () summed NLL over the batch.
    grads: StepGrads  #: summed gradients (not normalized).
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


def _param_tensors(params: QFAParams) -> tuple:
    """F, Psi, omega, tau0, c0, beta, read from the module's parameter
    dict: an ``nn.Module`` attribute lookup costs ~2 us of host time."""
    d = params._parameters
    return d["F"], d["Psi"], d["omega"], d["tau0"], d["c0"], d["beta"]


def _check_batch(F: Tensor, psi: Tensor, omega: Tensor,
                 batch: SpectraBatch) -> None:
    npix, nh = F.shape
    nb = omega.shape[0]
    b = batch.delta.shape[0]
    if psi.shape != (npix,) or not 0 <= nb <= npix:
        raise ValueError(f"Psi {tuple(psi.shape)} / omega ({nb},) do "
                         f"not fit F ({npix}, {nh})")
    plane = (b, npix)
    for name in ("delta", "error", "mask"):
        t = getattr(batch, name)
        if t.shape != plane:
            raise ValueError(f"batch.{name} {tuple(t.shape)} must be "
                             f"(B={b}, Npix={npix})")
    zs = batch.zabs.shape
    if len(zs) != 2 or zs[0] != b or zs[1] < nb:
        raise ValueError(f"batch.zabs {tuple(zs)} must be "
                         f"(B={b}, >= Nb={nb})")
    if batch.weight.shape != (b,):
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
    _check_batch(params.F, params.Psi, params.omega, batch)
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
    return FusedStepOutputs(nll.sum(), StepGrads(**grads),
                            GradCounts(m.sum(dim=0), scalar))


def _raise_bad_tensor(tensors: dict, dev) -> None:
    """The error of the first tensor the kernels do not take."""
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device} but delta on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _scratch(lib, key: tuple, shapes: tuple, dev) -> tuple:
    """The ``_SCRATCH`` entry of this (device, stream) for these shapes:
    made at the first call, the counters zeroed, then reused (stream order
    keeps calls on one stream apart; the kernels leave the counters at
    zero)."""
    got = _SCRATCH.get(key)
    if got is None or got[0] != shapes:
        b, npix, nb, nh = shapes
        n_scratch = lib.qfa_step_scratch_len(b, npix, nh)
        n_counters = lib.qfa_step_n_counters(b)
        scratch = torch.empty((n_scratch,), dtype=torch.float32, device=dev)
        counters = torch.zeros((n_counters,), dtype=torch.int32, device=dev)
        got = _SCRATCH[key] = (shapes, scratch, counters, (
            scratch.data_ptr(), n_scratch, counters.data_ptr(), n_counters),
            [])
    return got


def _launch(params: QFAParams, batch: SpectraBatch, law) -> FusedStepOutputs:
    lib = _build.load_library()
    delta, error, zabs, mask, weight = batch
    F, psi, omega, tau0, c0, beta = _param_tensors(params)
    _check_batch(F, psi, omega, batch)
    tensors = (delta, error, zabs, mask, weight, F, psi, omega, tau0, c0,
               beta)
    dev = delta.device
    on = delta.get_device()
    f32 = torch.float32
    for t in tensors:
        if t.dtype is not f32 or not t.is_contiguous() or \
                t.get_device() != on:
            _raise_bad_tensor(
                dict(zip((*SpectraBatch._fields, *PARAM_NAMES), tensors)),
                dev)
    npix, nh = F.shape
    nb = omega.shape[0]
    b = delta.shape[0]
    if not 1 <= nh <= MAX_NH:
        raise ValueError(f"the CUDA step kernel supports 1 <= nh <= "
                         f"{MAX_NH}; got nh={nh}")
    index, stream = _build.device_and_stream(dev)
    _, _, _, scratch, spare = _scratch(lib, (index, stream),
                                       (b, npix, nb, nh), dev)
    n_out = npix * nh + 2 * npix + nb + 5
    # the outputs: a fresh buffer, allocated while the previous call's
    # kernels ran (list.pop is atomic, so no two calls get one buffer)
    res = spare.pop() if spare else torch.empty((n_out,), dtype=f32,
                                                device=dev)
    # the C entry leaves the thread's current device as it was
    rc = lib.qfa_step_f32(
        delta.data_ptr(), error.data_ptr(), zabs.data_ptr(), zabs.shape[1],
        mask.data_ptr(), weight.data_ptr(), F.data_ptr(), psi.data_ptr(),
        omega.data_ptr(), tau0.data_ptr(), c0.data_ptr(), beta.data_ptr(),
        *law, b, npix, nb, nh, *scratch, res.data_ptr(), int(EARLY_LAUNCH),
        index, stream)
    if rc != 0:
        raise RuntimeError(
            f"CUDA step kernel launch failed: error {rc} "
            f"({lib.qfa_cuda_error_string(rc).decode()})")
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    # the next call's outputs, while these kernels run
    spare.append(torch.empty((n_out,), dtype=f32, device=dev))
    g_f, g_psi, counts, g_omega, out = res.split_with_sizes(
        (npix * nh, npix, npix, nb, 5))
    loss, scalar, g_tau0, g_c0, g_beta = out.unbind()
    return FusedStepOutputs(
        loss, StepGrads(g_f.view(npix, nh), g_psi, g_omega, g_tau0, g_c0,
                        g_beta),
        GradCounts(counts, scalar))


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
    CUDA kernels, or raise (float32, contiguous, all on one device,
    1 <= nh <= 10). No autograd graph is built on either branch.
    """
    dev = batch.delta.device
    if dev.type == "cpu":
        return fused_loss_grads_plain(params, batch, tau_which, tile_batch)
    if dev.type != "cuda":
        raise ValueError(
            f"fused_loss_grads runs on cpu or cuda, not {dev}")
    return _launch(params, batch, tau_law_abc(tau_which))
