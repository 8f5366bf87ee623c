"""Whole-epoch training: every batch's forward NLL, analytic backward, count
normalization, Adam update and clip, for one or several epochs in one call.

:func:`fused_train_epoch` runs

* on CUDA tensors, the hand-written CUDA kernel ``csrc/epoch.cu`` (the port
  of ``qfa_tpu.ops.epoch_kernel._epoch_kernel``), built at first use by
  :mod:`._build`; a launch that fails raises;
* on CPU tensors, :func:`fused_train_epoch_plain`, the same function in
  plain torch ops: the reference the kernel is held against on the card.

Both take the JAX wrapper's arguments: the resident dataset, a tile
permutation per epoch (``tile_perm``; batch ``i`` of epoch ``e`` is the
``tpb`` tiles ``tile_perm[e, i*tpb:(i+1)*tpb]`` of ``tile_batch`` rows),
the first epoch's Adam counter, and the optimizer's hyper-parameters.
Within a batch every row sees the same parameters; the update runs at the
batch's end. The learning rate and bias corrections of each epoch of the
call come from :func:`qfa_tpu_torch.train.adam.schedule_f32` (float32,
counter ``epoch + k``).

Layouts: an explicit mask plane or a mask derived as ``error > 0``; a zabs
plane (width Nb, Npix or round_up(Npix, 128)) or, with ``derive_zabs``,
the (N, 2) :func:`~qfa_tpu_torch.ops.common.zq_column` plus the ``loglam``
row. ``n_real`` counts the zq column's weights in the derived layout and
rows with an observed pixel in the plane layout (padding rows are inert
in both). ``mxu_bf16`` rounds the operands of the six heavy products (the
K triangle, W, the two per-pixel cotangents and the two gradient
accumulations) to bfloat16 and accumulates in float32; sums of the loss
books, the counts and the Cholesky chain stay float32. The delta and error
planes may be stored in bfloat16 (``TRAIN.BF16_PLANES``, half their
bytes): both versions convert them to float32 at load, as the JAX kernel
does.

Not ported: ``sync_grads``/``pending`` (the exact-DP windows, ROADMAP A10)
raise, and the TPU census switch ``ablate`` does not exist. ``bwd_wide``
is accepted: on the TPU it fused the two backward cotangent products into
one block-diagonal product with bitwise-identical results, so by its own
definition it gives the results of ``False``, and here it is ignored.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..linalg import smallchol
from ..linalg.lowrank import LOG_2PI
from ..models.params import ParamBounds, QFAParams
from .common import ZQ_WIDTH, tau_law_abc, tri_idx, tri_pairs

Tensor = torch.Tensor

__all__ = [
    "EpochOutputs",
    "LAUNCHES",
    "MAX_NH",
    "fused_train_epoch",
    "fused_train_epoch_plain",
]

#: Calls that launched the CUDA epoch kernel in this process. Incremented
#: where the wrapper launches the kernel, and nowhere else.
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()

#: Whether the CUDA kernel launches each of its kernels early, before the
#: one ahead of it ends (programmatic dependent launch; results are the
#: same bit for bit). False makes each kernel's device time its own, for
#: timing them one by one.
EARLY_LAUNCH = True

#: the CUDA kernel is instantiated for 1 <= nh <= 10
MAX_NH = 10

#: batch rows per backward chunk of the CUDA kernel (``kChunk`` in
#: epoch.cu)
_CHUNK_ROWS = 32

_A10 = ("sync_grads/pending (exact data-parallel windows) are not ported "
        "yet: they wait for parallel/ on torch.distributed (ROADMAP A10)")


class EpochOutputs(NamedTuple):
    params: QFAParams  #: parameters after the call's last batch.
    m: QFAParams  #: first Adam moments.
    v: QFAParams  #: second Adam moments.
    #: (n_batches,) summed NLL per batch, (n_epochs, n_batches) when the
    #: call runs several epochs.
    loss_sums: Tensor
    #: real rows per batch (same shape as ``loss_sums``).
    n_real: Tensor


class _Geometry(NamedTuple):
    n: int
    npix: int
    nb: int
    nh: int
    tb: int
    tpb: int
    n_tiles: int
    perm: Tensor  #: flat int64 permutation on the CPU


def _check_args(params, m, v, delta, error, zabs, tile_perm, mask, loglam,
                derive_zabs, n_batches, n_epochs, tile_batch, sync_grads,
                pending, apply_pending) -> _Geometry:
    if sync_grads or pending is not None or apply_pending is not None:
        raise NotImplementedError(_A10)
    npix, nh = params.F.shape
    nb = params.omega.shape[0]
    for name, st in (("m", m), ("v", v)):
        for k in ("F", "Psi", "omega", "tau0", "c0", "beta"):
            if getattr(st, k).shape != getattr(params, k).shape:
                raise ValueError(
                    f"{name}.{k} has shape {tuple(getattr(st, k).shape)}, "
                    f"params.{k} {tuple(getattr(params, k).shape)}")
    if params.Psi.shape != (npix,) or not 0 <= nb <= npix:
        raise ValueError(f"Psi {tuple(params.Psi.shape)} / omega ({nb},) do "
                         f"not fit F ({npix}, {nh})")
    n = delta.shape[0]
    if delta.ndim != 2 or delta.shape[1] != npix or error.shape != delta.shape:
        raise ValueError(
            f"delta {tuple(delta.shape)} and error {tuple(error.shape)} must "
            f"both be (N, Npix={npix})")
    if mask is not None and mask.shape != delta.shape:
        raise ValueError(
            f"mask {tuple(mask.shape)} must match delta {tuple(delta.shape)}")
    if derive_zabs:
        if loglam is None:
            raise ValueError("derive_zabs=True requires the loglam row")
        if zabs.ndim != 2 or zabs.shape != (n, ZQ_WIDTH):
            raise ValueError(
                f"derive_zabs=True expects the (N={n}, {ZQ_WIDTH}) zq_column "
                f"buffer, got {tuple(zabs.shape)}")
        if loglam.shape != (npix,):
            raise ValueError(
                f"loglam {tuple(loglam.shape)} must be (Npix={npix},)")
    else:
        p = -(-npix // 128) * 128
        if zabs.ndim != 2 or zabs.shape[0] != n or \
                zabs.shape[1] not in (nb, npix, p):
            raise ValueError(
                f"zabs plane {tuple(zabs.shape)} matches neither (N, Nb={nb})"
                f" nor (N, Npix={npix}); if this is a zq_column buffer, pass "
                "derive_zabs=True (and loglam)")
    tb = int(tile_batch)
    if tb < 1 or n % tb:
        raise ValueError(f"dataset rows {n} not divisible by tile {tb}")
    n_tiles = n // tb
    if n_epochs < 1:
        raise ValueError(f"n_epochs must be >= 1, got {n_epochs}")
    if n_batches < 1 or n_tiles % n_batches:
        raise ValueError(f"{n_tiles} tiles not divisible by {n_batches} "
                         "batches")
    perm = torch.as_tensor(tile_perm).reshape(-1).to("cpu", torch.int64)
    if perm.numel() != n_epochs * n_tiles:
        raise ValueError(
            f"tile_perm has {perm.numel()} entries; expected "
            f"n_epochs*n_tiles = {n_epochs}*{n_tiles}")
    if perm.numel() and (int(perm.min()) < 0 or int(perm.max()) >= n_tiles):
        raise ValueError(f"tile_perm values must lie in [0, {n_tiles})")
    return _Geometry(n=n, npix=npix, nb=nb, nh=nh, tb=tb,
                     tpb=n_tiles // n_batches, n_tiles=n_tiles, perm=perm)


def _schedule_rows(epoch, n_epochs, learning_rate, decay_alpha, decay_step,
                   b1, b2) -> np.ndarray:
    """(n_epochs, 3) float32 rows ``[lr, bc1, bc2]`` for counters
    ``epoch + k``."""
    from ..train.adam import schedule_f32

    return np.array([
        schedule_f32(int(epoch) + k, learning_rate=learning_rate,
                     decay_alpha=decay_alpha, decay_step=decay_step,
                     b1=b1, b2=b2)
        for k in range(n_epochs)
    ], np.float32)


def _f32(x) -> float:
    """A hyper-parameter rounded to float32, as the kernel holds it."""
    return float(np.float32(x))


def _shape_outputs(losses, reals, n_epochs, n_batches):
    if n_epochs > 1:
        return losses.reshape(n_epochs, n_batches), \
            reals.reshape(n_epochs, n_batches)
    return losses.reshape(n_batches), reals.reshape(n_batches)


@torch.no_grad()
def fused_train_epoch_plain(
    params: QFAParams,
    m: QFAParams,
    v: QFAParams,
    delta: Tensor,
    error: Tensor,
    zabs: Tensor,
    tile_perm,
    mask: Tensor | None = None,
    *,
    epoch,
    n_batches: int,
    n_epochs: int = 1,
    loglam: Tensor | None = None,
    derive_zabs: bool = False,
    tile_batch: int = 256,
    learning_rate: float = 1e-3,
    weight_decay: float = 0.1,
    decay_alpha: float = 0.9,
    decay_step: int = 10,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    bounds: ParamBounds = ParamBounds(),
    tau_which: str = "becker",
    reference_norm: bool = True,
    mxu_bf16: bool = False,
    bwd_wide: bool = False,
    sync_grads: bool = False,
    pending=None,
    apply_pending=None,
) -> EpochOutputs:
    """:func:`fused_train_epoch` in plain torch ops, on any device.

    The kernel's arithmetic on batched tensors: the analytic forward and
    backward of each batch as matrix products against the lower-triangle
    Gram rows ``F_a F_b``, with the same operand rounding under
    ``mxu_bf16`` (``.to(bfloat16).float()`` before a float32 product),
    then the count normalization, Adam with the hyper-parameters rounded
    to float32, and the clip. Takes float32 or bfloat16 planes.
    """
    del bwd_wide  # one backward form; see the module docstring
    geo = _check_args(params, m, v, delta, error, zabs, tile_perm, mask,
                      loglam, derive_zabs, n_batches, n_epochs, tile_batch,
                      sync_grads, pending, apply_pending)
    law_a, law_b, law_c = (_f32(x) for x in tau_law_abc(tau_which))
    sched = _schedule_rows(epoch, n_epochs, learning_rate, decay_alpha,
                           decay_step, b1, b2)
    dev = delta.device
    f32 = torch.float32
    npix, nb, nh = geo.npix, geo.nb, geo.nh
    wd, b1f, b2f, epsf = _f32(weight_decay), _f32(b1), _f32(b2), _f32(eps)
    omb1 = float(np.float32(1.0) - np.float32(b1))
    omb2 = float(np.float32(1.0) - np.float32(b2))
    vmin, vmax = _f32(bounds.var_min), _f32(bounds.var_max)
    lims = ((_f32(bounds.tau0_min), _f32(bounds.tau0_max)),
            (_f32(bounds.c0_min), _f32(bounds.c0_max)),
            (_f32(bounds.beta_min), _f32(bounds.beta_max)))

    def st(t):
        return t.detach().to(dev, f32).clone()

    F, psi, omega = st(params.F), st(params.Psi), st(params.omega)
    mF, vF = st(m.F), st(v.F)
    mpsi, vpsi, momega, vomega = st(m.Psi), st(v.Psi), st(m.omega), st(v.omega)
    scal = [st(params.tau0), st(params.c0), st(params.beta)]
    mscal = [st(m.tau0), st(m.c0), st(m.beta)]
    vscal = [st(v.tau0), st(v.c0), st(v.beta)]

    def op(x):
        # mxu_bf16: bfloat16 operands, float32 products and sums
        return x.to(torch.bfloat16).to(f32) if mxu_bf16 else x

    pairs = tri_pairs(nh)
    ntri = len(pairs)
    ia = torch.tensor([a for a, _ in pairs], device=dev)
    ib = torch.tensor([b for _, b in pairs], device=dev)
    full = torch.tensor([[tri_idx(a, b) for b in range(nh)]
                         for a in range(nh)], device=dev)
    half = torch.tensor([0.5 if a == b else 1.0 for a, b in pairs],
                        device=dev)
    eye = torch.eye(nh, dtype=f32, device=dev)
    perm = geo.perm.to(dev)
    offs = torch.arange(geo.tb, device=dev)
    loglam_b = None if loglam is None else loglam[:nb].to(dev, f32)
    losses = torch.zeros((n_epochs * n_batches,), dtype=f32, device=dev)
    reals = torch.zeros_like(losses)

    def adam(p, g, mo, ve, lr, bc1, bc2):
        g = g + wd * p
        mn = omb1 * g + b1f * mo
        vn = omb2 * g * g + b2f * ve
        return p - lr * (mn / bc1) / (torch.sqrt(vn / bc2) + epsf), mn, vn

    for e in range(n_epochs):
        lr, bc1, bc2 = (float(x) for x in sched[e])
        for i in range(n_batches):
            base = e * geo.n_tiles + i * geo.tpb
            rows = (perm[base:base + geo.tpb, None] * geo.tb
                    + offs[None, :]).reshape(-1)
            tau0, c0, beta = scal
            err = error[rows].to(f32)
            dlt = delta[rows].to(f32)
            msk = (err > 0.0).to(f32) if mask is None else mask[rows].to(f32)
            z = zabs[rows].to(f32)
            # blue-side absorption chain (B, Nb)
            if derive_zabs:
                log_zp1 = z[:, :1] + loglam_b
                tau_line = law_a * torch.exp(law_b * log_zp1) + law_c
                zp1b = torch.exp(beta * log_zp1)
            else:
                zp1 = 1.0 + z[:, :nb]
                tau_line = law_a * zp1**law_b + law_c
                zp1b = zp1**beta
                log_zp1 = torch.log(zp1)
            amp = torch.exp(-tau_line)
            exp_neg = torch.exp(-(tau0 * zp1b))
            root = 1.0 - c0 - exp_neg
            zdep = root * root
            # masked noise diagonal and the per-pixel weights (B, Npix)
            delta_m = dlt * msk
            eb, er = err[:, :nb], err[:, nb:]
            d = torch.cat([amp * amp * psi[:nb] + omega * zdep + eb * eb,
                           psi[nb:] + er * er], dim=1)
            d_safe = torch.where(msk > 0, d, 1.0)
            dinv = msk / d_safe
            w = torch.cat([amp * amp * dinv[:, :nb], dinv[:, nb:]], dim=1)
            u = torch.cat([amp * dinv[:, :nb] * delta_m[:, :nb],
                           dinv[:, nb:] * delta_m[:, nb:]], dim=1)
            q = delta_m * delta_m * dinv
            ql = q + msk * torch.log(d_safe)
            # forward: K triangle, W, factorization, NLL
            gram = F[:, ia] * F[:, ib]  # (Npix, ntri)
            k_tri = op(w) @ op(gram)
            wv = op(u) @ op(F)
            n_obs = msk.sum(dim=1)
            n_blue = msk[:, :nb].sum(dim=1)
            chol = smallchol.cholesky_small(k_tri[:, full] + eye)
            y = smallchol.solve_lower_small(chol, wv)
            alpha = smallchol.solve_upper_small(chol, y)
            nll = 0.5 * (ql.sum(dim=1) - (y * y).sum(dim=1) + n_obs * LOG_2PI
                         + smallchol.logdet_from_chol(chol))
            # backward: S = 1/2 (K^-1 + alpha alpha^T), off-diagonal doubled
            kinv = smallchol.inverse_from_chol(chol)
            s_tri = half * (kinv[:, ia, ib] + alpha[:, ia] * alpha[:, ib])
            s_op, na_op = op(s_tri), op(-alpha)
            dw_pix = s_op @ op(gram).T
            du_pix = na_op @ op(F).T
            dg_rows = s_op.T @ op(w)  # (ntri, Npix)
            du_rows = na_op.T @ op(u)  # (nh, Npix)
            dd = (-(dw_pix * w + du_pix * u + 0.5 * q) + 0.5 * msk) * dinv
            dd_b = dd[:, :nb]
            droot2 = dd_b * omega * 2.0 * root
            dtz = droot2 * exp_neg * zp1b
            g_psi = torch.cat([dd_b * amp * amp, dd[:, nb:]], dim=1).sum(dim=0)
            g_omega = (dd_b * zdep).sum(dim=0)
            cnt = msk.sum(dim=0)
            # scalar rows per pixel, then summed over the pixels
            g_scal = [dtz.sum(dim=0).sum(), -droot2.sum(dim=0).sum(),
                      (tau0 * (dtz * log_zp1).sum(dim=0)).sum()]
            # loss books of the batch (before its update)
            n_real = z[:, 1].sum() if derive_zabs else \
                (n_obs > 0.5).to(f32).sum()
            scal_cnt = (n_blue > 0.5).to(f32).sum()
            losses[e * n_batches + i] = nll.sum()
            reals[e * n_batches + i] = n_real
            # end of batch: normalization, Adam, clip
            n_real_c = torch.clamp(n_real, min=1.0)
            if reference_norm:
                denom = torch.clamp(cnt, min=1.0)
                zero = (cnt > 0).to(f32)
                denom_b, zero_b = denom[:nb], zero[:nb]
            else:
                denom = denom_b = n_real_c
                zero = zero_b = 1.0
            p_new, mpsi, vpsi = adam(psi, g_psi / denom * zero, mpsi, vpsi,
                                     lr, bc1, bc2)
            o_new, momega, vomega = adam(omega, g_omega / denom_b * zero_b,
                                         momega, vomega, lr, bc1, bc2)
            new_f = torch.empty_like(F)
            for a in range(nh):
                df = du_rows[a]
                for b in range(nh):
                    dg = dg_rows[tri_idx(a, b)]
                    if a == b:
                        dg = dg + dg
                    df = df + dg * F[:, b]
                new_f[:, a], mF[:, a], vF[:, a] = adam(
                    F[:, a], df / denom * zero, mF[:, a], vF[:, a],
                    lr, bc1, bc2)
            sdenom = torch.clamp(scal_cnt, min=1.0) if reference_norm \
                else n_real_c
            for k in range(3):
                s_new, mscal[k], vscal[k] = adam(
                    scal[k], g_scal[k] / sdenom, mscal[k], vscal[k],
                    lr, bc1, bc2)
                scal[k] = torch.clamp(s_new, *lims[k])
            F = new_f
            psi = torch.clamp(p_new, vmin, vmax)
            omega = torch.clamp(o_new, vmin, vmax)

    loss_sums, n_real_out = _shape_outputs(losses, reals, n_epochs,
                                           n_batches)
    return EpochOutputs(
        params=QFAParams(F, psi, omega, *scal),
        m=QFAParams(mF, mpsi, momega, *mscal).requires_grad_(False),
        v=QFAParams(vF, vpsi, vomega, *vscal).requires_grad_(False),
        loss_sums=loss_sums,
        n_real=n_real_out,
    )


def _check_kernel_tensors(tensors: dict, dev) -> bool:
    """Raise on what the CUDA kernel does not take: every tensor on
    ``dev``, contiguous and float32, except the delta and error planes,
    which may both be bfloat16. Returns whether they are."""
    planes = {tensors["delta"].dtype, tensors["error"].dtype}
    if len(planes) > 1:
        raise TypeError(f"delta ({tensors['delta'].dtype}) and error "
                        f"({tensors['error'].dtype}) must share a dtype")
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device} but delta on {dev}")
        ok = (torch.float32, torch.bfloat16) if name in ("delta", "error") \
            else (torch.float32,)
        if t.dtype not in ok:
            raise TypeError(f"{name} must be "
                            f"{' or '.join(str(d) for d in ok)}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return planes == {torch.bfloat16}


def _launch(params, m, v, delta, error, zabs, mask, loglam, geo, *, epoch,
            n_batches, n_epochs, derive_zabs, learning_rate, weight_decay,
            decay_alpha, decay_step, b1, b2, eps, bounds, law,
            reference_norm, mxu_bf16) -> EpochOutputs:
    from ._build import device_and_stream, load_library

    dev = delta.device
    if geo.nh < 1 or geo.nh > MAX_NH:
        raise ValueError(f"the CUDA epoch kernel supports 1 <= nh <= "
                         f"{MAX_NH}; got nh={geo.nh}")
    tensors = {
        "delta": delta, "error": error, "zabs": zabs, "mask": mask,
        "loglam": loglam if derive_zabs else None,
    }
    for k in ("F", "Psi", "omega", "tau0", "c0", "beta"):
        tensors[k] = getattr(params, k)
        tensors[f"m.{k}"] = getattr(m, k)
        tensors[f"v.{k}"] = getattr(v, k)
    planes_bf16 = _check_kernel_tensors(tensors, dev)
    npix, nb, nh = geo.npix, geo.nb, geo.nh
    ntri = nh * (nh + 1) // 2
    rows = geo.tpb * geo.tb  # batch rows
    n_chunks = -(-rows // _CHUNK_ROWS)
    f32 = dict(dtype=torch.float32, device=dev)
    lib = load_library()
    n_fpart = int(lib.qfa_train_epoch_fpart_len(npix, rows, nh))
    n_counters = int(lib.qfa_train_epoch_n_counters(npix, rows))

    def own(t):  # the kernel updates its own copy of the state in place
        return t.detach().clone().contiguous()

    F, psi, omega = own(params.F), own(params.Psi), own(params.omega)
    mF, vF = own(m.F), own(v.F)
    mpsi, vpsi, momega, vomega = own(m.Psi), own(v.Psi), own(m.omega), \
        own(v.omega)
    # the scalar state in row 0; the kernel alternates rows between batches
    scal = torch.stack([params.tau0, params.c0, params.beta, m.tau0, m.c0,
                        m.beta, v.tau0, v.c0, v.beta]).detach().to(**f32)
    scal = torch.stack([scal, torch.zeros_like(scal)])
    sizes = [rows * ntri, rows * nh, rows * 3, n_fpart,
             n_chunks * (ntri + nh + 6) * npix]
    s_buf, alpha_buf, rowstat, fpart, partials = torch.split(
        torch.empty((sum(sizes),), **f32), sizes)
    # the update blocks' scalar sums and the batch's books (zero padding)
    spart = torch.zeros((3 * npix + 16,), **f32)
    # the kernel's arrival counters: zero at every launch's start and end
    counters = torch.zeros((n_counters,), dtype=torch.int32, device=dev)
    losses = torch.empty((n_epochs * n_batches,), **f32)
    reals = torch.empty_like(losses)
    perm = geo.perm.to(dev, torch.int32)
    hp = np.array([
        *law, eps, weight_decay, b1, b2, bounds.var_min, bounds.var_max,
        bounds.tau0_min, bounds.tau0_max, bounds.beta_min, bounds.beta_max,
        bounds.c0_min, bounds.c0_max, 1.0 if reference_norm else 0.0,
    ], np.float32)
    sched = np.ascontiguousarray(_schedule_rows(
        epoch, n_epochs, learning_rate, decay_alpha, decay_step, b1, b2))

    def ptr(t):
        return None if t is None else t.data_ptr()

    index, stream = device_and_stream(dev)
    rc = lib.qfa_train_epoch(
        ptr(delta), ptr(error), int(planes_bf16), ptr(zabs), zabs.shape[1],
        ptr(mask), ptr(tensors["loglam"]), ptr(perm),
        geo.n_tiles, geo.tb, geo.tpb, n_batches, n_epochs,
        npix, nb, nh, int(mask is None), int(derive_zabs), int(mxu_bf16),
        ptr(F), ptr(psi), ptr(omega), ptr(mF), ptr(vF), ptr(mpsi),
        ptr(vpsi), ptr(momega), ptr(vomega), ptr(scal),
        hp.ctypes.data, sched.ctypes.data,
        ptr(s_buf), ptr(alpha_buf), ptr(rowstat), ptr(fpart), n_fpart,
        ptr(partials), ptr(spart), ptr(counters), n_counters, ptr(losses),
        ptr(reals),
        n_chunks, int(EARLY_LAUNCH), index, stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"CUDA epoch kernel launch failed: error {rc} "
            f"({lib.qfa_cuda_error_string(rc).decode()})")
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    loss_sums, n_real = _shape_outputs(losses, reals, n_epochs, n_batches)
    scal = scal[(n_epochs * n_batches - 1) % 2]
    return EpochOutputs(
        params=QFAParams(F, psi, omega, scal[0], scal[1], scal[2]),
        m=QFAParams(mF, mpsi, momega, scal[3], scal[4],
                    scal[5]).requires_grad_(False),
        v=QFAParams(vF, vpsi, vomega, scal[6], scal[7],
                    scal[8]).requires_grad_(False),
        loss_sums=loss_sums,
        n_real=n_real,
    )


@torch.no_grad()
def fused_train_epoch(
    params: QFAParams,
    m: QFAParams,
    v: QFAParams,
    delta: Tensor,
    error: Tensor,
    zabs: Tensor,
    tile_perm,
    mask: Tensor | None = None,
    *,
    epoch,
    n_batches: int,
    n_epochs: int = 1,
    loglam: Tensor | None = None,
    derive_zabs: bool = False,
    tile_batch: int = 256,
    learning_rate: float = 1e-3,
    weight_decay: float = 0.1,
    decay_alpha: float = 0.9,
    decay_step: int = 10,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    bounds: ParamBounds = ParamBounds(),
    tau_which: str = "becker",
    reference_norm: bool = True,
    mxu_bf16: bool = False,
    bwd_wide: bool = False,
    sync_grads: bool = False,
    pending=None,
    apply_pending=None,
) -> EpochOutputs:
    """Run ``n_epochs`` full training epochs in one call.

    Args:
        params, m, v: parameters and Adam moments (left unchanged; the
            updated ones are returned).
        delta/error/zabs/mask: the resident dataset, (N, ...) with N a
            multiple of ``tile_batch``; see the module docstring for the
            layouts.
        tile_perm: ``n_epochs * N // tile_batch`` tile indices (flat, or
            one row per epoch): the epoch shuffle.
        epoch: the Adam counter of the call's first epoch (epoch ``k`` of
            the call uses ``epoch + k``).
        n_batches: optimizer updates per epoch; a batch is
            ``N // n_batches`` rows.

    Returns :class:`EpochOutputs`; ``loss_sums`` and ``n_real`` are
    ``(n_batches,)`` for one epoch and ``(n_epochs, n_batches)`` for
    several. Tensors on the CPU run :func:`fused_train_epoch_plain`;
    tensors on a CUDA device launch the CUDA kernel, or raise (float32,
    the delta and error planes float32 or both bfloat16, contiguous, all
    on one device, 1 <= nh <= 10).
    """
    kw = dict(
        epoch=epoch, n_batches=n_batches, n_epochs=n_epochs, loglam=loglam,
        derive_zabs=derive_zabs, tile_batch=tile_batch,
        learning_rate=learning_rate, weight_decay=weight_decay,
        decay_alpha=decay_alpha, decay_step=decay_step, b1=b1, b2=b2,
        eps=eps, bounds=bounds, tau_which=tau_which,
        reference_norm=reference_norm, mxu_bf16=mxu_bf16,
    )
    if delta.device.type == "cpu":
        return fused_train_epoch_plain(
            params, m, v, delta, error, zabs, tile_perm, mask,
            bwd_wide=bwd_wide, sync_grads=sync_grads, pending=pending,
            apply_pending=apply_pending, **kw)
    if delta.device.type != "cuda":
        raise ValueError(
            f"fused_train_epoch runs on cpu or cuda, not {delta.device}")
    geo = _check_args(params, m, v, delta, error, zabs, tile_perm, mask,
                      loglam, derive_zabs, n_batches, n_epochs, tile_batch,
                      sync_grads, pending, apply_pending)
    kw.pop("loglam")
    kw.pop("tile_batch")
    law = tau_law_abc(kw.pop("tau_which"))
    return _launch(params, m, v, delta, error, zabs, mask, loglam, geo,
                   law=law, **kw)
