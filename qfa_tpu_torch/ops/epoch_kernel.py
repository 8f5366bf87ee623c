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

Window mode (``sync_grads``, the exact data-parallel windows of
``parallel.sync_dp``): a call runs the ``n_batches`` batches that
``tile_perm`` names (``tiles_per_batch`` tiles each, absolute tile
indices) of one epoch. With ``apply_pending > 0`` it first applies
``pending``, a window's exported buffer summed across ranks, through the
same update a batch ends with; its last batch exports its own buffer
(:class:`SyncEpochOutputs` ``.pending``) instead of updating. A call
with no batch only applies (an epoch's flush). The buffer is one flat
float32 vector of :func:`pending_len` floats, the port's own layout: what
the update consumes after its chunk sum, so that one ``all_reduce`` sums
it. At one rank a window gives the plain epoch's results.
:class:`WindowCalls` keeps one epoch's calls set up across epochs; its
launches read the learning rate and bias corrections from a device row
that :meth:`WindowCalls.set_epoch` rewrites, so one CUDA graph of an
epoch's windows (``parallel.sync_dp``) serves every epoch.

Not ported: the TPU census switch ``ablate``. ``bwd_wide`` is accepted:
on the TPU it fused the two backward cotangent products into one
block-diagonal product with bitwise-identical results, so by its own
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
    "SyncEpochOutputs",
    "WINDOW_LAUNCHES",
    "WindowCalls",
    "fused_train_epoch",
    "fused_train_epoch_plain",
    "pending_len",
]

#: Calls that launched the CUDA epoch kernel in this process. Incremented
#: where the wrapper launches the kernel, and nowhere else.
LAUNCHES = 0
#: ... of them in window mode (``sync_grads``), counted beside LAUNCHES.
WINDOW_LAUNCHES = 0
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
#: pixels per update block of the CUDA kernel (``kUpdPix``), and the books
#: of a pending buffer (``kBooks``): summed NLL, has-blue rows, n_real, 0
_UPD_PIX = 16
_BOOKS = 4
#: accumulator rows after the NT + NH Gram/F rows: dPsi, domega, counts,
#: dtau0, dc0, dbeta (``A_EXTRA`` in epoch.cu)
_A_PSI, _A_OMEGA, _A_CNT, _A_T0, _A_C0, _A_BETA = range(6)
_A_EXTRA = 6


class EpochOutputs(NamedTuple):
    params: QFAParams  #: parameters after the call's last batch.
    m: QFAParams  #: first Adam moments.
    v: QFAParams  #: second Adam moments.
    #: (n_batches,) summed NLL per batch, (n_epochs, n_batches) when the
    #: call runs several epochs.
    loss_sums: Tensor
    #: real rows per batch (same shape as ``loss_sums``).
    n_real: Tensor


class SyncEpochOutputs(NamedTuple):
    """Outputs of a ``sync_grads`` window call (``parallel.sync_dp``)."""

    #: after the applied pending and the window's local updates (none with
    #: one batch, the exact-DP cadence)
    params: QFAParams
    m: QFAParams
    v: QFAParams
    loss_sums: Tensor  #: (n_batches,) summed NLL per batch of the window.
    n_real: Tensor  #: real rows per batch.
    #: (pending_len,) the last batch's buffer for the cross-rank sum; None
    #: from a call with no batch
    pending: Tensor | None


def _n_upd_pad(npix: int) -> int:
    return -(-(-(-npix // _UPD_PIX)) // 4) * 4


def pending_len(npix: int, nh: int) -> int:
    """Floats of a window's pending buffer: the update blocks' dtau0, dc0
    and dbeta sums (3 rows of ``ceil(ceil(npix / 16) / 4) * 4``, zero past
    the blocks), the books (summed NLL, has-blue rows, n_real, 0), then
    ``ntri + nh + 6`` rows of ``npix`` batch sums (the dG triangle with the
    off-diagonal doubled, dF, dPsi, domega, counts, dtau0, dc0, dbeta), as
    ``qfa_train_epoch_pending_len`` in epoch.cu."""
    nr = nh * (nh + 1) // 2 + nh + _A_EXTRA
    return 3 * _n_upd_pad(npix) + _BOOKS + nr * npix


class _Geometry(NamedTuple):
    n: int
    npix: int
    nb: int
    nh: int
    tb: int
    tpb: int
    n_tiles: int
    perm: Tensor  #: flat int64 permutation on the CPU
    window: bool  #: sync_grads: the last batch exports its pending buffer
    apply: bool  #: sync_grads with apply_pending > 0: apply ``pending`` first


def _apply_flag(apply_pending) -> bool:
    """JAX's ``apply_pending > 0`` (a number or a 0-d tensor)."""
    return apply_pending is not None and float(apply_pending) > 0.0


def _check_args(params, m, v, delta, error, zabs, tile_perm, mask, loglam,
                derive_zabs, n_batches, n_epochs, tile_batch, sync_grads,
                pending, apply_pending, tiles_per_batch=None) -> _Geometry:
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
    apply = _apply_flag(apply_pending)
    if sync_grads:
        if n_epochs != 1:
            raise ValueError("sync_grads windows are single-epoch")
        if pending is not None and apply_pending is None:
            raise ValueError(
                "pending was given without apply_pending: pass "
                "apply_pending=1 to apply it (0 on an epoch's first window)")
        if apply and pending is None:
            raise ValueError("apply_pending > 0 needs the pending buffer")
    elif pending is not None or apply_pending is not None:
        raise ValueError("pending and apply_pending belong to the "
                         "sync_grads window mode")
    if tiles_per_batch is not None:
        tpb = int(tiles_per_batch)
        if tpb < 1:
            raise ValueError(f"tiles_per_batch must be >= 1, got {tpb}")
    else:
        if n_batches < 1 or n_tiles % n_batches:
            raise ValueError(f"{n_tiles} tiles not divisible by {n_batches} "
                             "batches")
        tpb = n_tiles // n_batches
    if n_batches < (0 if apply else 1):
        raise ValueError(
            f"n_batches must be >= 1 (0 only for a call that applies a "
            f"pending buffer), got {n_batches}")
    perm = torch.as_tensor(tile_perm).reshape(-1).to("cpu", torch.int64)
    if perm.numel() != n_epochs * n_batches * tpb:
        raise ValueError(
            f"tile_perm has {perm.numel()} entries; expected "
            f"n_epochs*n_batches*tiles_per_batch = "
            f"{n_epochs}*{n_batches}*{tpb}")
    if perm.numel() and (int(perm.min()) < 0 or int(perm.max()) >= n_tiles):
        raise ValueError(f"tile_perm values must lie in [0, {n_tiles})")
    if apply:
        want = pending_len(npix, nh)
        if pending.shape != (want,) or pending.dtype != torch.float32:
            raise ValueError(
                f"pending must be a ({want},) float32 buffer (pending_len), "
                f"got {tuple(pending.shape)} {pending.dtype}")
    return _Geometry(n=n, npix=npix, nb=nb, nh=nh, tb=tb, tpb=tpb,
                     n_tiles=n_tiles, perm=perm, window=bool(sync_grads),
                     apply=apply)


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
    tiles_per_batch: int | None = None,
    pending: Tensor | None = None,
    apply_pending=None,
) -> EpochOutputs | SyncEpochOutputs:
    """:func:`fused_train_epoch` in plain torch ops, on any device.

    The kernel's arithmetic on batched tensors: the analytic forward and
    backward of each batch as matrix products against the lower-triangle
    Gram rows ``F_a F_b``, with the same operand rounding under
    ``mxu_bf16`` (``.to(bfloat16).float()`` before a float32 product),
    gathered into the kernel's pending layout; then, from that buffer, the
    count normalization, Adam with the hyper-parameters rounded to
    float32, and the clip. Takes float32 or bfloat16 planes.
    """
    del bwd_wide  # one backward form; see the module docstring
    geo = _check_args(params, m, v, delta, error, zabs, tile_perm, mask,
                      loglam, derive_zabs, n_batches, n_epochs, tile_batch,
                      sync_grads, pending, apply_pending, tiles_per_batch)
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

    # the state the batches update: F, Psi, omega, their moments, and
    # [tau0, c0, beta] with their moments
    S = dict(F=st(params.F), psi=st(params.Psi), omega=st(params.omega),
             mF=st(m.F), vF=st(v.F), mpsi=st(m.Psi), vpsi=st(v.Psi),
             momega=st(m.omega), vomega=st(v.omega),
             scal=[st(params.tau0), st(params.c0), st(params.beta)],
             mscal=[st(m.tau0), st(m.c0), st(m.beta)],
             vscal=[st(v.tau0), st(v.c0), st(v.beta)])

    def op(x):
        # mxu_bf16: bfloat16 operands, float32 products and sums
        return x.to(torch.bfloat16).to(f32) if mxu_bf16 else x

    pairs = tri_pairs(nh)
    ntri = len(pairs)
    X = ntri + nh  # first accumulator row after the Gram and F rows
    n_up = _n_upd_pad(npix)
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

    def batch_pending(rows: Tensor) -> Tensor:
        """One batch's forward and backward, as the kernel's pending
        buffer: block sums of the scalar rows, books, accumulator rows."""
        F, psi, omega = S["F"], S["psi"], S["omega"]
        tau0, c0, beta = S["scal"]
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
        dd = (-(dw_pix * w + du_pix * u + 0.5 * q) + 0.5 * msk) * dinv
        dd_b = dd[:, :nb]
        droot2 = dd_b * omega * 2.0 * root
        dtz = droot2 * exp_neg * zp1b
        sums = torch.zeros((X + _A_EXTRA, npix), dtype=f32, device=dev)
        sums[:ntri] = s_op.T @ op(w)  # dG rows
        sums[ntri:X] = na_op.T @ op(u)  # dF rows
        sums[X + _A_PSI] = torch.cat([dd_b * amp * amp, dd[:, nb:]],
                                     dim=1).sum(dim=0)
        sums[X + _A_OMEGA, :nb] = (dd_b * zdep).sum(dim=0)
        sums[X + _A_CNT] = msk.sum(dim=0)
        sums[X + _A_T0, :nb] = dtz.sum(dim=0)
        sums[X + _A_C0, :nb] = droot2.sum(dim=0)
        sums[X + _A_BETA, :nb] = (dtz * log_zp1).sum(dim=0)
        # the update blocks' sums of the scalar rows (16 pixels each)
        srows = torch.zeros((3, n_up * _UPD_PIX), dtype=f32, device=dev)
        srows[0, :npix] = sums[X + _A_T0]
        srows[1, :npix] = -sums[X + _A_C0]
        srows[2, :npix] = tau0 * sums[X + _A_BETA]
        spart = srows.reshape(3, n_up, _UPD_PIX).sum(dim=2)
        # loss books of the batch (before its update)
        n_real = z[:, 1].sum() if derive_zabs else \
            (n_obs > 0.5).to(f32).sum()
        books = torch.stack([nll.sum(), (n_blue > 0.5).to(f32).sum(),
                             n_real, torch.zeros((), device=dev)])
        return torch.cat([spart.reshape(-1), books, sums.reshape(-1)])

    def adam(p, g, mo, ve, lr, bc1, bc2):
        g = g + wd * p
        mn = omb1 * g + b1f * mo
        vn = omb2 * g * g + b2f * ve
        return p - lr * (mn / bc1) / (torch.sqrt(vn / bc2) + epsf), mn, vn

    def update(pend: Tensor, lr: float, bc1: float, bc2: float) -> None:
        """A batch's update from its pending buffer: normalization, Adam,
        clip."""
        spart = pend[:3 * n_up].reshape(3, n_up)
        books = pend[3 * n_up:3 * n_up + _BOOKS]
        sums = pend[3 * n_up + _BOOKS:].reshape(X + _A_EXTRA, npix)
        F = S["F"]
        n_real_c = torch.clamp(books[2], min=1.0)
        cnt = sums[X + _A_CNT]
        if reference_norm:
            denom = torch.clamp(cnt, min=1.0)
            zero = (cnt > 0).to(f32)
            denom_b, zero_b = denom[:nb], zero[:nb]
        else:
            denom = denom_b = n_real_c
            zero = zero_b = 1.0
        p_new, S["mpsi"], S["vpsi"] = adam(
            S["psi"], sums[X + _A_PSI] / denom * zero, S["mpsi"], S["vpsi"],
            lr, bc1, bc2)
        o_new, S["momega"], S["vomega"] = adam(
            S["omega"], sums[X + _A_OMEGA, :nb] / denom_b * zero_b,
            S["momega"], S["vomega"], lr, bc1, bc2)
        new_f = torch.empty_like(F)
        mF, vF = S["mF"], S["vF"]
        for a in range(nh):
            df = sums[ntri + a]
            for b in range(nh):
                dg = sums[tri_idx(a, b)]
                if a == b:
                    dg = dg + dg
                df = df + dg * F[:, b]
            new_f[:, a], mF[:, a], vF[:, a] = adam(
                F[:, a], df / denom * zero, mF[:, a], vF[:, a], lr, bc1, bc2)
        sdenom = torch.clamp(books[1], min=1.0) if reference_norm \
            else n_real_c
        scal, mscal, vscal = S["scal"], S["mscal"], S["vscal"]
        for k in range(3):
            s_new, mscal[k], vscal[k] = adam(
                scal[k], spart[k].sum() / sdenom, mscal[k], vscal[k],
                lr, bc1, bc2)
            scal[k] = torch.clamp(s_new, *lims[k])
        S["F"] = new_f
        S["psi"] = torch.clamp(p_new, vmin, vmax)
        S["omega"] = torch.clamp(o_new, vmin, vmax)

    if geo.apply:
        update(pending.to(dev, f32), *(float(x) for x in sched[0]))
    exported = None
    for e in range(n_epochs):
        lr, bc1, bc2 = (float(x) for x in sched[e])
        for i in range(n_batches):
            base = (e * n_batches + i) * geo.tpb
            rows = (perm[base:base + geo.tpb, None] * geo.tb
                    + offs[None, :]).reshape(-1)
            pend = batch_pending(rows)
            losses[e * n_batches + i] = pend[3 * n_up]
            reals[e * n_batches + i] = pend[3 * n_up + 2]
            if geo.window and i == n_batches - 1:
                exported = pend  # the cross-rank sum's input, no update
            else:
                update(pend, lr, bc1, bc2)

    loss_sums, n_real_out = _shape_outputs(losses, reals, n_epochs,
                                           n_batches)
    outs = dict(
        params=QFAParams(S["F"], S["psi"], S["omega"], *S["scal"]),
        m=QFAParams(S["mF"], S["mpsi"], S["momega"],
                    *S["mscal"]).requires_grad_(False),
        v=QFAParams(S["vF"], S["vpsi"], S["vomega"],
                    *S["vscal"]).requires_grad_(False),
        loss_sums=loss_sums,
        n_real=n_real_out,
    )
    if geo.window:
        return SyncEpochOutputs(**outs, pending=exported)
    return EpochOutputs(**outs)


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


def _counters(n: int, dev) -> Tensor:
    """The kernel's arrival counters, zero at every launch's start and
    end (a test reads them after the call)."""
    return torch.zeros((n,), dtype=torch.int32, device=dev)


def _aligned(t: Tensor) -> Tensor:
    """``t`` contiguous and 16-byte aligned (the kernel reads a pending
    buffer's block sums in float4s), copied only when it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _state_parts(params, m, v) -> list[Tensor]:
    """The leaves of a state in the order of the kernel's state buffer: F,
    Psi and omega with their moments, then tau0, c0, beta, their m and
    their v (flat, detached)."""
    own = [getattr(t, k).detach().reshape(-1)
           for k in ("F", "Psi", "omega") for t in (params, m, v)]
    return own + [getattr(t, k).detach().reshape(1) for t in (params, m, v)
                  for k in ("tau0", "c0", "beta")]


class _Kernel:
    """The CUDA kernel set up on one resident dataset: the library, a copy
    of the state that the kernel updates in place (one buffer: F, Psi and
    omega with their moments, then the scalars tau0, c0, beta, their m and
    their v in a (2, 9) block whose row 0 holds them when a call starts),
    the scratch, the hyper-parameters and the schedule of the epochs from
    ``epoch`` (host rows, or the device row ``sched_dev`` when it is set).
    :meth:`run` makes one C call on the stream current at the call; the
    state stays in place from one call to the next."""

    def __init__(self, params, m, v, delta, error, zabs, mask, loglam, geo,
                 *, epoch, n_epochs, derive_zabs, learning_rate,
                 weight_decay, decay_alpha, decay_step, b1, b2, eps, bounds,
                 law, reference_norm, mxu_bf16, pending=None):
        from ._build import load_library

        dev = self.dev = delta.device
        if geo.nh < 1 or geo.nh > MAX_NH:
            raise ValueError(f"the CUDA epoch kernel supports 1 <= nh <= "
                             f"{MAX_NH}; got nh={geo.nh}")
        tensors = {
            "delta": delta, "error": error, "zabs": zabs, "mask": mask,
            "loglam": loglam if derive_zabs else None,
            "pending": _aligned(pending) if geo.apply else None,
        }
        for k in ("F", "Psi", "omega", "tau0", "c0", "beta"):
            tensors[k] = getattr(params, k)
            tensors[f"m.{k}"] = getattr(m, k)
            tensors[f"v.{k}"] = getattr(v, k)
        self.planes_bf16 = _check_kernel_tensors(tensors, dev)
        self.pending = tensors["pending"]
        self.geo, self.derive_zabs, self.mxu_bf16 = geo, derive_zabs, mxu_bf16
        self.planes = (delta, error, zabs, mask, tensors["loglam"])
        npix, nh = geo.npix, geo.nh
        ntri = nh * (nh + 1) // 2
        rows = geo.tpb * geo.tb  # batch rows
        self.n_chunks = -(-rows // _CHUNK_ROWS)
        f32 = dict(dtype=torch.float32, device=dev)
        lib = self.lib = load_library()
        self.n_fpart = int(lib.qfa_train_epoch_fpart_len(npix, rows, nh))
        self.n_counters = int(lib.qfa_train_epoch_n_counters(npix, rows))
        # the state, made by one copy
        own = _state_parts(params, m, v)
        self.state = torch.cat(own + [torch.zeros((9,), **f32)])
        self.sizes = [x.numel() for x in own[:9]] + [18]
        (self.F, self.mF, self.vF, self.psi, self.mpsi, self.vpsi, self.omega,
         self.momega, self.vomega, self.scal) = self.views(self.state)
        self.row = 0  # the row of the scalars after the last call
        sizes = [rows * ntri, rows * nh, rows * 3, self.n_fpart,
                 self.n_chunks * (ntri + nh + _A_EXTRA) * npix]
        self.scratch = torch.split(torch.empty((sum(sizes),), **f32), sizes)
        # the update blocks' scalar sums and the batch's books (zero
        # padding), and the arrival counters (zero between calls)
        self.spart = torch.zeros((3 * npix + 16,), **f32)
        self.counters = _counters(self.n_counters, dev)
        self.hp = np.array([
            *law, eps, weight_decay, b1, b2, bounds.var_min, bounds.var_max,
            bounds.tau0_min, bounds.tau0_max, bounds.beta_min,
            bounds.beta_max, bounds.c0_min, bounds.c0_max,
            1.0 if reference_norm else 0.0,
        ], np.float32)
        self.sched = np.ascontiguousarray(_schedule_rows(
            epoch, n_epochs, learning_rate, decay_alpha, decay_step, b1, b2))
        self.sched_dev: Tensor | None = None
        # while a CUDA graph captures the calls: (calls, window calls)
        # captured, counted when the graph is replayed
        self.captured: list[int] | None = None

    def views(self, buf: Tensor) -> tuple[Tensor, ...]:
        """F, mF, vF (npix, nh), psi, mpsi, vpsi, omega, momega, vomega
        and the (2, 9) scalar block: views of a buffer laid out as the
        state."""
        npix, nh = self.geo.npix, self.geo.nh
        parts = torch.split(buf, self.sizes)
        return (*(x.view(npix, nh) for x in parts[:3]), *parts[3:9],
                parts[9].view(2, 9))

    def scalars_to_row0(self) -> None:
        """Move the scalars to row 0 of their block, where a call starts."""
        if self.row:
            self.scal[0].copy_(self.scal[1])
            self.row = 0

    def run(self, perm, n_batches, n_epochs, losses, reals, pend_in=None,
            pend_out=None) -> None:
        """One C call: ``n_epochs`` epochs of ``n_batches`` batches named by
        ``perm`` (int32 on the device); in window mode, first applying
        ``pend_in`` and exporting the last batch into ``pend_out``."""
        from . import _build

        self.scalars_to_row0()
        geo, lib = self.geo, self.lib
        delta, error, zabs, mask, loglam = self.planes
        s_buf, alpha_buf, rowstat, fpart, partials = self.scratch
        # the stream current now: a CUDA graph captures on its own
        index, stream = _build.device_and_stream(self.dev)

        def ptr(t):
            return None if t is None else t.data_ptr()

        rc = lib.qfa_train_epoch(
            ptr(delta), ptr(error), int(self.planes_bf16), ptr(zabs),
            zabs.shape[1], ptr(mask), ptr(loglam), ptr(perm),
            n_batches * geo.tpb, geo.tb, geo.tpb, n_batches, n_epochs,
            geo.npix, geo.nb, geo.nh, int(mask is None),
            int(self.derive_zabs), int(self.mxu_bf16),
            ptr(self.F), ptr(self.psi), ptr(self.omega), ptr(self.mF),
            ptr(self.vF), ptr(self.mpsi), ptr(self.vpsi), ptr(self.momega),
            ptr(self.vomega), ptr(self.scal), self.hp.ctypes.data,
            self.sched.ctypes.data if self.sched_dev is None else None,
            ptr(self.sched_dev),
            ptr(s_buf), ptr(alpha_buf), ptr(rowstat), ptr(fpart),
            self.n_fpart, ptr(partials), ptr(self.spart),
            ptr(self.counters), self.n_counters, ptr(losses), ptr(reals),
            ptr(pend_in), ptr(pend_out),
            self.n_chunks, int(EARLY_LAUNCH), index, stream,
        )
        if rc != 0:
            raise RuntimeError(
                f"CUDA epoch kernel launch failed: error {rc} "
                f"({lib.qfa_cuda_error_string(rc).decode()})")
        window = int(pend_in is not None or pend_out is not None)
        if self.captured is not None:
            self.captured[0] += 1
            self.captured[1] += window
        else:
            _count(1, window)
        self.row = (int(pend_in is not None) + n_epochs * n_batches - 1) % 2

    def outputs(self, buf: Tensor | None = None
                ) -> tuple[QFAParams, QFAParams, QFAParams]:
        """params, m, v: views of the state after the last call (or of
        ``buf``, a copy of it)."""
        F, mF, vF, psi, mpsi, vpsi, omega, momega, vomega, scal = \
            self.views(self.state if buf is None else buf)
        s = scal[self.row]
        return (QFAParams.wrap(F, psi, omega, s[0], s[1], s[2]),
                QFAParams.wrap(mF, mpsi, momega, s[3], s[4], s[5],
                               requires_grad=False),
                QFAParams.wrap(vF, vpsi, vomega, s[6], s[7], s[8],
                               requires_grad=False))


def _count(calls: int, window_calls: int) -> None:
    """Add launches of the CUDA kernel to the counts."""
    global LAUNCHES, WINDOW_LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += calls
        WINDOW_LAUNCHES += window_calls


def _launch(params, m, v, delta, error, zabs, mask, loglam, geo, *,
            n_batches, n_epochs, pending=None, **kw
            ) -> EpochOutputs | SyncEpochOutputs:
    k = _Kernel(params, m, v, delta, error, zabs, mask, loglam, geo,
                n_epochs=n_epochs, pending=pending, **kw)
    f32 = dict(dtype=torch.float32, device=delta.device)
    losses = torch.empty((n_epochs * n_batches,), **f32)
    reals = torch.empty_like(losses)
    # the window's export: every float written by the kernel
    pend_out = torch.empty((pending_len(geo.npix, geo.nh),), **f32) \
        if geo.window and n_batches else None
    k.run(geo.perm.to(delta.device, torch.int32), n_batches, n_epochs, losses,
          reals, k.pending, pend_out)
    loss_sums, n_real = _shape_outputs(losses, reals, n_epochs, n_batches)
    params, m, v = k.outputs()
    outs = dict(params=params, m=m, v=v, loss_sums=loss_sums, n_real=n_real)
    if geo.window:
        return SyncEpochOutputs(**outs, pending=pend_out)
    return EpochOutputs(**outs)


class _Upload:
    """Copies of a host tensor into the device tensor ``dst`` on the
    current stream, with no host sync: through a pinned buffer that is
    rewritten only once its last copy has run. On the CPU a plain copy."""

    def __init__(self, dst: Tensor):
        self.dst = dst
        self.cuda = dst.device.type == "cuda"
        if self.cuda:
            self.host = torch.empty(dst.shape, dtype=dst.dtype,
                                    pin_memory=True)
            self.done = torch.cuda.Event()

    def __call__(self, src) -> None:
        src = torch.as_tensor(src).reshape(self.dst.shape)
        if not self.cuda:
            self.dst.copy_(src)
            return
        self.done.synchronize()
        self.host.copy_(src)
        self.dst.copy_(self.host, non_blocking=True)
        self.done.record()


class WindowCalls:
    """The window calls of exact-DP epochs on the CUDA kernel
    (``parallel.sync_dp``): the state, scratch, arrival counters, the
    epoch's tile permutation (:attr:`perm`) and its schedule row live in
    buffers set up once, for every epoch the caller runs on these planes;
    each window is one C call on them that writes its pending buffer, loss
    rows and n_real into one vector, which the caller all-reduces as it
    is. At K = 1 the per-call wrapper of :func:`fused_train_epoch`
    (checks, copies, output modules) would cost the host ten times the
    device's work per window.

    An epoch: :meth:`set_perm`, :meth:`set_epoch`, :meth:`load` the state,
    the windows and the flush (or :meth:`replay` of their CUDA graph,
    :meth:`capture`), then :meth:`snapshot`. The launches read the
    schedule from the device row that :meth:`set_epoch` writes, so a
    captured graph serves every epoch.

    The arguments are :func:`fused_train_epoch`'s on CUDA tensors (the
    CPU build of ``tools/emulate.py`` runs it on CPU tensors); the
    windows' tile permutations are slices of one int32 tensor beside the
    planes, checked by the caller. Results equal the window calls of
    :func:`fused_train_epoch` bit for bit."""

    def __init__(self, params, m, v, delta, error, zabs, mask=None, *,
                 epoch, tiles_per_batch, tile_batch, loglam=None,
                 derive_zabs=False, learning_rate=1e-3, weight_decay=0.1,
                 decay_alpha=0.9, decay_step=10, b1=0.9, b2=0.999,
                 eps=1e-8, bounds=ParamBounds(), tau_which="becker",
                 reference_norm=True, mxu_bf16=False, bwd_wide=False):
        del bwd_wide  # one backward form; see the module docstring
        # a one-batch window's geometry checks every shape
        geo = _check_args(params, m, v, delta, error, zabs,
                          torch.zeros((tiles_per_batch,), dtype=torch.int64),
                          mask, loglam, derive_zabs, 1, 1, tile_batch, True,
                          None, None, tiles_per_batch)
        self._k = _Kernel(
            params, m, v, delta, error, zabs, mask, loglam, geo, epoch=epoch,
            n_epochs=1, derive_zabs=derive_zabs, learning_rate=learning_rate,
            weight_decay=weight_decay, decay_alpha=decay_alpha,
            decay_step=decay_step, b1=b1, b2=b2, eps=eps, bounds=bounds,
            law=tau_law_abc(tau_which), reference_norm=reference_norm,
            mxu_bf16=mxu_bf16)
        self.pending_len = pending_len(geo.npix, geo.nh)
        dev = self._k.dev
        self._schedule = dict(learning_rate=learning_rate,
                              decay_alpha=decay_alpha, decay_step=decay_step,
                              b1=b1, b2=b2)
        #: the epoch's tile permutation (int32, all of the planes' tiles)
        self.perm = torch.zeros((geo.n_tiles,), dtype=torch.int32,
                                device=dev)
        # (lr, bc1, bc2) of the epoch, read by the launches
        self._k.sched_dev = torch.empty((3,), dtype=torch.float32,
                                        device=dev)
        self._put_perm = _Upload(self.perm)
        self._put_sched = _Upload(self._k.sched_dev)
        self._empty = torch.empty((0,), dtype=torch.float32, device=dev)
        self._empty_perm = self.perm[:0]
        self.graph = None
        self._graph_calls = (0, 0)
        self._graph_row = 0
        self.set_epoch(epoch)

    @property
    def state_len(self) -> int:
        return self._k.state.numel()

    def set_epoch(self, epoch: int) -> None:
        """Write the schedule row of Adam counter ``epoch`` (the learning
        rate and both bias corrections) that the launches read."""
        self._put_sched(torch.from_numpy(_schedule_rows(
            epoch, 1, **self._schedule)))

    def set_perm(self, perm) -> None:
        """Copy an epoch's tile permutation (all the tiles, checked by the
        caller) into :attr:`perm`."""
        self._put_perm(torch.as_tensor(perm).to(torch.int32))

    def load(self, params, m, v) -> None:
        """Copy a state into the state buffer, the scalars into row 0."""
        torch.cat(_state_parts(params, m, v), out=self._k.state[:-9])
        self._k.row = 0

    def window(self, perm, n_batches: int, pending=None, extra: int = 0,
               out: Tensor | None = None) -> Tensor:
        """Run ``n_batches`` batches (``perm``, their tiles), first
        applying ``pending`` if given. Returns ``[pending | loss sums |
        n_real | extra]`` (``pending_len + 2 n_batches + extra`` floats,
        in ``out`` if given, 16-byte aligned; the last ``extra`` are the
        caller's to fill)."""
        n_p = self.pending_len
        if out is None:
            out = torch.empty((n_p + 2 * n_batches + extra,),
                              dtype=torch.float32, device=self._k.dev)
        elif out.numel() < n_p + 2 * n_batches or out.data_ptr() % 16:
            raise ValueError("out must hold the pending buffer and the loss "
                             "rows, 16-byte aligned")
        self._k.run(perm, n_batches, 1, out[n_p:n_p + n_batches],
                    out[n_p + n_batches:n_p + 2 * n_batches],
                    None if pending is None else _aligned(pending), out[:n_p])
        return out

    def flush(self, pending) -> None:
        """The epoch's last call: apply ``pending``, no batch."""
        self._k.run(self._empty_perm, 0, 1, self._empty, self._empty,
                    _aligned(pending))

    def state(self) -> Tensor:
        """The state buffer (scalars in row 0), for averaging."""
        self._k.scalars_to_row0()
        return self._k.state

    def load_state(self, vec: Tensor) -> None:
        self.state().copy_(vec)

    def outputs(self) -> tuple[QFAParams, QFAParams, QFAParams]:
        """params, m, v after the last call (views of the state)."""
        return self._k.outputs()

    def snapshot(self) -> tuple[QFAParams, QFAParams, QFAParams]:
        """params, m, v after the last call, as views of a copy of the
        state: the next epoch's calls leave them as they are."""
        return self._k.outputs(self._k.state.clone())

    def capture(self, issue) -> None:
        """Capture ``issue()``, an epoch's window calls from a loaded
        state and whatever the caller issues between them, into one CUDA
        graph (:attr:`graph`) on torch's capture stream. Nothing runs
        until :meth:`replay`; the state's buffers stay as they are."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        k = self._k
        row, k.row, k.captured = k.row, 0, [0, 0]
        try:
            # only this thread's calls are checked: NCCL's and the process
            # group's own threads may call CUDA while it captures
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                issue()
            self._graph_calls, self._graph_row = tuple(k.captured), k.row
        finally:
            k.captured, k.row = None, row
        graph.instantiate()
        self.graph = graph

    def replay(self) -> None:
        """Run the captured epoch from the loaded state on the current
        stream; its launches count as the eager calls would."""
        self._k.scalars_to_row0()
        self.graph.replay()
        self._k.row = self._graph_row
        _count(*self._graph_calls)


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
    tiles_per_batch: int | None = None,
    pending: Tensor | None = None,
    apply_pending=None,
) -> EpochOutputs | SyncEpochOutputs:
    """Run ``n_epochs`` full training epochs in one call, or one window of
    an epoch (``sync_grads``).

    Args:
        params, m, v: parameters and Adam moments (left unchanged; the
            updated ones are returned).
        delta/error/zabs/mask: the resident dataset, (N, ...) with N a
            multiple of ``tile_batch``; see the module docstring for the
            layouts.
        tile_perm: ``n_epochs * n_batches * tiles_per_batch`` tile indices
            (flat, or one row per epoch): the epoch shuffle, or a window's
            batches.
        epoch: the Adam counter of the call's first epoch (epoch ``k`` of
            the call uses ``epoch + k``).
        n_batches: optimizer updates per epoch; a batch is
            ``tiles_per_batch`` tiles (default ``N // tile_batch //
            n_batches``).
        sync_grads, pending, apply_pending: the window mode (module
            docstring); ``pending`` is a (:func:`pending_len`,) float32
            buffer, applied first when ``apply_pending > 0``.

    Returns :class:`EpochOutputs` (:class:`SyncEpochOutputs` in window
    mode); ``loss_sums`` and ``n_real`` are ``(n_batches,)`` for one epoch
    and ``(n_epochs, n_batches)`` for several. Tensors on the CPU run
    :func:`fused_train_epoch_plain`; tensors on a CUDA device launch the
    CUDA kernel, or raise (float32, the delta and error planes float32 or
    both bfloat16, contiguous, all on one device, 1 <= nh <= 10).
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
            bwd_wide=bwd_wide, sync_grads=sync_grads,
            tiles_per_batch=tiles_per_batch, pending=pending,
            apply_pending=apply_pending, **kw)
    if delta.device.type != "cuda":
        raise ValueError(
            f"fused_train_epoch runs on cpu or cuda, not {delta.device}")
    geo = _check_args(params, m, v, delta, error, zabs, tile_perm, mask,
                      loglam, derive_zabs, n_batches, n_epochs, tile_batch,
                      sync_grads, pending, apply_pending, tiles_per_batch)
    kw.pop("loglam")
    kw.pop("tile_batch")
    law = tau_law_abc(kw.pop("tau_which"))
    return _launch(params, m, v, delta, error, zabs, mask, loglam, geo,
                   law=law, pending=pending, **kw)
