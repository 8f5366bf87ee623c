"""Fused prediction: the whole predict stack for a batch in ONE kernel launch.

Per spectrum the predict path needs the marginal NLL (OOD score), the
posterior latents ``hmean = K^-1 w`` / ``hcov = K^-1``, the unabsorbed
continuum ``F hmean + mu`` and its uncertainty ``sqrt(diag(F hcov F^T))``.
:func:`fused_predict` computes all of them:

* on a CUDA tensor, in a hand-written CUDA kernel (the port of
  ``qfa_tpu.ops.infer_kernel._predict_kernel``), built at first use by
  :mod:`._build`: bfloat16 flux and error planes, and float32 ones (a
  mixed pair is read as float32) in calls of at least
  :data:`TC_MIN_ROWS` spectra, go to ``csrc/predict_tc.cu`` (tiles of 64
  spectra, each tile's pixel axis split across blocks, the products on
  the tensor cores against the ``[tri(Gram) | F]`` table,
  :func:`gram_table`); smaller float32 calls go to ``csrc/predict.cu``
  (one warp per spectrum); a launch that fails raises, and nothing falls
  back to the other body or to the plain version;
* on a CPU tensor, in :func:`fused_predict_plain`, the same function in
  plain torch ops — the reference the kernel is held against on the card.

Modes: an explicit mask plane or a mask derived as ``error > 0``; a zabs
plane (width Nb, Npix or round_up(Npix, 128)) or the (N, 2) zq column plus
the ``loglam`` row; ``stats_only``. The flux, error, mask and zabs planes
are read as float32 or bfloat16 (a plane of any other dtype is cast to
float32, as JAX's wrapper does); ``out_dtype=torch.bfloat16`` stores the
continuum and std planes as bfloat16. All arithmetic, and the
per-spectrum stats, stay float32.
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..linalg import smallchol
from ..linalg.lowrank import LOG_2PI
from ..models.params import QFAParams
from ..utils.profiling import span
from .common import ZQ_WIDTH, tau_law_abc, tri_idx, tri_pairs

Tensor = torch.Tensor

__all__ = [
    "BF16_LAUNCHES",
    "FusedPredictOutputs",
    "LAUNCHES",
    "TC_F32_LAUNCHES",
    "TC_LAUNCHES",
    "TC_MIN_ROWS",
    "WARP_LAUNCHES",
    "fused_predict",
    "fused_predict_plain",
    "gram_table",
    "split_tf32",
]

#: Launches of the CUDA prediction kernel in this process. Incremented
#: where the wrapper launches the kernel, and nowhere else.
LAUNCHES = 0
#: ... of them, the launches that read or store a bfloat16 plane
BF16_LAUNCHES = 0
#: ... of them, the launches of each body: ``csrc/predict_tc.cu`` and
#: ``csrc/predict.cu``
TC_LAUNCHES = 0
WARP_LAUNCHES = 0
#: ... of the tc body's, those on float32 flux and error
TC_F32_LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()

#: the kernel is instantiated for 1 <= nh <= 10 (nh*nh + nh + 2 <= 128,
#: the JAX kernel's stats-row bound)
MAX_NH = 10

#: float32 calls of at least this many spectra run the tc body, smaller
#: ones predict.cu: the CLI's chunk, the first size at which the tc body
#: was the faster at both widths and in both modes, on an H100 (below it
#: its tiles of 64 spectra, in at most 4 parts of the pixel axis, fill the
#: card's SMs in whole waves only at some sizes; PERF.md, chip_smoke.py
#: phase 6)
TC_MIN_ROWS = 8192


class FusedPredictOutputs(NamedTuple):
    ll: Tensor  #: (N,) per-spectrum NLL (OOD score).
    hmean: Tensor  #: (N, Nh) posterior latent means.
    hcov: Tensor  #: (N, Nh, Nh) posterior covariances.
    continuum: Tensor | None  #: (N, Npix) continuum; None when stats_only.
    continuum_std: Tensor | None  #: (N, Npix) uncertainty; None when stats_only.
    n_obs: Tensor  #: (N,) observed-pixel counts.


def _check_args(params, flux, error, zabs, mask, loglam, derive_zabs):
    npix, nh = params.F.shape
    nb = params.omega.shape[0]
    if nh < 1 or nh * nh + nh + 2 > 128:
        raise ValueError(
            f"fused_predict supports 1 <= nh and nh*nh+nh+2 <= 128 "
            f"(nh <= {MAX_NH}); got nh={nh}"
        )
    n = flux.shape[0]
    if flux.ndim != 2 or flux.shape[1] != npix or error.shape != flux.shape:
        raise ValueError(
            f"flux {tuple(flux.shape)} and error {tuple(error.shape)} must "
            f"both be (N, Npix={npix})"
        )
    if mask is not None and mask.shape != flux.shape:
        raise ValueError(
            f"mask {tuple(mask.shape)} must match flux {tuple(flux.shape)}"
        )
    if derive_zabs:
        if loglam is None:
            raise ValueError("derive_zabs=True requires the loglam row")
        if zabs.ndim != 2 or zabs.shape[1] != ZQ_WIDTH:
            # exact width: a zabs PLANE must not be misread as a column
            raise ValueError(
                f"derive_zabs=True expects the (N, {ZQ_WIDTH}) zq_column "
                f"buffer, got {tuple(zabs.shape)}"
            )
        if zabs.shape[0] != n:
            raise ValueError(
                f"zq column has {zabs.shape[0]} rows but the batch planes "
                f"have {n}"
            )
        if loglam.shape != (npix,):
            raise ValueError(
                f"loglam {tuple(loglam.shape)} must be (Npix={npix},)"
            )
    else:
        p = -(-npix // 128) * 128
        if zabs.ndim != 2 or zabs.shape[0] != n or \
                zabs.shape[1] not in (nb, npix, p):
            raise ValueError(
                f"zabs plane {tuple(zabs.shape)} matches neither (N, Nb={nb})"
                f" nor (N, Npix={npix}); if this is a zq_column buffer, pass "
                "derive_zabs=True (and loglam)"
            )


@torch.no_grad()
def fused_predict_plain(
    params: QFAParams,
    mu: Tensor,
    flux: Tensor,
    error: Tensor,
    zabs: Tensor,
    mask: Tensor | None = None,
    *,
    tau_which: str = "becker",
    stats_only: bool = False,
    loglam: Tensor | None = None,
    derive_zabs: bool = False,
    out_dtype: torch.dtype = torch.float32,
) -> FusedPredictOutputs:
    """:func:`fused_predict` in plain torch ops, on any device.

    The same arithmetic as the CUDA kernel, in fp32: the contractions are
    matrix products against the lower-triangle Gram rows ``F_a F_b``.
    Takes float32 or bfloat16 planes; ``out_dtype`` sets the dtype of the
    continuum and std planes.
    """
    _check_args(params, flux, error, zabs, mask, loglam, derive_zabs)
    law_a, law_b, law_c = tau_law_abc(tau_which)
    f32 = torch.float32
    npix, nh = params.F.shape
    nb = params.omega.shape[0]
    n = flux.shape[0]
    flux = flux.to(f32)
    err = error.to(f32)
    m = (err > 0.0).to(f32) if mask is None else mask.to(f32)
    tau0, c0, beta = params.tau0, params.c0, params.beta

    if derive_zabs:
        logzp1 = zabs[:, :1].to(f32) + loglam[:nb].to(f32)  # (N, Nb)
        tau_line = law_a * torch.exp(law_b * logzp1) + law_c
        zp1b = torch.exp(beta * logzp1)
    else:
        zp1 = 1.0 + zabs[:, :nb].to(f32)
        tau_line = law_a * zp1**law_b + law_c
        zp1b = zp1**beta
    root = 1.0 - c0 - torch.exp(-(tau0 * zp1b))
    red = (n, npix - nb)
    amp = torch.cat([torch.exp(-tau_line), flux.new_ones(red)], dim=1)
    forest = torch.cat([params.omega * (root * root), flux.new_zeros(red)],
                       dim=1)
    d = amp * amp * params.Psi + forest + err * err
    delta = (flux - mu * amp) * m
    d_safe = torch.where(m > 0, d, 1.0)
    dinv = m / d_safe
    w = amp * amp * dinv
    u = amp * dinv * delta
    ql = delta * delta * dinv + m * torch.log(d_safe)

    pairs = tri_pairs(nh)
    ia = [a for a, _ in pairs]
    ib = [b for _, b in pairs]
    f = params.F
    gram = gram_table(f)[:, :len(pairs)]  # (Npix, ntri) lower Gram rows
    k_tri = w @ gram  # (N, ntri)
    full = torch.tensor([[tri_idx(a, b) for b in range(nh)]
                         for a in range(nh)], device=flux.device)
    k = k_tri[:, full] + torch.eye(nh, dtype=f32, device=flux.device)
    chol = smallchol.cholesky_small(k)
    y = smallchol.solve_lower_small(chol, u @ f)
    hmean = smallchol.solve_upper_small(chol, y)
    n_obs = m.sum(dim=1)
    ll = 0.5 * (ql.sum(dim=1) - (y * y).sum(dim=-1) + n_obs * LOG_2PI
                + smallchol.logdet_from_chol(chol))
    hcov = smallchol.inverse_from_chol(chol)
    cont = std = None
    if not stats_only:
        cont = (hmean @ f.T + mu).to(out_dtype)
        # diag(F K^-1 F^T) over the symmetric triangle, off-diagonal doubled
        scale = torch.tensor([1.0 if a == b else 2.0 for a, b in pairs],
                             device=flux.device)
        var = (hcov[:, ia, ib] * scale) @ gram.T
        std = torch.sqrt(torch.clamp(var, min=0.0)).to(out_dtype)
    return FusedPredictOutputs(ll=ll, hmean=hmean, hcov=hcov, continuum=cont,
                               continuum_std=std, n_obs=n_obs)


def gram_table(F: Tensor) -> Tensor:
    """The ``[tri(Gram) | F]`` table, (Npix, ntri + nh): column ``tri_idx(a,
    b)`` is ``F[:, a] * F[:, b]`` (the lower Gram triangle, elementwise
    products of F's columns), then F's columns. JAX's ``fused_predict``
    builds the same rows once outside its kernel (``rhst``, transposed)."""
    ia, ib = zip(*tri_pairs(F.shape[1]))
    return torch.cat([F[:, list(ia)] * F[:, list(ib)], F], dim=1)


def split_tf32(x: Tensor) -> tuple[Tensor, Tensor]:
    """x = hi + lo for the tensor cores' three TF32 passes: hi is x rounded
    to TF32 (to nearest, ties away from zero, the 13 low bits cleared, as
    cvt.rna rounds a finite float32), lo the rest ``x - hi`` (exact)
    rounded the same way. Each is a float32 tensor holding TF32 values."""

    def tf32(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
            torch.float32)

    hi = tf32(x)
    return hi, tf32(x - hi)


def _pad8(k: int) -> int:
    return -(-k // 8) * 8


@functools.lru_cache(maxsize=16)
def _tc_index(npix: int, nh: int, pad: int, device: str):
    """Where each entry of the tc table comes from (shapes only, so it is
    kept): two positions in ``[F.ravel(), 0, 1]`` whose product it is,
    and whether it is a hi entry. Entry (8-pixel step k, column n, t, part,
    s) is pixel 8 k + 4 s + t, column n of the padded ``[tri(Gram) | F]``
    table; pixels past npix and the padding columns are 0 * 0, F's
    columns F * 1."""
    nt = nh * (nh + 1) // 2
    ng, nf = _pad8(nt), _pad8(nh)
    n = ng + nf
    p = -(-npix // pad) * pad
    zero, one = npix * nh, npix * nh + 1
    col_a, col_b = np.full(n, -1), np.full(n, -1)  # -1: a zero factor
    for c, (a, b) in enumerate(tri_pairs(nh)):
        col_a[c], col_b[c] = a, b
    col_a[ng:ng + nh] = np.arange(nh)
    col_b[ng:ng + nh] = -2  # -2: the factor 1
    k, col, t, part, s = np.meshgrid(np.arange(p // 8), np.arange(n),
                                     np.arange(4), np.arange(2), np.arange(2),
                                     indexing="ij")
    pix = 8 * k + 4 * s + t

    def where(c):
        c = c[col]
        at = np.where(c == -2, one, pix * nh + c)
        return np.where((c == -1) | (pix >= npix), zero, at).ravel()

    return (torch.as_tensor(where(col_a).astype(np.int32), device=device),
            torch.as_tensor(where(col_b).astype(np.int32), device=device),
            torch.as_tensor(part.ravel() == 0, device=device),
            torch.tensor([0.0, 1.0], device=device))


def _tc_table(F: Tensor, pad: int) -> Tensor:
    """The table of ``csrc/predict_tc.cu`` in plain torch (the kernel's
    ``predict_tc_table_kernel`` builds it on the card, and is held to this
    bitwise), split into TF32 hi and lo and laid out in the order of its
    MMA fragments: the Gram triangle padded to a multiple of 8 columns,
    then F padded the same way (N columns in all), the pixel axis padded
    with zero rows to a multiple of ``pad``. Entry (8-pixel step k, column
    n, t) holds hi, hi, lo, lo of pixels 8 k + t and 8 k + t + 4: the
    columns of :func:`gram_table`, each product ``F_a * F_b`` taken once
    (the index maps depend on the shapes only)."""
    npix, nh = F.shape
    ia, ib, is_hi, zero_one = _tc_index(npix, nh, pad, str(F.device))
    src = torch.cat([F.reshape(-1), zero_one])
    hi, lo = split_tf32(src[ia] * src[ib])
    return torch.where(is_hi, hi, lo)


def _as_read(params, mu, flux, error, zabs, mask, loglam, derive_zabs):
    """The arguments in the dtypes the kernel reads, as JAX's wrapper
    casts them: float32 and bfloat16 planes kept, a plane of any other
    dtype cast to float32 (``pad_px``); the zq column, ``mu``, ``loglam``
    and the parameters cast to float32 (``row``, ``zabs.astype``)."""
    f32, bf16 = torch.float32, torch.bfloat16

    def plane(x):
        return x if x is None or x.dtype is f32 or x.dtype is bf16 \
            else x.to(f32)

    def f32_(x):
        return x if x is None or x.dtype is f32 else x.to(f32)

    ps = (params.F, params.Psi, params.omega, params.tau0, params.c0,
          params.beta)
    if tuple(p.dtype for p in ps) != (f32,) * len(ps):
        params = QFAParams.wrap(*(p.detach().to(f32) for p in ps),
                                requires_grad=False)
    zabs = f32_(zabs) if derive_zabs else plane(zabs)
    return (params, f32_(mu), plane(flux), plane(error), zabs, plane(mask),
            f32_(loglam))


def _route(flux: Tensor, error: Tensor) -> str:
    """The CUDA body :func:`fused_predict` runs on these flux and error
    planes: ``"tc"`` for bfloat16 ones, and for float32 ones (or a mixed
    pair) of at least :data:`TC_MIN_ROWS` spectra; ``"warp"`` for smaller
    float32 calls."""
    bf16 = flux.dtype is torch.bfloat16 and error.dtype is torch.bfloat16
    return "tc" if bf16 or flux.shape[0] >= TC_MIN_ROWS else "warp"


def _launch(params, mu, flux, error, zabs, mask, *, law, stats_only, loglam,
            derive_zabs, out_dtype, body=None) -> FusedPredictOutputs:
    """One call of a CUDA body: ``"tc"`` (``csrc/predict_tc.cu``) or
    ``"warp"`` (``csrc/predict.cu``); by default bfloat16 flux/error, and
    float32 ones in calls of at least :data:`TC_MIN_ROWS` spectra, run the
    first."""
    from ._build import device_and_stream, load_library

    f32, bf16 = torch.float32, torch.bfloat16
    dev = flux.device
    if out_dtype is not f32 and out_dtype is not bf16:
        raise TypeError(
            f"the CUDA prediction kernel stores float32 or bfloat16 planes, "
            f"not {out_dtype}")
    if flux.dtype is not error.dtype:
        # the kernel reads flux and error as one type: the bfloat16 one
        # is read as float32 (exact, so the outputs are the same bits)
        flux, error = flux.float(), error.float()
    if body is None:
        body = _route(flux, error)
    if body not in ("tc", "warp"):
        raise ValueError(f"no prediction body {body!r}")
    zplane = None if derive_zabs else zabs
    for name, t, is_plane in (
        ("flux", flux, True), ("error", error, True), ("mask", mask, True),
        ("zabs", zplane, True), ("zq column", zabs if derive_zabs else None,
                                 False),
        ("mu", mu, False), ("F", params.F, False), ("Psi", params.Psi, False),
        ("omega", params.omega, False), ("tau0", params.tau0, False),
        ("c0", params.c0, False), ("beta", params.beta, False),
        ("loglam", loglam if derive_zabs else None, False),
    ):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device} but flux on {dev}")
        if t.dtype is not f32 and not (is_plane and t.dtype is bf16):
            raise TypeError(f"{name} must be float32"
                            f"{' or bfloat16' if is_plane else ''}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    npix, nh = params.F.shape
    nb = params.omega.shape[0]
    if mu.shape != (npix,):
        raise ValueError(f"mu {tuple(mu.shape)} must be (Npix={npix},)")
    n = flux.shape[0]
    on = dict(dtype=f32, device=dev)
    ll = torch.empty((n,), **on)
    n_obs = torch.empty((n,), **on)
    hmean = torch.empty((n, nh), **on)
    hcov = torch.empty((n, nh, nh), **on)
    cont = std = None
    if not stats_only:
        cont = torch.empty((n, npix), dtype=out_dtype, device=dev)
        std = torch.empty((n, npix), dtype=out_dtype, device=dev)
    out = FusedPredictOutputs(ll=ll, hmean=hmean, hcov=hcov, continuum=cont,
                              continuum_std=std, n_obs=n_obs)
    if n == 0:
        return out

    def ptr(t):
        return None if t is None else t.data_ptr()

    # which planes are bfloat16: flux/error, zabs plane, mask, outputs
    bf = (int(flux.dtype is bf16), int(zplane is not None and
                                       zplane.dtype is bf16),
          int(mask is not None and mask.dtype is bf16), int(out_dtype is bf16))
    lib = load_library()
    index, stream = device_and_stream(dev)
    planes = (ptr(flux), ptr(error), bf[0], ptr(zabs), zabs.shape[1], bf[1],
              ptr(mask), bf[2])
    tail = (ptr(params.tau0), ptr(params.c0), ptr(params.beta),
            *law, n, npix, nb, nh, int(mask is None), int(derive_zabs),
            ptr(ll), ptr(n_obs), ptr(hmean), ptr(hcov), ptr(cont), ptr(std),
            bf[3], index, stream)
    loglam_p = ptr(loglam if derive_zabs else None)
    if body == "tc":
        # the table, the parts' sums, the coefficients and the counters
        scratch = torch.empty(
            (lib.qfa_predict_tc_scratch_len(n, npix, nh, int(not stats_only)),),
            dtype=torch.uint8, device=dev)
        fn, f_and_scratch = lib.qfa_predict_tc_f32, (ptr(params.F),
                                                     ptr(scratch))
    else:
        fn, f_and_scratch = lib.qfa_predict_f32, (ptr(params.F),)
    with span("qfa.fused_predict.launch"):
        rc = fn(*planes, ptr(mu), *f_and_scratch, ptr(params.Psi),
                ptr(params.omega), loglam_p, *tail)
    if rc != 0:
        raise RuntimeError(
            f"CUDA prediction kernel launch failed ({body} body): error {rc} "
            f"({lib.qfa_cuda_error_string(rc).decode()})"
        )
    global LAUNCHES, BF16_LAUNCHES, TC_LAUNCHES, WARP_LAUNCHES, \
        TC_F32_LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1
        BF16_LAUNCHES += int(any(bf))
        TC_LAUNCHES += int(body == "tc")
        WARP_LAUNCHES += int(body == "warp")
        TC_F32_LAUNCHES += int(body == "tc" and not bf[0])
    return out


@torch.no_grad()
def fused_predict(
    params: QFAParams,
    mu: Tensor,
    flux: Tensor,
    error: Tensor,
    zabs: Tensor,
    mask: Tensor | None = None,
    *,
    tau_which: str = "becker",
    stats_only: bool = False,
    loglam: Tensor | None = None,
    derive_zabs: bool = False,
    out_dtype: torch.dtype = torch.float32,
) -> FusedPredictOutputs:
    """Predict continua, posteriors and OOD scores for a batch in one call.

    ``flux``/``error``/``mask`` are (N, Npix); N needs no divisibility.
    ``mask=None`` derives the mask from ``error > 0`` (the data layer
    sanitizes masked pixels to 0). ``derive_zabs=True`` takes the (N, 2)
    :func:`~qfa_tpu_torch.ops.common.zq_column` in place of the zabs plane,
    plus ``loglam`` (:func:`~qfa_tpu_torch.ops.common.loglam_row`).
    ``stats_only=True`` skips the continuum and std planes (they come back
    as None): the survey-scale OOD sweep.

    The planes may be float32 or bfloat16 (any other dtype is cast to
    float32); ``out_dtype`` (float32 or bfloat16) is the continuum and
    std planes' dtype. The stats are float32, and bitwise the same for
    either ``out_dtype``.

    Tensors on the CPU run :func:`fused_predict_plain`. Tensors on a CUDA
    device launch a CUDA kernel, or raise: contiguous, all on one
    device. bfloat16 flux and error go to ``csrc/predict_tc.cu``, and
    float32 ones too in calls of at least :data:`TC_MIN_ROWS` spectra;
    smaller float32 calls go to ``csrc/predict.cu``.
    """
    return _fused_predict_body(
        None, params, mu, flux, error, zabs, mask, tau_which=tau_which,
        stats_only=stats_only, loglam=loglam, derive_zabs=derive_zabs,
        out_dtype=out_dtype)


@torch.no_grad()
def _fused_predict_body(body, params, mu, flux, error, zabs, mask=None, *,
                        tau_which="becker", stats_only=False, loglam=None,
                        derive_zabs=False, out_dtype=torch.float32):
    """:func:`fused_predict` with the CUDA body chosen: ``"tc"`` runs
    ``csrc/predict_tc.cu`` whatever the flux/error type and N (on float32
    planes its float32 instantiation, the exact witness of the bfloat16
    one), ``"warp"`` runs ``csrc/predict.cu`` whatever they are (on
    bfloat16 planes too, to time it against the other); None chooses as
    :func:`fused_predict` does. CPU tensors run the plain version."""
    with span("qfa.fused_predict"):
        _check_args(params, flux, error, zabs, mask, loglam, derive_zabs)
        params, mu, flux, error, zabs, mask, loglam = _as_read(
            params, mu, flux, error, zabs, mask, loglam, derive_zabs)
        law = tau_law_abc(tau_which)
        kw = dict(stats_only=stats_only, loglam=loglam,
                  derive_zabs=derive_zabs, out_dtype=out_dtype)
        if flux.device.type == "cpu":
            return fused_predict_plain(params, mu, flux, error, zabs, mask,
                                       tau_which=tau_which, **kw)
        if flux.device.type != "cuda":
            raise ValueError(
                f"fused_predict runs on cpu or cuda, not {flux.device}")
        return _launch(params, mu, flux, error, zabs, mask, law=law,
                       body=body, **kw)
