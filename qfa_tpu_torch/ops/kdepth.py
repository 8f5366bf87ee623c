"""The contraction-depth probe: the training kernels' backward products in
isolation.

:func:`contraction_probe` runs

* on CUDA tensors, the hand-written CUDA kernel ``csrc/kdepth.cu`` (the
  port of ``tools/mxu_kdepth.py``'s ``_body``: the MXU's dot products on
  the tensor cores in split TF32, the VPU's outer products in f32 FMAs),
  built at first use by :mod:`._build`; a launch that fails raises;
* on CPU tensors, :func:`contraction_probe_plain`, the same steps in plain
  torch ops: the reference the kernel is held against on the card.

Each of ``grid`` steps ``j`` scales the left operand by ``s_j = 1 + j *
1e-9`` (float32) and adds ``dw * 0.5 + du * 0.25`` (or ``dw * 0.5``
without a second contraction) to a (TB, P) output, with ``dw = (s_j
L[:k1])^T R[:k1]`` and ``du`` the next ``k2`` rows; ``vpu_k2=True`` takes
``du``'s left operand from the transposed ``lt``, ``vpu_k2="wide"`` runs
one ``k1 + k2`` contraction against the block-diagonal ``r2`` (KMAX, 2P)
and combines its halves.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

Tensor = torch.Tensor

__all__ = ["KMAX", "LAUNCHES", "P", "TB", "VARIANTS", "contraction_probe",
           "contraction_probe_plain", "step_scale"]

#: Calls that launched the CUDA probe kernel in this process. Incremented
#: where the wrapper launches the kernel, and nowhere else.
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()

#: the probe's shapes: output rows (the training kernels' batch tile),
#: pixels, and the largest contraction depth
TB = 256
P = 1920
KMAX = 128

#: (name, K1, K2-or-None, vpu_k2), as in tools/mxu_kdepth.py: K2 mimics the
#: training kernels' second (du) product; vpu_k2=True reads its left
#: operand from the transposed lt, "wide" runs one K1 + K2 contraction
#: against the block-diagonal r2.
VARIANTS = (
    ("pair36+8", 36, 8, False),
    ("single8", 8, None, False),
    ("single44", 44, None, False),
    ("single64", 64, None, False),
    ("single128", 128, None, False),
    ("vpu8", 0, 8, True),
    ("pair36+vpu8", 36, 8, True),
    ("wide44", 36, 8, "wide"),
)

#: the CUDA kernel's tile: TB must be a multiple of _BM, P of _BN
_BM, _BN = 64, 128
_MODE = {False: 0, True: 1, "wide": 2}
#: the library's chunks per (library, variant, device index), asked once:
#: the query costs host time that a call at a small grid would show
_CHUNKS: dict = {}


def step_scale(j: int) -> float:
    """The step's operand scale ``1 + j * 1e-9``, rounded as float32
    arithmetic rounds it (the product, then the sum)."""
    return float(np.float32(1.0) + np.float32(j) * np.float32(1e-9))


_VARIANT_KEYS = frozenset(v[1:] for v in VARIANTS)
_FLOATS = (torch.float32, torch.float64)


def _check(l, lt, r, r2, k1, k2, vpu_k2, grid) -> None:
    if (k1, k2, vpu_k2) not in _VARIANT_KEYS:
        raise ValueError(f"(k1, k2, vpu_k2) = {(k1, k2, vpu_k2)} is none of "
                         f"the probe's VARIANTS")
    if int(grid) != grid or grid < 0:
        raise ValueError(f"grid must be an integer >= 0, got {grid!r}")
    if l.ndim != 2:
        raise ValueError(f"l must be (KMAX, TB), got {tuple(l.shape)}")
    kmax, tb = l.shape
    p = r.shape[-1]
    dtype, device = l.dtype, l.device
    for name, t, want in (("l", l, (kmax, tb)), ("lt", lt, (tb, kmax)),
                          ("r", r, (kmax, p)), ("r2", r2, (kmax, 2 * p))):
        if t.shape != want:
            raise ValueError(f"{name} is {tuple(t.shape)}, must be {want}")
        if t.dtype is not dtype or dtype not in _FLOATS:
            raise TypeError(f"{name} is {t.dtype}; the operands must all be "
                            "float32 (or all float64 for a reference)")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device} but l on {device}")
    if k1 + (k2 or 0) > kmax:
        raise ValueError(f"k1 + k2 = {k1 + (k2 or 0)} exceeds KMAX {kmax}")


@torch.no_grad()
def contraction_probe_plain(l: Tensor, lt: Tensor, r: Tensor, r2: Tensor, *,
                            k1: int, k2: int | None, vpu_k2, grid: int
                            ) -> Tensor:
    """:func:`contraction_probe` in plain torch ops, on any device: a Python
    loop over the ``grid`` steps, each step's products in the dtype of the
    inputs (float32; float64 operands give a reference)."""
    _check(l, lt, r, r2, k1, k2, vpu_k2, grid)
    p = r.shape[1]
    out = torch.zeros((l.shape[1], p), dtype=l.dtype, device=l.device)
    for j in range(grid):
        s = step_scale(j)
        l_all = l * s
        if vpu_k2 == "wide":
            wide = l_all[: k1 + k2].T @ r2[: k1 + k2]
            out = out + (wide[:, :p] * 0.5 + wide[:, p:] * 0.25)
            continue
        dw = l_all[:k1].T @ r[:k1] if k1 else None
        if k2 is None:
            out = out + dw * 0.5
            continue
        if vpu_k2:
            lt_s = lt * s
            du = lt_s[:, k1:k1 + 1] * r[k1:k1 + 1]
            for jj in range(1, k2):
                du = du + lt_s[:, k1 + jj:k1 + jj + 1] * r[k1 + jj:k1 + jj + 1]
        else:
            du = l_all[k1:k1 + k2].T @ r[k1:k1 + k2]
        out = out + (du * 0.25 if dw is None else dw * 0.5 + du * 0.25)
    return out


def _launch(l, lt, r, r2, k1, k2, vpu_k2, grid, chunks=None) -> Tensor:
    """The CUDA kernel on ``l``'s device, its grid steps split into the
    library's number of chunks for the card (``qfa_kdepth_chunks``) across
    blocks, the partials summed in chunk order. ``chunks`` overrides that
    number; it exists for measurements and tests only (``chip_smoke.py``
    and ``kdepth_variants.py`` time one chunk and every count, the
    emulation test sums one step per chunk), and no entry point sets it."""
    from . import _build

    kmax, tb = l.shape
    p = r.shape[1]
    if l.dtype != torch.float32:
        raise TypeError(f"the CUDA probe kernel takes float32, not {l.dtype}")
    if tb % _BM or p % _BN:
        raise ValueError(f"the CUDA probe kernel needs TB % {_BM} == 0 and "
                         f"P % {_BN} == 0; got TB={tb}, P={p}")
    for name, t in zip(("l", "lt", "r", "r2"), (l, lt, r, r2)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _build.load_library()
    index, stream = _build.device_and_stream(l.device)
    variant = (tb, p, k1, k2 or 0, _MODE[vpu_k2], int(grid))
    if chunks is None:
        key = (lib, variant, index)
        chunks = _CHUNKS.get(key) or _CHUNKS.setdefault(
            key, _chunks(lib, variant, index))
    out = torch.empty((tb, p), dtype=torch.float32, device=l.device)
    part = torch.empty((chunks, tb, p), dtype=torch.float32,
                       device=l.device) if chunks > 1 else None
    _check_rc(lib, lib.qfa_kdepth_f32(
        l.data_ptr(), lt.data_ptr(), r.data_ptr(), r2.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        0 if part is None else part.numel(), kmax, *variant, chunks,
        index, stream))
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    return out


def _chunks(lib, variant, index) -> int:
    """The library's number of chunks for ``variant`` = (TB, P, k1, k2 or
    0, mode, grid) on device ``index``: the card's resident blocks over the
    output tiles (``qfa_kdepth_chunks``)."""
    n = ctypes.c_int(0)
    _check_rc(lib, lib.qfa_kdepth_chunks(*variant, index, ctypes.byref(n)))
    return n.value


def _check_rc(lib, rc) -> None:
    if rc != 0:
        raise RuntimeError(
            f"CUDA kdepth kernel launch failed: error {rc} "
            f"({lib.qfa_cuda_error_string(rc).decode()})")


@torch.no_grad()
def contraction_probe(l: Tensor, lt: Tensor, r: Tensor, r2: Tensor, *,
                      k1: int, k2: int | None, vpu_k2, grid: int) -> Tensor:
    """``grid`` steps of the probe variant ``(k1, k2, vpu_k2)`` (one of
    ``VARIANTS``) over float32 ``l`` (KMAX, TB), ``lt`` (TB, KMAX), ``r``
    (KMAX, P) and ``r2`` (KMAX, 2P); returns the (TB, P) sum. CPU tensors
    run :func:`contraction_probe_plain`; CUDA tensors launch the CUDA
    kernel on the current stream, or raise (contiguous, TB a multiple of
    64, P of 128)."""
    _check(l, lt, r, r2, k1, k2, vpu_k2, grid)
    if l.device.type == "cpu":
        return contraction_probe_plain(l, lt, r, r2, k1=k1, k2=k2,
                                       vpu_k2=vpu_k2, grid=grid)
    if l.device.type != "cuda":
        raise ValueError(f"contraction_probe runs on cpu or cuda, not "
                         f"{l.device}")
    return _launch(l, lt, r, r2, k1, k2, vpu_k2, grid)
