"""Register-resident ALU chains: the card's calibration kernel.

:func:`alu_chain` runs

* on CUDA tensors, the hand-written CUDA kernel ``csrc/alu_chain.cu`` (the
  port of the kernel inside ``bench.calibrate_vpu``), built at first use by
  :mod:`._build`; a launch that fails raises;
* on CPU tensors, :func:`alu_chain_plain`, the same chains in plain torch
  ops: the reference the kernel is held against on the card.

Each element ``x`` of an (R, C) float32 tile starts ``CHAINS`` independent
chains at ``x * (1 + 0.01 k)``, runs ``n_iters * BODY_REPS`` reps of one
op on each, and returns ``((x0 + x1) + x2) + x3``. ``calibrate.calibrate_alu``
times two iteration counts and takes the difference.
"""

from __future__ import annotations

import threading

import torch

Tensor = torch.Tensor

__all__ = ["BODY_REPS", "CHAINS", "LAUNCHES", "OPS", "alu_chain",
           "alu_chain_plain"]

#: Calls that launched the CUDA chain kernel in this process. Incremented
#: where the wrapper launches the kernel, and nowhere else.
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()

#: the op classes, in the order of the kernel's op id
OPS = ("fma", "exp", "log", "div")
#: unrolled reps per chain per iteration
BODY_REPS = 32
#: independent chains per element
CHAINS = 4

#: the fma step's constants as float32 holds them (1 + 2^-23, ~1e-7)
_FMA_A = float(torch.tensor(1.0000001, dtype=torch.float32))
_FMA_B = float(torch.tensor(1e-7, dtype=torch.float32))


def _fma(x: Tensor) -> Tensor:
    # rounded once, as the kernel's FFMA: in float64 the product (24 x 24
    # bits) and the sum are exact for chain values in [2^-30, 2^5), so the
    # cast back to float32 is the step's only rounding
    return (x.double() * _FMA_A + _FMA_B).float()


_STEP = {
    "fma": _fma,
    "exp": lambda x: torch.exp(-x),
    "log": lambda x: torch.log(x + 1.5),
    "div": lambda x: torch.reciprocal(x + 1.5),
}


def _check(x: Tensor, n_iters: int, op: str) -> None:
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if int(n_iters) != n_iters or n_iters < 0:
        raise ValueError(f"n_iters must be an integer >= 0, got {n_iters!r}")
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"x must be a 2-D float32 tile, got {x.dtype} "
                         f"{tuple(x.shape)}")


@torch.no_grad()
def alu_chain_plain(x: Tensor, n_iters: int, op: str) -> Tensor:
    """:func:`alu_chain` in plain torch ops, on any device: the four chains
    as one (4, R, C) tensor, each rep one elementwise op (fma rounded
    once, as an FFMA)."""
    _check(x, n_iters, op)
    scales = torch.tensor([1.0 + 0.01 * k for k in range(CHAINS)],
                          dtype=torch.float32, device=x.device)
    xs = x[None] * scales[:, None, None]
    step = _STEP[op]
    for _ in range(n_iters * BODY_REPS):
        xs = step(xs)
    return ((xs[0] + xs[1]) + xs[2]) + xs[3]


def _launch(x: Tensor, n_iters: int, op: str) -> Tensor:
    from ._build import load_library

    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.numel() >= 2**31:
        raise ValueError(f"x has {x.numel()} elements; the kernel indexes "
                         "with 32-bit ints")
    out = torch.empty_like(x)
    lib = load_library()
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.qfa_alu_chain_f32(
            x.data_ptr(), out.data_ptr(), x.numel(), int(n_iters),
            OPS.index(op),
            dev.index if dev.index is not None else torch.cuda.current_device(),
            stream)
    if rc != 0:
        raise RuntimeError(
            f"CUDA alu_chain kernel launch failed: error {rc} "
            f"({lib.qfa_cuda_error_string(rc).decode()})")
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    return out


@torch.no_grad()
def alu_chain(x: Tensor, n_iters: int, op: str) -> Tensor:
    """``n_iters`` iterations of ``BODY_REPS`` reps of ``op`` ("fma": ``x *
    1.0000001 + 1e-7``, "exp": ``exp(-x)``, "log": ``log(x + 1.5)``,
    "div": ``1 / (x + 1.5)``) on ``CHAINS`` chains per element of the 2-D
    float32 tile ``x``; returns the chains' sum, shaped like ``x``. CPU
    tensors run :func:`alu_chain_plain`; a CUDA tensor launches the CUDA
    kernel on the current stream, or raises (contiguous, fewer than 2^31
    elements)."""
    _check(x, n_iters, op)
    if x.device.type == "cpu":
        return alu_chain_plain(x, n_iters, op)
    if x.device.type != "cuda":
        raise ValueError(f"alu_chain runs on cpu or cuda, not {x.device}")
    return _launch(x, n_iters, op)
