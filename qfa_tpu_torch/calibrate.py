"""The card's attainable rates, measured: products, memory reads and ALU
op classes.

    python -m qfa_tpu_torch.calibrate [--device cuda:N]

prints one JSON line with the card's name and power limit (``nvidia-smi``),
the f32 and bf16 matrix-product rates and the read rate of
:func:`calibrate_peaks`, and the ops/s per op class of
:func:`calibrate_alu`. Both functions are the counterparts of
``bench.calibrate_peaks`` and ``bench.calibrate_vpu`` and time with CUDA
events; nothing memoises a launch on the card, so the JAX code's
varied-input carries have no counterpart. Both raise on a CPU device and
where no card is visible: a calibration of the CPU is no peak of the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from .ops.alu_chain import BODY_REPS, CHAINS, OPS, alu_chain
from .utils.device import resolve_device

__all__ = ["ALU_ITERS", "ALU_SHAPE", "OPS_PER_REP", "alu_op_count",
           "alu_rates", "calibrate_alu", "calibrate_peaks", "card_info",
           "main"]

#: square product size and chain length of calibrate_peaks
MM_N = 4096
CHAIN = 8
#: the array calibrate_peaks reads: 1.0 GB of float32, 20x the 50 MB L2
READ_SHAPE = (131072, 1920)
#: the tile of calibrate_alu
ALU_SHAPE = (256, 1024)
#: (i1, i2) iteration counts per op, sized on an H100 (700 W) so that each
#: delta is 3-5 ms of CUDA-event time, well above the 2 ms floor at which
#: launch jitter stops mattering
ALU_ITERS = {"fma": (200, 4200), "exp": (50, 1050), "log": (20, 420),
             "div": (50, 1050)}
#: operations per rep: an fma is a multiply and an add
OPS_PER_REP = {"fma": 2.0, "exp": 1.0, "log": 1.0, "div": 1.0}
#: interleaved (i1, i2) pairs per op; the median delta is kept
ALU_PAIRS = 3


def card_info() -> dict:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (first card)."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, _, limit = line.rpartition(",")
    return {"name": name.strip(), "power_limit": limit.strip(), "nvidia_smi":
            line}


def _card(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"calibration measures a CUDA card, not {dev}: a "
                         "calibration of the CPU is no peak of the card")
    return dev


def _seconds_per_call(fn, n: int, dev: torch.device) -> float:
    """Seconds per call of ``fn`` over ``n`` back-to-back calls, by CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3 / n


def calibrate_peaks(device="cuda") -> tuple[float, float, float]:
    """The card's usable matrix-product and read rates, the counterpart of
    ``bench.calibrate_peaks``: a chain of ``CHAIN`` 4096^2 float32
    ``torch.matmul`` with TF32 off (full float32, set here and restored on
    return), the same with bfloat16 operands, float32 accumulation
    (cuBLAS's reduced-precision reductions off) and a bfloat16 output, and
    ``CHAIN`` column sums of a (131072, 1920) float32 array (1.0 GB, past
    the 50 MB L2). Returns ``(peak_tflops_f32, peak_tflops_bf16,
    peak_read_gbps)``."""
    dev = _card(device)
    with torch.cuda.device(dev):  # events on this card's stream
        g = torch.Generator(device=dev).manual_seed(7)
        a = torch.randn((MM_N, MM_N), generator=g, device=dev)
        b = torch.randn((MM_N, MM_N), generator=g, device=dev)
        matmul = torch.backends.cuda.matmul
        saved = (torch.get_float32_matmul_precision(),
                 matmul.allow_bf16_reduced_precision_reduction)
        try:
            torch.set_float32_matmul_precision("highest")  # TF32 off
            matmul.allow_bf16_reduced_precision_reduction = False
            y = torch.empty_like(a)
            t_mm = _seconds_per_call(lambda: torch.matmul(a, b, out=y),
                                     CHAIN, dev)
            ab, bb = a.bfloat16(), b.bfloat16()
            yb = torch.empty_like(ab)
            t_bf = _seconds_per_call(lambda: torch.matmul(ab, bb, out=yb),
                                     CHAIN, dev)
        finally:
            torch.set_float32_matmul_precision(saved[0])
            matmul.allow_bf16_reduced_precision_reduction = saved[1]
        del a, b, y, ab, bb, yb
        x = torch.randn(READ_SHAPE, generator=g, device=dev)
        acc = torch.empty((READ_SHAPE[1],), device=dev)
        t_rd = _seconds_per_call(lambda: torch.sum(x, dim=0, out=acc),
                                 CHAIN, dev)
        flops = 2 * MM_N**3
        return (flops / t_mm / 1e12, flops / t_bf / 1e12,
                x.numel() * x.element_size() / t_rd / 1e9)


def alu_op_count(op: str, i1: int, i2: int, elems: int) -> float:
    """Operations between the runs at ``i1`` and ``i2`` iterations
    (``bench.calibrate_vpu``'s count)."""
    return (i2 - i1) * BODY_REPS * CHAINS * OPS_PER_REP[op] * elems


def alu_rates(deltas: dict, elems: int) -> dict:
    """ops/s per op from the per-pair deltas in seconds: the median delta,
    ``None`` where it is not positive."""
    rates = {}
    for op, ds in deltas.items():
        delta = sorted(ds)[len(ds) // 2]
        rates[op] = None if delta <= 0 else \
            alu_op_count(op, *ALU_ITERS[op], elems) / delta
    return rates


def calibrate_alu(device="cuda") -> dict:
    """The card's usable ALU throughput per op class, the counterpart of
    ``bench.calibrate_vpu`` (the card has no VPU): the ``alu_chain``
    kernel over a (256, 1024) float32 tile, per op ``ALU_PAIRS``
    interleaved runs at ``i2`` and ``i1`` iterations (``ALU_ITERS``), each
    timed by CUDA events, and the median of the per-pair deltas, which
    cancels the launch and the tile's read and write. Returns ops/s for
    ``{"fma", "exp", "log", "div"}`` ("fma" counts the multiply and the
    add), ``None`` for a delta that is not positive."""
    dev = _card(device)
    with torch.cuda.device(dev):  # events on this card's stream
        g = torch.Generator(device=dev).manual_seed(17)
        x = 0.5 + 0.5 * torch.rand(ALU_SHAPE, generator=g, device=dev)
        for op in OPS:  # build the kernel library and warm up each op
            alu_chain(x, 8, op)
        torch.cuda.synchronize(dev)

        def seconds(n_iters, op):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            alu_chain(x, n_iters, op)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e-3

        deltas = {}
        for op in OPS:
            i1, i2 = ALU_ITERS[op]
            deltas[op] = [seconds(i2, op) - seconds(i1, op)
                          for _ in range(ALU_PAIRS)]
        return alu_rates(deltas, x.numel())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the CUDA device to calibrate (default cuda)")
    args = ap.parse_args(argv)
    f32, bf16, read = calibrate_peaks(args.device)
    alu = calibrate_alu(args.device)
    record = {
        "device": card_info(),
        "torch": torch.__version__,
        "peak_tflops_f32": f32,
        "peak_tflops_bf16": bf16,
        "peak_read_gbps": read,
        "alu_ops_per_s": alu,
        "alu_iters": ALU_ITERS,
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
