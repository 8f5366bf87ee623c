"""Contraction-depth probe: does a small-K product pay a fixed cost?

The training kernels' backward products are (K, TB)^T @ (K, P) -> (TB, P)
contractions of depth ntri = 36 (dw = S.G) and nh = 8 (du) at nh 8. This
tool times the ``contraction_probe`` kernel (``csrc/kdepth.cu``) for every
variant of ``ops.kdepth.VARIANTS``: operands resident in shared memory,
``--grid`` steps per launch, variants interleaved round-robin in every
round, ``--calls`` launches per timing window (a pool of left operands,
seed 7, one per call), CUDA events around each window, and the median
per-step time over ``--rounds``. If the time is flat in K (single8 ~
single128), a small contraction pays a fixed pass cost and the training
kernels should price it at the full depth; if it grows about linearly, the
cost is in the operations.

    python -m qfa_tpu_torch.tools.mxu_kdepth --out DIR [--rounds R]
        [--grid G] [--calls C]

writes ``DIR/kdepth.json`` and prints one line per variant and the
verdict. The counterpart of ``tools/mxu_kdepth.py``; it needs a CUDA card
and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..calibrate import calibrate_peaks, card_info
from ..ops.kdepth import KMAX, P, TB, VARIANTS, contraction_probe
from ..utils.device import resolve_device

__all__ = ["main", "make_record", "make_operands"]

RECORD_NAME = "kdepth.json"


def make_operands(calls: int, device) -> tuple:
    """The probe's operands from seed 7, as in ``tools/mxu_kdepth.py``: a
    pool of ``calls`` left operands (KMAX, TB) * 1e-3 and their transposes,
    the right operand r (KMAX, P) * 1e-3 and the block-diagonal r2
    (KMAX, 2P) = [[r[:36], 0], [0, r[36:44]]]."""
    rng = np.random.default_rng(7)
    l_np = [rng.standard_normal((KMAX, TB)).astype(np.float32) * 1e-3
            for _ in range(calls)]
    r_np = rng.standard_normal((KMAX, P)).astype(np.float32) * 1e-3
    r2_np = np.zeros((KMAX, 2 * P), np.float32)
    r2_np[0:36, :P] = r_np[0:36]
    r2_np[36:44, P:] = r_np[36:44]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ([put(x) for x in l_np], [put(x.T) for x in l_np], put(r_np),
            put(r2_np))


def make_record(times: dict, grid: int, tflops: float | None,
                device_info: dict) -> dict:
    """The probe's record from per-variant per-step times in seconds (one
    sample per round): the keys of ``tools/mxu_kdepth.py``'s record and
    its verdict (``k_scaling_128_over_8``, ``flat_in_k``: single128 takes
    under twice single8's time), plus the card's name and power limit.
    ``mxu_peak_tflops_f32`` keeps its JAX name and holds the card's
    calibrated float32 product rate."""
    record = {
        "what": "standalone contraction-depth probe of the training "
                "kernels' backward products (two (K,TB)^T@(K,P) "
                "contractions into (TB,P) planes, shared-memory-resident "
                "operands, per-grid-step times) on a CUDA card",
        "tb": TB, "p": P, "grid": grid,
        "variants": {},
        "mxu_peak_tflops_f32": None if tflops is None else round(tflops, 2),
        "device": device_info,
    }
    for name, k1, k2, vpu_k2 in VARIANTS:
        med = float(np.median(times[name]))
        flops = 2 * TB * P * (k1 + (k2 or 0))
        rec = {
            "k": ([k1] if k1 else []) + ([k2] if k2 is not None else []),
            "k2_on_vpu": vpu_k2,
            "us_per_step": round(med * 1e6, 3),
            "ns_per_spectrum_equiv": round(med / TB * 1e9, 2),
            "flops_per_step": flops,
            "samples_us": [round(x * 1e6, 3) for x in sorted(times[name])],
        }
        if tflops:
            rec["naive_peak_us"] = round(flops / (tflops * 1e12) * 1e6, 3)
        record["variants"][name] = rec
    t8 = record["variants"]["single8"]["us_per_step"]
    t128 = record["variants"]["single128"]["us_per_step"]
    record["k_scaling_128_over_8"] = round(t128 / t8, 3) if t8 else None
    record["flat_in_k"] = bool(t8 and t128 / t8 < 2.0)
    return record


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--grid", type=int, default=4096,
                    help="grid steps per launch")
    ap.add_argument("--calls", type=int, default=8,
                    help="launches per timing window")
    ap.add_argument("--out", required=True,
                    help=f"directory to write {RECORD_NAME} into")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise ValueError(f"the probe times a CUDA card, not {dev}")
    t0 = time.perf_counter()

    def stage(msg):
        print(f"[kdepth +{time.perf_counter() - t0:6.1f}s] {msg}",
              file=sys.stderr, flush=True)

    with torch.cuda.device(dev):
        l_pool, lt_pool, r, r2 = make_operands(args.calls, dev)
        for name, k1, k2, vpu_k2 in VARIANTS:  # build and warm up
            contraction_probe(l_pool[0], lt_pool[0], r, r2, k1=k1, k2=k2,
                              vpu_k2=vpu_k2, grid=args.grid)
        torch.cuda.synchronize(dev)
        stage("built; variants warmed up")

        def window(k1, k2, vpu_k2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for l, lt in zip(l_pool, lt_pool):
                contraction_probe(l, lt, r, r2, k1=k1, k2=k2, vpu_k2=vpu_k2,
                                  grid=args.grid)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e-3 / (args.calls * args.grid)

        times = {name: [] for name, _, _, _ in VARIANTS}
        for rnd in range(args.rounds):
            for name, k1, k2, vpu_k2 in VARIANTS:  # interleaved round-robin
                times[name].append(window(k1, k2, vpu_k2))
            stage(f"round {rnd + 1}/{args.rounds} done")
        stage("f32 peak calibration")
        tflops, _bf16, _read = calibrate_peaks(dev)

    record = make_record(times, args.grid, tflops, card_info())
    for name, rec in record["variants"].items():
        print(f"{name:>11}: {rec['us_per_step']:8.3f} us/step "
              f"({rec['ns_per_spectrum_equiv']:6.2f} ns/spectrum-equiv)")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, RECORD_NAME), "w") as fh:
        json.dump(record, fh, indent=1)
    print(json.dumps({k: v for k, v in record.items() if k != "variants"}))
    return record


if __name__ == "__main__":
    main()
