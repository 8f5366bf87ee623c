#!/usr/bin/env python3
"""The contraction-depth probe kernel (``csrc/kdepth.cu``) in variants,
timed at the probe's shapes.

    python3 kdepth_variants.py [NAME,...]

Run from the repository's root on a machine with an NVIDIA GPU and nvcc.
First, for the library as built, pair36+8 at grid 4096: a call through
the wrapper and the bare C call, and each kernel's device time per launch
(``torch.profiler``). Then each variant is the kernel's source with pieces
of text replaced (all builds at once); a variant whose text is no longer
in the source is reported and skipped. Each is timed at TB 256, P 1920 and
grid 4096 for the probe variants in ``SHAPES``, in turns over two rounds,
with the steps in the chunks the variant's library picks, two ways (median
of 5 calls by CUDA events): per call from an idle device, the host's time
to launch included, as ``chip_smoke.py`` times every kernel; and on the
device, each call queued behind another. A variant that computes the same
function is held against the plain version at grid 3 first (max|kernel -
plain| / max|plain|); a variant that leaves work out computes wrong
results by construction, and only its times mean anything. Last, the
variant ``base`` times each probe variant with its steps in every chunk
count from 1 to 64, both ways, beside the library's choice.
"""

from __future__ import annotations

import argparse
import re
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
import epoch_variants as ev
from qfa_tpu_torch.ops import _build
from qfa_tpu_torch.ops import kdepth as kd

_PASSES = """      mma_tf32(acc[mt][nt], lo[mt], bh0, bh1);
      mma_tf32(acc[mt][nt], hi[mt], bl0, bl1);
"""
_SPLIT = "split(__fmul_rn(v[i], s), hi[mt][i], lo[mt][i]);"
_A_LOADS = """    const float2 x =
        *reinterpret_cast<const float2*>(aw + mt * 16 * SA + 8 * c);
    const float2 y =
        *reinterpret_cast<const float2*>(aw + (mt * 16 + 8) * SA + 8 * c);"""
_B_LOAD = """    const float4 b =
        *reinterpret_cast<const float4*>(bw + nt * 8 * SB + 16 * c);"""

_CVT = ("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
        """  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));
  return r;""")
_WN32 = [("constexpr int kBN = 128;", "constexpr int kBN = 64;"),
         ("constexpr int kWN = 64;", "constexpr int kWN = 32;"),
         ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 3;")]

#: name -> (what it changes, [(text of csrc/kdepth.cu, replacement)])
VARIANTS = {
    "base": ("nothing", []),
    "one_pass": ("the two small-term MMAs of each product: one TF32 pass "
                 "(wrong results)", [(_PASSES, "")]),
    "no_split": ("A's split: the scaled value as both parts, no rounding "
                 "or subtraction (wrong results)",
                 [(_SPLIT, "hi[mt][i] = lo[mt][i] = "
                   "__float_as_uint(__fmul_rn(v[i], s));")]),
    "mma_only": ("every shared-memory operand load and the split: the MMAs "
                 "on register values made from the step scale (wrong "
                 "results)",
                 [(_A_LOADS, "    const float2 x = make_float2(s, s + c), "
                   "y = make_float2(s - c, s * mt);"),
                  (_SPLIT, "hi[mt][i] = lo[mt][i] = __float_as_uint(v[i]);"),
                  (_B_LOAD, "    const float h = __uint_as_float(hi[0][0]);\n"
                   "    const float4 b = make_float4(h, h + nt, h + c, h);")]),
    "no_barrier": ("the per-step compiler barrier (same results)",
                   [('    asm volatile("" ::: "memory");\n', "")]),
    "cvt_split": ("the TF32 rounding by cvt.rna.tf32.f32 in place of two "
                  "integer operations (same results)", [_CVT]),
    "wn32": ("warp tiles of 32 x 32 in blocks of 64 x 64, 3 blocks per SM "
             "(same results)", _WN32),
    "wn32_cvt": ("wn32 and cvt_split: the first design (same results)",
                 [*_WN32, _CVT]),
    "wm64": ("warp tiles of 64 x 32 in blocks of 128 x 64 (same results)",
             [("constexpr int kBM = 64;", "constexpr int kBM = 128;"),
              ("constexpr int kBN = 128;", "constexpr int kBN = 64;"),
              ("constexpr int kWM = 32;", "constexpr int kWM = 64;"),
              ("constexpr int kWN = 64;", "constexpr int kWN = 32;")]),
}
#: variants that compute the same function as the kernel
SAME = ("base", "no_barrier", "cvt_split", "wn32", "wn32_cvt", "wm64")
#: the probe variants timed: all of them
SHAPES = tuple(v[0] for v in kd.VARIANTS)
#: the chunk counts S timed for the base variant: 1 to 64 (the kernel's
#: most)
SWEEP = 64


def build(names, tmp: Path) -> dict:
    """One library per variant of kdepth.cu, every nvcc started at once."""
    return ev.build_variants("kdepth.cu", VARIANTS, names, tmp)


def times(run) -> tuple:
    """(per call, on the device) in ms: the median of 5 calls by CUDA
    events from an idle device, host time included (``time_cuda``), and
    of 5 calls each queued behind another (``time_cuda_queued``)."""
    return cs.time_cuda(run, 5), cs.time_cuda_queued(run, 5)


def sweep_chunks(lib, ops, variants) -> None:
    """Each probe variant at the probe's grid with its steps in S = 1 to
    64 chunks, per call and on the device (ms), beside the library's S."""
    index = torch.cuda.current_device()
    for shape in SHAPES:
        k1, k2, vpu_k2 = variants[shape]
        picked = kd._chunks(lib, (kd.TB, kd.P, k1, k2 or 0, kd._MODE[vpu_k2],
                                  cs.KDEPTH_GRID), index)
        row = []
        for s in range(1, SWEEP + 1):
            ms, dev = times(lambda: kd._launch(
                *ops, k1, k2, vpu_k2, cs.KDEPTH_GRID, chunks=s))
            row.append(f"{s} {ms:.4f}/{dev:.4f}")
        print(f"chunks {shape} (library: {picked}; S per call/device ms): "
              + ", ".join(row), flush=True)


def host_and_device(ops, variants) -> None:
    """pair36+8 at the probe's grid: a call and the bare C call (arguments
    and partials ready) by CUDA events, and each kernel's device time per
    launch (``torch.profiler``)."""
    lib = _build.load_library()
    k1, k2, vpu_k2 = variants["pair36+8"]
    l, lt, r, r2 = ops
    index, stream = _build.device_and_stream(l.device)
    variant = (kd.TB, kd.P, k1, k2, kd._MODE[vpu_k2], cs.KDEPTH_GRID)
    chunks = kd._chunks(lib, variant, index)
    out = torch.empty((kd.TB, kd.P), device=l.device)
    part = torch.empty((chunks, kd.TB, kd.P), device=l.device)
    args = (*(t.data_ptr() for t in (l, lt, r, r2, out, part)), part.numel(),
            kd.KMAX, *variant, chunks, index, stream)

    def call():
        return kd.contraction_probe(*ops, k1=k1, k2=k2, vpu_k2=vpu_k2,
                                    grid=cs.KDEPTH_GRID)

    call_ms = times(call)
    bare_ms = times(lambda: lib.qfa_kdepth_f32(*args))
    _, by_name, _, busy, counts = cs.profile_run(
        lambda: [call() for _ in range(10)])
    per = ", ".join(f"{m[0]} {v * 1e3 / counts[k]:.4f} ms"
                    for k, v in (by_name or {}).items()
                    if (m := re.search(r"kdepth_\w*kernel", k)))
    print(f"pair36+8, {chunks} chunks: a call {call_ms[0]:.4f} ms per call, "
          f"{call_ms[1]:.4f} on the device; the bare C call {bare_ms[0]:.4f} "
          f"/ {bare_ms[1]:.4f}; per launch (torch.profiler, 10 calls): "
          f"{per or 'no device events'}; busy {busy}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="?", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all)")
    names = ap.parse_args(argv).names.split(",")
    if not torch.cuda.is_available():
        print("kdepth_variants: no CUDA device", file=sys.stderr)
        return 1
    from qfa_tpu_torch.calibrate import card_info
    from qfa_tpu_torch.tools import mxu_kdepth

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    pool_l, pool_lt, r, r2 = mxu_kdepth.make_operands(1, device)
    ops = (pool_l[0], pool_lt[0], r, r2)
    variants = {v[0]: v[1:] for v in kd.VARIANTS}
    index = torch.cuda.current_device()
    print(f"{card_info()['nvidia_smi']}; TB {kd.TB}, P {kd.P}, grid "
          f"{cs.KDEPTH_GRID}", flush=True)
    host_and_device(ops, variants)
    with tempfile.TemporaryDirectory(prefix="kdepth_variants_") as tmp:
        libs = build(names, Path(tmp))
        for name in libs:  # ptxas: each probe variant's registers, spills
            kernel = "?"
            for line in (Path(tmp) / f"{name}.log").read_text().splitlines():
                m = re.search(r"Compiling entry function '\w*kdepth_kernel"
                              r"ILi(\d+)ELi(\d+)ELi(\d)", line)
                if m:
                    kernel = "k1 {} k2 {} mode {}".format(*m.groups())
                elif kernel != "?" and ("registers" in line or "spill" in line):
                    print(f"  {name} {kernel}: {line.strip()}", flush=True)
                    if "registers" in line:
                        kernel = "?"
        try:
            for rnd in range(2):
                for name, lib in libs.items():
                    _build._LIB = lib
                    parts = []
                    for shape in SHAPES:
                        k1, k2, vpu_k2 = variants[shape]
                        kw = dict(k1=k1, k2=k2, vpu_k2=vpu_k2)
                        check = ""
                        if name in SAME and rnd == 0:
                            got = kd.contraction_probe(*ops, **kw, grid=3)
                            want = kd.contraction_probe_plain(*ops, **kw,
                                                              grid=3)
                            rel = float((got - want).abs().max()) / float(
                                want.abs().max())
                            check = f", rel {rel:.2e} at grid 3"
                        chunks = kd._chunks(lib, (kd.TB, kd.P, k1, k2 or 0,
                                                  kd._MODE[vpu_k2],
                                                  cs.KDEPTH_GRID), index)
                        ms, dev = times(lambda: kd.contraction_probe(
                            *ops, **kw, grid=cs.KDEPTH_GRID))
                        parts.append(f"{shape} {ms:.4f} / {dev:.4f} ms "
                                     f"({chunks} chunks, "
                                     f"{ms / cs.KDEPTH_GRID * 1e3:.4f} / "
                                     f"{dev / cs.KDEPTH_GRID * 1e3:.4f} us "
                                     f"per step{check})")
                    print(f"round {rnd} {name:10s} per call / on the device: "
                          + "; ".join(parts)
                          + f" (changes: {VARIANTS[name][0]})", flush=True)
            if "base" in libs:
                _build._LIB = libs["base"]
                sweep_chunks(libs["base"], ops, variants)
        finally:
            _build._LIB = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
