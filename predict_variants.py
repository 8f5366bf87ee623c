#!/usr/bin/env python3
"""Where the prediction kernels' time goes on the card: ``csrc/predict.cu``
(the warp body) or ``csrc/predict_tc.cu`` (the tensor-core body) with one
piece left out or changed per variant, timed on the survey sweep.

    python3 predict_variants.py [--body warp|tc|both] [NAME,...]

Run from the repository's root on a machine with an NVIDIA GPU and nvcc.
Each variant is the kernel's source with pieces of text replaced, built for
nh 8 only (all builds at once, each variant's registers and spills from
``ptxas -v`` printed); a variant whose text is no longer in the source is
reported and skipped. Every variant is timed, in turns over two rounds, on
the problem of ``chip_smoke.py``'s phase 18: the ``stats_only`` sweep of
1,474,560 SDSS spectra kept on the card as bfloat16 flux and error planes
(derived mask, zq column), and full output at 65,536 of them with bfloat16
planes and bfloat16 continuum/std (median of 3 calls by CUDA events, per
call). The warp body runs on the bfloat16 planes through its private
route, as the tensor-core body's float32 kernel would not. A variant that
leaves work out computes wrong results by construction; only its times
mean anything.
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
from qfa_tpu_torch.ops import infer_kernel as ik

_SRC = {"warp": "predict.cu", "tc": "predict_tc.cu"}


def _between(source: str, start: str, end: str) -> str:
    """The text of ``csrc/<source>`` from ``start`` to the end of ``end``
    (empty when either is gone: the variant is then reported and
    skipped)."""
    text = (_build.CSRC / source).read_text()
    i = text.find(start)
    j = text.find(end, i)
    return "" if i < 0 or j < 0 else text[i:j + len(end)]


_WARP_PRODUCTS = """    float fr[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) fr[i] = sF[i * kFRow + j];
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const float wi = w * fr[i];
#pragma unroll
      for (int k = 0; k <= i; ++k) acc[qfa::tri_idx(i, k)] += wi * fr[k];
      acc[NT + i] += u * fr[i];
    }
"""
_WARP_CHAIN = _between("predict.cu", "    const float e = at<P>(st, r.error + j);",
                       "    const float ql = delta * delta * dinv + m * "
                       "logf(d_safe);\n")
_TC_PIXEL = """        pixel<P, kMaskPlane, kDerived, kBlue>(a, st, rows.v[rs], q, j, tau0,
                                              c0f, beta, w, u, ql, m);
"""
_TC_PRODUCTS = _between("predict_tc.cu", "#pragma unroll\n    for (int nt = 0;"
                        " nt < S::TT; ++nt) {\n      float part[4]",
                        "      for (int e = 0; e < 4; ++e) acc[nt][e] += "
                        "part[e];\n    }\n")
#: the tc body with thread 0 of each block adding its clock's cycles in
#: each part of pass 1's item loop (in g_tc_phase[block])
_TC_STAMPS = [
    ("namespace {\n", "namespace {\n__device__ unsigned long long "
     "g_tc_phase[4096][4];\n"),
    ("  int stage = 0;\n", "  int stage = 0;\n  unsigned long long ph[4] = "
     "{0, 0, 0, 0};\n"),
    ("      cp_async_wait<0>();\n      __syncthreads();\n      if (c == "
     "c_first)", "      const unsigned long long t0 = clock64();\n      "
     "cp_async_wait<0>();\n      __syncthreads();\n      if (c == c_first)"),
    ("      cp_async_commit();\n      pass1<NH, P>(", "      cp_async_commit()"
     ";\n      const unsigned long long t1 = clock64();\n      ph[0] += t1 -"
     " t0;\n      pass1<NH, P>("),
    ("      stage ^= 1;\n    }\n", "      stage ^= 1;\n      ph[1] += "
     "clock64() - t1;\n    }\n    const unsigned long long t2 = clock64();"
     "\n"),
    ("    if (last_to_arrive(a.counters + tile, a.n_parts, &last))\n      "
     "finish<NH>(a, work, tile, full);\n", "    const bool fin = "
     "last_to_arrive(a.counters + tile, a.n_parts, &last);\n    const "
     "unsigned long long t3 = clock64();\n    ph[2] += t3 - t2;\n    if "
     "(fin) {\n      finish<NH>(a, work, tile, full);\n      ph[3] += "
     "clock64() - t3;\n    }\n"),
    ("  }\n  cp_async_wait<0>();\n}\n", "  }\n  if (threadIdx.x == 0)\n    "
     "for (int i = 0; i < 4; ++i) g_tc_phase[blockIdx.x % 4096][i] += "
     "ph[i];\n  cp_async_wait<0>();\n}\n"),
    ('extern "C" {\n', 'extern "C" {\nint qfa_tc_stamps(void* host, int '
     'reset) {\n  static unsigned long long zero[4096][4];\n  return '
     'static_cast<int>(reset ? cudaMemcpyToSymbol(g_tc_phase, zero, '
     'sizeof(zero)) : cudaMemcpyFromSymbol(host, g_tc_phase, '
     'sizeof(zero)));\n}\n'),
]
#: the parts the stamps time: per pass-1 step, per item, per finish
PHASES = ("wait for the step's copies, barrier and the next step's copies",
          "pass 1 (chain and products)", "the part's sums stored and the "
          "arrival", "finish")

#: body -> name -> (what it changes, [(text of the source, replacement)])
VARIANTS = {
    "warp": {
        "base": ("nothing", []),
        "chain_only": ("the products: one sum of w + u per pixel in place "
                       "of the K triangle and W", [
                           (_WARP_PRODUCTS, "    acc[0] += w + u;\n")]),
        "products_only": ("the chain: w, u and ql read from the Psi and mu "
                          "rows, m = 1", [
                              (_WARP_CHAIN, "    const float m = 1.0f;\n"
                               "    const float w = st[L.psi + j];\n"
                               "    const float u = st[L.mu + j];\n"
                               "    const float ql = w;\n")]),
        "no_logf": ("logf in ql (log d replaced by d)",
                    [("m * logf(d_safe)", "m * d_safe")]),
        "lb1": ("__launch_bounds__(256, 1): up to 255 registers", [(
            "__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")]),
        "lb3": ("__launch_bounds__(256, 3): at most 80 registers", [(
            "__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)")]),
    },
    "tc": {
        "base": ("nothing", []),
        "chain_only": ("pass 1's tensor-core products: w and u summed "
                       "into one column", [(_TC_PRODUCTS,
                                            "    for (int e = 0; e < 4; ++e)"
                                            " acc[0][e] += __uint_as_float("
                                            "wh[e]) + __uint_as_float("
                                            "uh[e]);\n")]),
        "products_only": ("the chain: w, u and ql read from the Psi and mu "
                          "rows, m = 1", [
                              (_TC_PIXEL, "        w = q.psi;\n        u = "
                               "q.mu;\n        ql = w;\n        m = 1.0f;\n"
                               )]),
        "no_logf": ("logf in ql (log d replaced by d)",
                    [("m * logf(d_safe)", "m * d_safe")]),
        "ieee_div": ("IEEE division m / d in place of div_pos",
                     [("const float dinv = div_pos(m, d_safe);",
                       "const float dinv = m / d_safe;")]),
        "lb3": ("kMinBlocks 3: at most 80 registers",
                [("constexpr int kMinBlocks = 2;",
                  "constexpr int kMinBlocks = 3;")]),
        "parts2": ("at most 2 parts of the pixel axis",
                   [("constexpr int kParts = 4;",
                     "constexpr int kParts = 2;")]),
        "m128": ("tiles of 128 spectra (512 threads)",
                 [("constexpr int kM = 64;", "constexpr int kM = 128;"),
                  ("constexpr int kMinBlocks = 2;",
                   "constexpr int kMinBlocks = 1;")]),
        "shell": ("all of pass 1's work: the ring's copies, barriers and "
                  "the finish alone", [(
                      "      pass1<NH, P>(a, L, smem + stage * L.stage, rows, "
                      "c, h, lane, tau0, c0f,\n                   beta, acc, "
                      "sq, sm);\n", "")]),
        "no_planes": ("the flux and error rows' copies", [(
            "  copy_row(reinterpret_cast<P*>(st + L.flux + r * L.slot),\n"
            "           static_cast<const P*>(a.flux) + rb, len, lane, "
            "before, after);\n  copy_row(reinterpret_cast<P*>(st + L.error"
            " + r * L.slot),\n           static_cast<const P*>(a.error) + "
            "rb, len, lane, before, after);\n", "")]),
        "c64": ("chunks of 64 pixels", [("constexpr int kCMax = 128;",
                                         "constexpr int kCMax = 64;")]),
        "cvt_split": ("the TF32 rounding by cvt.rna.tf32.f32 in place of "
                      "two integer operations (same results)", [(
                          "  return (__float_as_uint(x) + 0x1000u) & "
                          "0xffffe000u;", "  uint32_t r;\n  asm(\"cvt.rna."
                          "tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n"
                          "  return r;")]),
        "m32": ("tiles of 32 spectra (128 threads), 4 blocks per SM",
                [("constexpr int kM = 64;", "constexpr int kM = 32;"),
                 ("constexpr int kMinBlocks = 2;",
                  "constexpr int kMinBlocks = 4;")]),
        "stamps": ("nothing; clock stamps of each part of the tile loop",
                   _TC_STAMPS),
    },
}


def nh8_only(text: str) -> str:
    """A source of predict.cu or predict_tc.cu instantiated for nh 8 only."""
    return re.sub(r"    case (\d+): return (\w+)<\1\b",
                  lambda m: m[0] if m[1] == "8" else
                  f"    case {m[1]}: return cudaErrorInvalidValue; //", text)


def ptxas_report(log: str) -> str:
    """Registers and spill bytes (stores/loads) of each kernel in a
    variant's build log."""
    found, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            m = re.search(r"predict(_tc)?_kernelILi8E", entry[1])
            name = None if m is None else (
                f"predict{m[1] or ''}_kernel<"
                f"{'bf16' if 'bfloat16' in entry[1] else 'f32'}"
                f"{', flags' if 'Lb1E' in entry[1] else ''}>")
            if name:
                found[name] = ["?", "?"]
        elif name and "spill stores" in line:
            found[name][1] = "/".join(re.findall(r"(\d+) bytes spill", line))
        elif name and "registers" in line:
            found[name][0] = re.search(r"(\d+) registers", line)[1]
    return ", ".join(f"{k} {r} registers, spill {sp} B"
                     for k, (r, sp) in found.items())


def print_stamps(lib, fn, label) -> None:
    """The tc body's clock cycles per part of pass 1's item loop in one
    call of ``fn``, summed over the blocks' thread 0: per step (pass 1's
    chunks), per item (a tile's part) and per tile."""
    import ctypes

    import numpy as np

    lib.qfa_tc_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = np.zeros((4096, 4), np.uint64)
    if lib.qfa_tc_stamps(None, 1) != 0:
        raise RuntimeError("could not reset the stamps")
    out = fn()
    torch.cuda.synchronize()
    if lib.qfa_tc_stamps(buf.ctypes.data, 0) != 0:
        raise RuntimeError("could not read the stamps")
    n = out.ll.shape[0]
    tiles = -(-n // 64)
    steps = tiles * -(-1913 // lib.qfa_predict_tc_chunk())
    part_px = ctypes.c_int()
    items = tiles * lib.qfa_predict_tc_parts(1913, ctypes.byref(part_px))
    per = ((steps, "step"), (steps, "step"), (items, "item"), (tiles, "tile"))
    tot = buf.sum(axis=0).astype(np.float64)
    blocks = int((buf.sum(axis=1) > 0).sum())
    print(f"  stamps, {label}: {blocks} blocks, {tiles} tiles, {items} items;"
          " cycles " + ", ".join(f"{PHASES[i]} {tot[i] / per[i][0]:.0f} per "
                                 f"{per[i][1]}" for i in range(4)), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="?", default="",
                    help="comma-separated variants (default: all)")
    ap.add_argument("--body", default="both", choices=("warp", "tc", "both"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("predict_variants: no CUDA device", file=sys.stderr)
        return 1
    from qfa_tpu_torch.calibrate import card_info
    from qfa_tpu_torch.data.grid import make_grid
    from qfa_tpu_torch.ops.common import loglam_row

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    grid = make_grid(**cs.SDSS)
    params, mu = cs.seeded_params(grid, device)
    flux, error, zqc, keep = cs.sweep_survey(params, mu, grid, device)
    del keep
    kw = dict(loglam=loglam_row(grid.wav, device=device), derive_zabs=True)
    k = slice(0, cs.SWEEP_KEEP)
    sub = (flux[k], error[k], zqc[k])
    smi = card_info()["nvidia_smi"]
    print(f"{smi}; sweep of {cs.SWEEP_N} spectra (bf16 planes, stats_only), "
          f"full output at {cs.SWEEP_KEEP} (bf16 planes and outputs)",
          flush=True)
    bodies = ("warp", "tc") if args.body == "both" else (args.body,)
    with tempfile.TemporaryDirectory(prefix="predict_variants_") as tmp:
        runs = {}
        for body in bodies:
            table = VARIANTS[body]
            names = [n for n in (args.names.split(",") if args.names else
                                 table) if n in table]
            d = Path(tmp) / body
            d.mkdir()
            libs = ev.build_variants(_SRC[body], table, names, d, nh8_only)
            for name, lib in libs.items():
                print(f"built {body}/{name}: "
                      f"{ptxas_report((d / f'{name}.log').read_text())}",
                      flush=True)
                runs[body, name] = lib
        for rnd in range(2):
            for (body, name), lib in runs.items():
                _build._LIB = lib

                def sweep(body=body):
                    return ik._fused_predict_body(
                        body, params, mu, flux, error, zqc, None,
                        stats_only=True, **kw)

                def full(body=body):
                    return ik._fused_predict_body(
                        body, params, mu, *sub, None,
                        out_dtype=torch.bfloat16, **kw)

                try:
                    sweep()
                    full()
                    torch.cuda.synchronize()
                    ms_s = cs.time_cuda(sweep, 3)
                    ms_f = cs.time_cuda(full, 3)
                except Exception as exc:  # a variant that cannot launch
                    print(f"round {rnd} {body}/{name}: {exc}", flush=True)
                    continue
                print(f"round {rnd} {body:4s} {name:13s} sweep {ms_s!r} ms, "
                      f"full output {cs.SWEEP_KEEP} {ms_f!r} ms per call "
                      f"(changes: {VARIANTS[body][name][0]})", flush=True)
                if name == "stamps" and rnd == 0:
                    for label, fn in (("sweep", sweep),
                                      (f"full output {cs.SWEEP_KEEP}", full)):
                        print_stamps(lib, fn, label)
        _build._LIB = None
    if "tc" in bodies:
        ms = cs.time_cuda(lambda: ik._tc_table(params.F, 128), 20)
        print(f"the tc body's table (_tc_table, nh 8, Npix 1913): {ms!r} "
              "ms per call (CUDA events, median of 20)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
