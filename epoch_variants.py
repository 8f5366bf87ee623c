#!/usr/bin/env python3
"""Where the epoch kernel's time goes on the card: ``csrc/epoch.cu`` with one
piece left out per variant, or with timestamps, timed on phase 9's problem.

    python3 epoch_variants.py [NAME,...]

Run from the repository's root on a machine with an NVIDIA GPU and nvcc.
Each variant is the kernel's source with pieces of text replaced, built for
nh 8 only (all builds at once); a variant whose text is no longer in the
source is reported and skipped. Each is timed on one epoch of 65,536
SDSS-width spectra at batch 500 (bf16 operands, derived layout; the problem
of ``chip_smoke.py``'s phase 9): the epoch with the early launch and with
each kernel launched alone (CUDA events), and each kernel's device time per
launch when alone (``torch.profiler``). A variant that leaves work out
computes wrong results by construction; only its times mean anything. The
variant ``stamps`` records the GPU's global timer at the phase boundaries
of every forward and backward block of the last batch (kernels alone) and
prints each phase's median and 90th percentile over the blocks.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from qfa_tpu_torch.ops import _build, epoch_kernel

_STAMP = ("namespace {\n", "namespace {\n__device__ unsigned long long "
          "g_stamp[2][8192][8];\n__device__ __forceinline__ void stamp(int k, "
          "int i) {\n  if (threadIdx.x == 0) {\n    unsigned long long t;\n    "
          "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n    "
          "g_stamp[k][blockIdx.y * gridDim.x + blockIdx.x][i] = t;\n  }\n}\n")


def _at(text, k, i, after=True):
    """Put stamp(k, i) after (or before) whole lines of the source."""
    s = f"  stamp({k}, {i});\n"
    return (text, text + s) if after else (text, s + text)


#: name -> (what it leaves out, [(text of csrc/epoch.cu, replacement)])
VARIANTS = {
    "base": ("nothing", []),
    "f_prologue": ("all of the forward after its plane loads", [(
        "  pdl_wait();  // the parameters come from the previous batch's "
        "update\n", "  pdl_wait();\n  if (a.npix > 0) return;\n")]),
    "f_nochain": ("the forward's elementwise chain", [(
        "      if (p < a.npix && r < nr) {\n        const Pix x = "
        "pixel_terms(a, in[step]",
        "      if (false) {\n        const Pix x = pixel_terms(a, in[step]")]),
    "f_noprod": ("the forward's products", [(
        "for (int j = 0; j < kWarpPix; ++j) {",
        "for (int j = 0; j < 0; ++j) {")]),
    "f_notables": ("the forward's Gram and F tables", [(
        "    if (lane < kWarpPix) {  // the warp's H rows",
        "    if (false) {  // the warp's H rows")]),
    "f_nofinish": ("the forward's per-row finish and its arrival counter", [(
        "if (!last_to_arrive(a.counters + blockIdx.y, gridDim.x, &last)) "
        "return;", "return;")]),
    "b_prologue": ("all of the backward after its plane loads", [(
        "  pdl_wait();  // S and alpha come from this batch's forward\n",
        "  pdl_wait();\n  if (a.npix > 0) return;\n")]),
    "b_tables": ("all of the backward after its S and alpha tables", [(
        "#pragma unroll 1\n  for (int tile = 0; tile < kBwdTiles; ++tile) {",
        "  if (a.npix > 0) return;\n#pragma unroll 1\n  for (int tile = 0; "
        "tile < kBwdTiles; ++tile) {")]),
    "b_nodw": ("the backward's dw and du", [(
        "    for (int t = 0; t < NT; ++t) {\n      const float gv = "
        "gt_sm[t][lane];", "    for (int t = 0; t < 0; ++t) {\n      const "
        "float gv = gt_sm[t][lane];")]),
    "b_nochain": ("the backward's elementwise chain", [(
        "const Pix x =\n            pixel_terms(a, in[j], p, psi_p, "
        "omega_p, tau0, c0, beta);",
        "Pix x; x.m = in[j].e; x.w = in[j].d; x.u = in[j].e; "
        "x.q = in[j].d; x.dinv = in[j].e; x.amp = 1.0f; x.zdep = in[j].z; "
        "x.root = in[j].z; x.exp_neg = 1.0f; x.zp1b = 1.0f; "
        "x.log_zp1 = in[j].z; x.d_safe = 1.0f;")]),
    "b_nodg": ("the backward's dG accumulation", [(
        "for (int t = 0; t < NT; ++t) acc[t] += s_sm[r][t] * wo;",
        "for (int t = 0; t < 0; ++t) acc[t] += s_sm[r][t] * wo;")]),
    "u_prologue": ("all of the update", [(
        "  pdl_wait();\n  const bool apply = mode == UPD_APPLY;\n",
        "  pdl_wait();\n  if (a.npix > 0) return;\n"
        "  const bool apply = mode == UPD_APPLY;\n")]),
    "stamps": ("nothing; timestamps at the phase boundaries", [
        _STAMP,
        ("  pdl_launch_dependents();\n  if (tid < nr) row_sm[tid]",
         "  pdl_launch_dependents();\n  stamp(0, 0);\n  if (tid < nr) "
         "row_sm[tid]"),
        _at("  pdl_wait();  // the parameters come from the previous batch's "
            "update\n", 0, 1),
        _at("  __syncthreads();  // this batch's tau0, c0, beta\n", 0, 2),
        _at("  __syncthreads();  // every warp is done with xs\n", 0, 3),
        _at("  if (!last_to_arrive(a.counters + blockIdx.y, gridDim.x, "
            "&last)) return;\n", 0, 4),
        ("    a.alpha[static_cast<size_t>(r0 + r) * NH + b] = alpha_s[r][b];"
         "\n  }\n}", "    a.alpha[static_cast<size_t>(r0 + r) * NH + b] = "
         "alpha_s[r][b];\n  }\n  __syncthreads();\n  stamp(0, 5);\n}"),
        ("  pdl_launch_dependents();\n  for (int k = tid; k < nr; k += "
         "kBwdThreads)", "  pdl_launch_dependents();\n  stamp(1, 0);\n  for "
         "(int k = tid; k < nr; k += kBwdThreads)"),
        _at("  pdl_wait();  // S and alpha come from this batch's forward\n",
            1, 1),
        _at("#pragma unroll 1\n  for (int tile = 0; tile < kBwdTiles; "
            "++tile) {", 1, 2, after=False),
        ("        out[static_cast<size_t>(k) * a.npix] = s;\n      }\n    }"
         "\n  }\n}", "        out[static_cast<size_t>(k) * a.npix] = s;\n"
         "      }\n    }\n    stamp(1, 3 + tile);\n  }\n}"),
        ('extern "C" {\n', 'extern "C" {\nint qfa_epoch_stamps(void* host) {\n'
         '  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamp, '
         'sizeof(g_stamp)));\n}\n'),
    ]),
}
#: the phases between the stamps, by kernel
PHASES = {
    "forward": ("start to the plane loads' issue", "the previous batch's "
                "scalar step", "the sub-tile loop", "warp sums, partials, "
                "arrival", "the last block's sum and finish"),
    "backward": ("start to the plane loads' issue", "S and alpha tables",
                 "pixel tile 0 (G and F table, dw, du, rows, sums, stores)",
                 "pixel tile 1"),
}
STAGES = ("forward", "backward", "update")


def nh8_only(text: str) -> str:
    """A source of epoch.cu or step.cu instantiated for nh 8 only."""
    return re.sub(r"    case (\d+): return run<\1>",
                  lambda m: m[0] if m[1] == "8" else
                  f"    case {m[1]}: return cudaErrorInvalidValue; //", text)


def build(names, tmp: Path) -> dict:
    """One library per variant, every nvcc started at once."""
    return build_variants("epoch.cu", VARIANTS, names, tmp, nh8_only)


def build_variants(source: str, table: dict, names, tmp: Path,
                   finish=None) -> dict:
    """{name: library} of the variants ``names`` of ``csrc/<source>``: its
    text with each (old, new) of ``table[name][1]`` replaced once, then
    ``finish(text)`` if given, every nvcc started at once
    (:func:`build_sources`). A variant whose text is no longer in the
    source (after its earlier replacements) is reported and skipped."""
    src = (_build.CSRC / source).read_text()
    texts = {}
    for name in names:
        text = src
        for old, new in table[name][1]:
            if old not in text:
                print(f"variant {name}: text not in {source}: "
                      f"{old[:60]!r}", flush=True)
                break
            text = text.replace(old, new, 1)
        else:
            texts[name] = finish(text) if finish else text
    return build_sources(texts, tmp)


def build_sources(texts: dict, tmp: Path) -> dict:
    """{name: library} of the kernel sources {name: text}, every nvcc
    started at once beside csrc's headers (each one's output, with ptxas's
    report, in ``tmp / f"{name}.log"``); a build that fails is reported
    and left out."""
    for header in _build.CSRC.glob("*.cuh"):
        (tmp / header.name).write_text(header.read_text())
    procs = {}
    for name, text in texts.items():
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(tmp / f"lib{name}.so"), str(tmp / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        (tmp / f"{name}.log").write_text(out)
        if proc.returncode:
            print(f"variant {name}: nvcc failed:\n{out[-2000:]}", flush=True)
            continue
        lib = ctypes.CDLL(str(tmp / f"lib{name}.so"))
        for fn, (argtypes, restype) in _build.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def print_stamps(lib, run, grids) -> None:
    """Each phase's median and 90th percentile over the last batch's
    blocks, kernels alone."""
    epoch_kernel.EARLY_LAUNCH = False
    try:
        run()
        torch.cuda.synchronize()
    finally:
        epoch_kernel.EARLY_LAUNCH = True
    buf = np.zeros((2, 8192, 8), np.uint64)
    lib.qfa_epoch_stamps.argtypes = [ctypes.c_void_p]
    if lib.qfa_epoch_stamps(buf.ctypes.data) != 0:
        raise RuntimeError("could not read the timestamps")
    for k, (kern, blocks) in enumerate(grids.items()):
        t = buf[k, :blocks].astype(np.int64)
        us = (t - t[:, 0].min()) / 1e3
        print(f"  stamps, {kern} ({blocks} blocks): starts over "
              f"{us[:, 0].max():.2f} us; " + "; ".join(
                  f"{PHASES[kern][i]} {np.median(d):.2f} us "
                  f"(p90 {np.quantile(d, 0.9):.2f})"
                  for i in range(len(PHASES[kern]))
                  for d in [(t[:, i + 1] - t[:, i])[t[:, i + 1] >= t[:, i]]
                            / 1e3] if d.size)
              + f"; last block ends at {us.max():.2f} us", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="?", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all)")
    names = ap.parse_args(argv).names.split(",")
    if not torch.cuda.is_available():
        print("epoch_variants: no CUDA device", file=sys.stderr)
        return 1
    from qfa_tpu_torch.calibrate import card_info
    from qfa_tpu_torch.data.grid import make_grid
    from qfa_tpu_torch.train import adam, pick_tiling

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    grid = make_grid(**cs.SDSS)
    params, mu = cs.seeded_params(grid, device)
    n, batch = 65536, 500
    n_batches = -(-n // batch)
    data = cs.pad_rows(cs.train_problem(grid, params, mu, n, cs.SEED + 41),
                       n_batches * batch - n)
    tb, _ = pick_tiling(batch)
    zq, _, kw = cs.layout(grid, data, "derived")
    st = adam.init(params)
    perm = torch.randperm(n_batches * batch // tb,
                          generator=torch.Generator().manual_seed(cs.SEED))
    kw.update(epoch=0, n_batches=n_batches, tile_batch=tb, mxu_bf16=True)
    grids = {"forward": -(-grid.npix // 256) * -(-batch // 8),
             "backward": -(-grid.npix // 64) * -(-batch // 32)}

    def run():
        return epoch_kernel.fused_train_epoch(
            params, st.m, st.v, data["delta"], data["error"], zq, perm, **kw)

    print(f"{card_info()['nvidia_smi']}; one epoch of {n} spectra, batch "
          f"{batch}", flush=True)
    with tempfile.TemporaryDirectory(prefix="epoch_variants_") as tmp:
        libs = build(names, Path(tmp))
        for rnd in range(2):
            for name, lib in libs.items():
                _build._LIB = lib
                try:
                    run()
                    ms = cs.time_cuda(run, 5)
                    epoch_kernel.EARLY_LAUNCH = False
                    ms_alone = cs.time_cuda(run, 3)
                    _, by_name, _, _, counts = cs.profile_run(run)
                finally:
                    epoch_kernel.EARLY_LAUNCH = True
                us = {}
                for k, v in (by_name or {}).items():
                    m = re.search(r"(\w+)_kernel", k)
                    if m and m[1] in STAGES:
                        us[m[1]] = v * 1e6 / counts[k]
                print(f"round {rnd} {name:11s} epoch {ms!r} ms, kernels "
                      f"alone {ms_alone!r} ms: " + ", ".join(
                          f"{k} {v:.2f}" for k, v in us.items())
                      + f" us per launch (leaves out: {VARIANTS[name][0]})",
                      flush=True)
                if name == "stamps" and rnd == 0:
                    print_stamps(lib, run, grids)
        _build._LIB = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
