#!/usr/bin/env python3
"""The step kernels (``csrc/step.cu``) in variants, timed on ``chip_smoke.py``'s
phase 12 problem.

    python3 step_variants.py [NAME,...]

Run from the repository's root on a machine with an NVIDIA GPU and nvcc.
Each variant is the kernels' source with pieces of text replaced, built for
nh 8 only (all builds at once); a variant whose text is no longer in the
source is reported and skipped. Each is timed at SDSS width and batch 500,
in turns over two rounds: the call by CUDA events (early launch on, as
trained) and each kernel's device time per call when launched alone
(``torch.profiler``). A variant that computes the same function is held
against the plain version first (loss rel, max|kernel - plain| / max|plain|
of the gradients); a variant that leaves work out computes wrong results by
construction, and only its times mean anything. Then, for the kernels as
they are, where the wrapper's host time goes: a call and the bare C call
(its arguments ready) by CUDA events, and the host time of the wrapper's
parts in a warm loop.
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
from qfa_tpu_torch.ops import _build, fused_step

_FINISH_THREAD = '''  if (tid < nr) {  // one thread per row: Cholesky, solves, NLL
    const float* rt = tot + tid * NV;'''
#: the forward's per-row finish with one warp per row (rows warp, warp +
#: 4): every lane factorizes and solves, lane b writes column b of S
_FINISH_WARP = '''  for (int r = warp; r < nr; r += kFwdWarps) {  // one warp per row
    const float* rt = tot + r * NV;
    float k_tri[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) k_tri[t] = rt[t];
#pragma unroll
    for (int i = 0; i < NH; ++i) k_tri[qfa::tri_idx(i, i)] += 1.0f;
    float Lr[NH][NH], rd[NH];
    qfa::chol_rdiag<NH>(k_tri, Lr, rd);
    float wv[NH], y[NH], al[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) wv[i] = rt[NT + i];
    qfa::solve_lower_rdiag<NH>(Lr, rd, wv, y);
    qfa::solve_upper_rdiag<NH>(Lr, rd, y, al);
    if (lane == 0) {
      float logdet = 0.0f, yy = 0.0f;
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        logdet += logf(Lr[i][i]);
        yy += y[i] * y[i];
      }
      float* rs = a.rowstat + static_cast<size_t>(r0 + r) * kRowStat;
      rs[0] = 0.5f * (rt[NT + NH] - yy + rt[NT + NH + 1] * kLog2Pi +
                      2.0f * logdet);
      rs[1] = rt[NT + NH + 2] > 0.5f ? 1.0f : 0.0f;
    }
    if (lane < NH) {
      const int b = lane;
      float col[NH], alb = 0.0f;
      qfa::kinv_column_rdiag<NH>(Lr, rd, b, col);
#pragma unroll
      for (int i = 0; i < NH; ++i) alb = i == b ? al[i] : alb;
      float* s = a.S + static_cast<size_t>(r0 + r) * NT;
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        if (i >= b)
          s[qfa::tri_idx(i, b)] = (i == b ? 0.5f : 1.0f) * (col[i] + al[i] * alb);
      }
      a.alpha[static_cast<size_t>(r0 + r) * NH + b] = alb;
    }
  }
  if (nr > 0) return;
  {
    const float* rt = tot;'''

#: name -> (what it changes, [(text of csrc/step.cu, replacement)])
VARIANTS = {
    "base": ("nothing", []),
    "warp_finish": ("the forward's per-row finish: one warp per row, every "
                    "lane factorizing (same results)",
                    [(_FINISH_THREAD, _FINISH_WARP)]),
    "f_nofinish": ("the forward's per-row finish and its arrival counter "
                   "(wrong results)", [(
                       "  if (!last_to_arrive(a.counters + blockIdx.x, "
                       "gridDim.y, &last)) return;", "  return;")]),
}
#: variants that compute the same function as the kernels
SAME = ("base", "warp_finish")
STAGES = ("forward", "backward", "finish")


def build(names, tmp: Path) -> dict:
    """One library per variant of step.cu, every nvcc started at once."""
    return ev.build_variants("step.cu", VARIANTS, names, tmp, ev.nh8_only)


def host_parts(params, batch) -> None:
    """A call and the bare C call by CUDA events; the wrapper's parts'
    host time in a warm loop (host clock, nothing launched)."""
    import time

    def host_us(fn, n=2000):
        for _ in range(50):
            fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    lib = _build.load_library()
    dev = batch.delta.device
    F, psi, omega, tau0, c0, beta = fused_step._param_tensors(params)
    npix, nh = F.shape
    nb, b = omega.shape[0], batch.delta.shape[0]
    n_out = npix * nh + 2 * npix + nb + 5
    index, stream = _build.device_and_stream(dev)
    scratch = fused_step._scratch(lib, (index, stream), (b, npix, nb, nh),
                                  dev)[3]
    res = torch.empty((n_out,), dtype=torch.float32, device=dev)
    args = (*(t.data_ptr() for t in (batch.delta, batch.error, batch.zabs)),
            batch.zabs.shape[1], batch.mask.data_ptr(),
            batch.weight.data_ptr(),
            *(t.data_ptr() for t in (F, psi, omega, tau0, c0, beta)),
            *fused_step.tau_law_abc("becker"), b, npix, nb, nh, *scratch,
            res.data_ptr(), 1, index, stream)
    call = cs.time_cuda(lambda: fused_step.fused_loss_grads(params, batch),
                        50)
    bare = cs.time_cuda(lambda: lib.qfa_step_f32(*args), 50)
    parts = {
        "shape checks": lambda: fused_step._check_batch(F, psi, omega,
                                                        batch),
        "type, layout and device checks": lambda: [
            (t.dtype, t.is_contiguous(), t.get_device())
            for t in (*batch, F, psi, omega, tau0, c0, beta)],
        "device index and raw stream (device_and_stream)":
            lambda: _build.device_and_stream(dev),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "output allocation": lambda: torch.empty(
            (n_out,), dtype=torch.float32, device=dev),
    }
    print(f"host: a call {call * 1e3:.2f} us, the bare C call with its "
          f"arguments ready {bare * 1e3:.2f} us (CUDA events, median of "
          "50); in a warm loop: " + ", ".join(
              f"{k} {host_us(fn):.2f} us" for k, fn in parts.items()),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="?", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all)")
    names = ap.parse_args(argv).names.split(",")
    if not torch.cuda.is_available():
        print("step_variants: no CUDA device", file=sys.stderr)
        return 1
    from qfa_tpu_torch.calibrate import card_info
    from qfa_tpu_torch.data.grid import make_grid

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    grid = make_grid(**cs.SDSS)
    params, mu = cs.seeded_params(grid, device)
    batch = cs.step_batch(cs.train_problem(grid, params, mu, 500,
                                           cs.SEED + 51))
    want = fused_step.fused_loss_grads_plain(params, batch)

    def run():
        return fused_step.fused_loss_grads(params, batch)

    print(f"{card_info()['nvidia_smi']}; one step at SDSS width, batch 500",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="step_variants_") as tmp:
        libs = build(names, Path(tmp))
        try:
            for rnd in range(2):
                for name, lib in libs.items():
                    _build._LIB = lib
                    got = run()
                    torch.cuda.synchronize()
                    check = ""
                    if name in SAME:
                        rel = cs.grad_rel(got, want)
                        loss = abs(float(got.loss_sum) - float(want.loss_sum)) \
                            / abs(float(want.loss_sum))
                        check = (f"; loss rel {loss:.2e}, grads rel "
                                 f"{max(rel.values()):.2e}")
                    ms = cs.time_cuda(run, 50)
                    fused_step.EARLY_LAUNCH = False
                    try:
                        _, by_name, _, _, counts = cs.profile_run(
                            lambda: [run() for _ in range(20)])
                    finally:
                        fused_step.EARLY_LAUNCH = True
                    us = {}
                    for k, v in (by_name or {}).items():
                        m = re.search(r"(\w+)_kernel", k)
                        if m and m[1] in STAGES:
                            us[m[1]] = v * 1e6 / counts[k]
                    print(f"round {rnd} {name:12s} call {ms * 1e3:.2f} us "
                          "(CUDA events); kernels alone: " + ", ".join(
                              f"{k} {v:.2f}" for k, v in us.items())
                          + f", sum {sum(us.values()):.2f} us{check} "
                          f"(changes: {VARIANTS[name][0]})", flush=True)
        finally:
            _build._LIB = None
            fused_step._SCRATCH.clear()
    host_parts(params, batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
