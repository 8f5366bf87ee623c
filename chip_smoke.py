#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs the port's prediction and serving path, its training paths and its
measurement path once on the card, at the full width of the SDSS model the
repository ships (Npix 1913, Nb 720, Nh 8), with parameters and spectra
made from a seed:

1. device: requires CUDA; prints the card's name and power limit
   (``nvidia-smi``); turns TF32 off for matmuls and cuDNN, so the plain
   torch version runs in full fp32;
2. build: compiles the CUDA kernels from ``qfa_tpu_torch/csrc`` with nvcc;
   prints the build time, each kernel's registers and spills, and per nh,
   flux/error type (float32, bfloat16) and flags (the other planes' and
   the outputs' types read at run time, or all float32) the prediction
   kernel's registers, spills, dynamic shared memory and resident blocks
   per SM in both of its modes;
3. kernel against its plain version on the same CUDA tensors, within the
   tolerances of the CPU parity tests, at SDSS width (4096 spectra) and
   DESI width (Npix 9243, Nb 2238; 512 spectra), in each mode of the path;
   every nh 1-10 at SDSS (512 spectra) and DESI width (128); n = 1 and
   n = 301 (a part tile); and, bitwise, a second launch on the same input
   and rows 0-63 and row 1000 predicted alone against the 4096 batch;
   then the bfloat16 modes at SDSS (512 spectra) and DESI width (128), nh
   1, 8 and 10, in both modes, full output and stats_only: bf16
   flux/error, bf16 mask and zabs planes, and all four, each against the
   plain version on the same planes, bitwise against the float32 kernel
   on the planes upcast, and rows 0-63 alone bitwise; and
   ``out_dtype=bfloat16``, its planes bitwise the float32 call's cast and
   its float32 stats bitwise unchanged;
4. main path: ``qfa_tpu_torch.cli.main(["--type", "predict", ...])`` on
   2048 spectra written to disk, checked against the plain path on the
   CPU; the CLI must have read them with the native npz reader
   (``qfa_tpu_torch.native``), whose arrays must equal the Python pool's
   bitwise; both readers' seconds on the same files;
5. serving: ``QFAPredictor(device="cuda")`` behind its HTTP server;
6. times of the kernel and the plain version at 65536 spectra (a survey
   sweep), 8192 (the predict CLI's chunk), 64 (serving's max_batch) and 1,
   full output and stats_only, each with its GB/s and its share of its
   bound;
7. the epoch kernel against its plain version on the same CUDA tensors:
   SDSS width (4096 spectra, batch 512, 2 epochs) and DESI width (512
   spectra, 1 epoch), derived and plane layouts, and the training CLI's
   shape (2048 spectra padded to 2500 rows, batch 500, tile 4, 4
   epochs, derived layout), bf16 operands off and on, float32 and (at
   SDSS and DESI width) bfloat16 delta/error planes; 3 epochs in one
   call against 3 chained calls, and inert padding rows, both bitwise;
8. training main path: ``cli.main(["--type", "train", ..., "--device",
   "cuda"])`` on 2048 spectra written to disk, held against
   ``fit_fused(plain=True)`` called directly on the same loaded data and
   seed, then the same pair with ``TRAIN.BF16_PLANES``; the CLI once
   more with ``TRAIN.ENGINE xla`` (``train.fit``, no epoch kernel); then
   ``--type predict`` from the trained model through the prediction
   kernel; the training files read by the native reader (checked) and
   again by both readers, bitwise equal, with their seconds;
9. times of one training epoch of 65536 spectra, kernel and plain (bf16
   and f32 operands, and bf16 operands on bf16 planes), the two epochs'
   outputs held against each other as in phase 7; then one kernel epoch
   with each kernel launched when the one before it has ended (no early
   launch, so that a kernel's span is its own work), timed and under
   ``torch.profiler``: device time and launches of each stage, busy
   share, a check of three launches per batch, and its results bitwise
   equal to the early launch's;
10. the step kernel against its plain version on the same CUDA tensors:
    SDSS width at batch 500 with 116 weight-0 rows duplicating row 0 (the
    stream's tail batch of 384 real rows), DESI width at batch 128, each
    tau law at batch 64, moderate and low-noise data, and every nh 1-10 at
    batch 24 (19 real rows); in each case a second call bitwise equal to
    the first;
11. the streaming main path: ``fit_streaming(step_fn=make_fused_step_fn(
    cfg), device="cuda")`` over 16384 SDSS spectra in host RAM, batch 500,
    2 epochs, checkpoints and smoothing every epoch, 512 held-out
    spectra; 66 step-kernel launches and none of the other kernels; the
    same run on the plain step, and one epoch on the autograd step;
12. times: one step at batch 500 (kernel, plain version, autograd
    ``loss_and_grads``), the whole fused step function, and one streaming
    epoch of 16384 spectra (wall, H2D copy and device busy share by
    ``torch.profiler``, spectra/s); the step's three kernels each launched
    alone: device time per launch by ``torch.profiler`` against the call
    time; with the early launch, the device's busy time and the wrapper's
    host time per call; the kernels' registers, spills and shared memory
    at nh 8;
13. the card's calibration: the alu_chain kernel against its plain
    version for each op (fma, exp, log, div) at n_iters 0, 1 and 3 over the
    (256, 1024) tile, one launch of each at the fma calibration's larger
    count, then ``calibrate_peaks`` and ``calibrate_alu``, each rate beside
    its published counterpart;
14. the contraction-depth probe: the kdepth kernel (dot products on the
    tensor cores in split TF32) against its plain version for all 8
    variants at grid 3 and at the probe's grid 4096 (beside a float64
    witness and a control), each with a repeat call bitwise equal, timed
    per call (CUDA events from an idle device, as every kernel here) with
    the steps in the library's chunks and in one, and on the device (each
    call queued behind another) at the full and an eighth of the grid,
    where the time must grow with the grid; pair36+8's
    plain version and one ``torch.addmm`` per step as the library
    yardstick, replayed from a CUDA graph; then
    ``qfa_tpu_torch.tools.mxu_kdepth.main`` at its defaults into a
    temporary directory;
15. the epoch kernel's window mode (the exact-DP windows of
    ``parallel.sync_dp``) against its plain version on the same CUDA
    tensors: an SDSS epoch of 4096 spectra at batch 512 in windows of 1,
    3 (a remainder window) and 8 batches and the flush (a call with no
    batch that applies the last pending buffer), both layouts, float32
    and bfloat16 planes, bf16 operands off and on, each window's state,
    loss rows and exported pending buffer; a repeat window call bitwise;
    one DESI window of 512 spectra; then, in a one-rank NCCL group,
    ``sync_dp`` at K 1 and 16 bitwise equal to the plain kernel epoch on
    the same permutation;
16. ``torch.distributed`` through the library entry points the CLI uses
    (``fit_fused(mesh=)`` local SGD and exact DP at K 1, 2 and 16,
    ``fit(mesh=)`` with both per-step engines, ``predict_dataset_fused(
    mesh=)``): at world size 1 over NCCL, each against the same call
    without a mesh; then two ranks spawned on the one card over gloo
    (``--rank-worker``), each run held against the plain composition of
    the same global batches on one device, both ranks' parameters equal,
    each rank's kernel launches counted; which gloo collectives take CUDA
    tensors is printed;
17. times at world size 1 over NCCL, one epoch of 65,536 SDSS spectra at
    batch 500, bf16 operands: the plain ``fit_fused`` epoch, ``sync_dp``
    at K 1 and 16, ``epoch_dp``: ms per epoch, the host's time per call,
    the all-reduce's time, the device busy share and the launches per
    epoch;
18. the survey-scale OOD sweep: 1,474,560 SDSS spectra made on the card
    and kept there as bfloat16 flux/error planes (derived mask, zq
    column), one ``stats_only`` call over them bitwise equal to one over
    their float32 upcast, a 4,096-row slice alone bitwise, 65,536 rows
    against the plain version; ``select_ood`` of the top 1,024, predicted
    with bf16 output planes, ``sample_posterior_continua`` on 64 of them;
    ``predict_resident`` and ``score_resident`` over the first 65,536
    spectra's float32 originals against the kernel; every launch
    counted. Readings: the sweep's time per call on bf16 and float32
    planes, full output at 65,536 spectra in the four (plane, output)
    dtype pairs, the resident functions' times, peak device memory and
    the top-1,024 overlap of bf16 and float32 planes;
19. the reference-API facade, profiling, NaN debugging and the MDN:
    ``compat.Dataloader`` over 2048 SDSS spectra on disk, moved to the
    card, and ``compat.QFA(device="cuda").train(engine="auto")`` for 2
    epochs on the epoch kernel (launches counted), its losses held
    against ``fit_fused(plain=True)`` on the same data and seed, its
    single-spectrum prediction on the card against the CPU; the training
    CLI with ``RUNTIME.PROFILE_DIR`` (outputs bitwise unchanged; the
    written trace holds each of the epoch kernel's three kernels once
    per batch) and ``RUNTIME.DEBUG_NANS`` (outputs bitwise unchanged; a
    NaN in the ``--resume`` parameters raises ``FloatingPointError``);
    ``fit_mdn`` on the card (losses finite and falling) and
    ``sample_mock_continua`` (shapes, finite).

Prints a JSON line of kernel results, then, as its last line,
``{"ok": true, "device": {...}}``. Any failure exits non-zero without
that line. Imports nothing of JAX.
"""

import argparse
import itertools
import json
import os
import re
import statistics
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

SEED = 1234
NH = 8
SDSS = dict(lam_min=1030.0, lam_max=1600.0, dloglam=1e-4)
DESI = dict(lam_min=1113.5772, lam_max=1600.0, dloglam=1.7029661e-05)
#: kernel against plain version: the CPU parity tests' tolerances
#: (tests/test_torch_infer_kernel.py); fp32 sums in different orders
TOL = {
    "ll": dict(rtol=2e-5, atol=0.0),
    "hmean": dict(rtol=1e-4, atol=1e-6),
    "hcov": dict(rtol=1e-4, atol=1e-7),
    "continuum": dict(rtol=1e-4, atol=1e-5),
    "continuum_std": dict(rtol=1e-3, atol=1e-5),
    "n_obs": dict(rtol=0.0, atol=0.0),
}
#: Noise regimes of the seeded model and data (all inside ParamBounds):
#: ranges of Psi, omega and the pixel error. "moderate" is the regime of
#: the CPU parity tests. In "low-noise" (d ~ 0.005) the NLL's Woodbury
#: form ll = (quad - w^T K^-1 w + ...)/2 cancels two terms of ~2.5e5 in
#: fp32, so the kernel and the plain version each carry ~1e-7 x 2.5e5 of
#: rounding in ll (~1e-5..1e-4 of |ll|): there ll is held to rtol 2e-4,
#: every other output to TOL.
REGIMES = {
    "moderate": dict(psi=(0.3, 0.6), omega=(0.3, 0.8), err=(0.05, 0.15)),
    "low-noise": dict(psi=(1e-3, 5e-3), omega=(1e-3, 5e-2), err=(0.02, 0.06)),
}
LOW_NOISE_LL_RTOL = 2e-4
#: epoch kernel against its plain version (compare_epoch): the first
#: batch's loss (before any update) to rtol 1e-6 in every mode (it also
#: tells bf16 operands from float32 ones, ~2e-5 apart), n_real exact,
#: and by mode (EPOCH_LIMITS) the per-batch loss sums (relative) and,
#: for each kind of tensor, the limit of its norm-wise relative error
#: ||kernel - plain|| / ||plain||; "elementwise" holds it to TRAIN_TOL
#: instead, None reports it without holding it.
#: Float32 operands: params elementwise rtol 2e-4 atol 2e-5. The JAX
#: kernel's atol is 2e-6 (tests/test_epoch_kernel.py:85-98, held on the
#: CPU); on the card at full width it is 2e-5 because Adam's step
#: lr m/sqrt(v) divides by the element's own gradient size: for the few
#: of 74k F elements whose batch gradient nearly cancels, the float32
#: summation order moves the step by ~1 % of lr (up to 1.2e-5 at DESI
#: width). Those elements then feed the next batch, so a few moment
#: elements also leave the JAX elementwise bounds: m and v are held
#: norm-wise.
#: bf16 operands: an operand within one float32 rounding of a bf16
#: rounding boundary rounds differently in two versions that sum in
#: different orders, moving a product by 2^-8 of itself, and the
#: updates that follow carry the difference on. The plain version on
#: the CPU differs from itself on the card, same code and inputs, by as
#: much as the kernel does (PERF.md section 6), while after one batch
#: the kernel's moments agree with the card's plain version to 4e-5.
#: Each limit lies between those readings and the smallest reading of
#: the plain version with one row of each batch left out (loss sums
#: 2.0e-3, params 7.7e-4, moments 2.1e-2). Over the 132 updates of
#: phase 9 the scalar rows drift as far as that control moves them, so
#: there they are reported only.
TRAIN_TOL = dict(rtol=2e-4, atol=2e-5)  # float32 params, elementwise
JAX_TOL = {"params": dict(rtol=2e-4, atol=2e-6),
           "m": dict(rtol=2e-3, atol=2e-6), "v": dict(rtol=2e-3, atol=1e-9)}
FIRST_LOSS_RTOL = 1e-6
EPOCH_LIMITS = {
    "f32": {"loss": 1e-5, "params": "elementwise",
            "scalar params": "elementwise", "moments": 1e-4,
            "scalar moments": 1e-3},
    "bf16": {"loss": 2e-5, "params": 1e-4, "scalar params": 2e-4,
             "moments": 5e-3, "scalar moments": 1e-1},
    "bf16, 132 updates": {"loss": 2e-4, "params": 3e-4,
                          "scalar params": None, "moments": 1.8e-2,
                          "scalar moments": None},
}
#: training CLI: per-epoch losses of the kernel engine against
#: fit_fused(plain=True) on the same data and seed, both with bf16
#: operands (the CLI default), over 4 epochs; and
#: fit_streaming on the step kernel against the plain step (phase 11)
CLI_LOSS_RTOL = 1e-5
#: step kernel against its plain version (phase 10): the CPU parity
#: tests' form (tests/test_torch_step.py): loss sum rtol 1e-5 (low-noise
#: data 2e-4, the Woodbury cancellation above), counts exact, each
#: gradient to atol STEP_GRAD_REL[k] * max|g|: 1e-4 for F, Psi and omega.
#: Widened to 5e-4 for the scalar gradients and for every gradient of
#: low-noise data: each is a sum over the batch's rows and pixels that
#: cancels (the control moves beta by 116 % of max|g|), so float32
#: summation order alone moves it by up to 1.32e-4 of max|g| (witness:
#: the plain version on the CPU against itself on the card, beta at
#: batch 64) and by 9.31e-5 for low-noise Psi, while leaving one real row
#: out (control) moves every gradient by >= 2.73e-3 (on an H100 by this
#: phase; PERF.md section 6). The phase prints the three readings per
#: case and checks that every control exceeds its limit.
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_REL = {"F": 1e-4, "Psi": 1e-4, "omega": 1e-4, "tau0": 5e-4,
                 "c0": 5e-4, "beta": 5e-4}
LOW_NOISE_GRAD_REL = dict.fromkeys(STEP_GRAD_REL, 5e-4)
TAU_LAWS = ("becker", "fg", "kamble", "mock")
#: the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM
#: bytes/s and fp32 FLOP/s outside the tensor cores, for bound_ms
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: ... and dense bf16 FLOP/s on the tensor cores, for the calibration's
#: shares (phase 13)
BF16_FLOP_PER_S = 989e12
#: ... and dense TF32 FLOP/s on the tensor cores, for the probe's bound
#: (phase 14: its dot products take three TF32 passes)
TF32_FLOP_PER_S = 495e12
#: alu_chain kernel against its plain version (phase 13), relative. fma:
#: nvcc contracts x * a + b into one FFMA and the plain version rounds
#: each rep once as well, so they should agree bitwise; one rep moves the
#: output by 2.2e-7 to 3.2e-7 of itself, so 1e-7 checks the kernel's
#: count of iterations and of reps in each. exp, log and div contract to
#: their fixed points within 32 reps, so their 1e-6 checks the op, not the
#: count. At n_iters 0 every op must agree exactly (the scaled starts).
ALU_RTOL = {"fma": 1e-7, "exp": 1e-6, "log": 1e-6, "div": 1e-6}
#: the calibration's deltas must be at least this long (CUDA events)
ALU_MIN_DELTA_S = 2e-3
#: contraction probe against its plain version (phase 14), as max|kernel -
#: plain| / max|plain|: at grid 3 the plain float32 result lies within
#: 5e-7 of a float64 reference, so 1e-5. At the probe's grid the float32
#: sum of 4096 nearly equal steps carries its rounding on: the witness
#: (the plain float32 version against the same steps in float64, on the
#: card) read 4.89e-05 on an H100 (PERF.md section 6), so a float32 kernel
#: that added its steps in another order (the kernel sums its chunks'
#: partials) could sit that far from the plain version; the control (the
#: plain version with its last step left out) moves the output by 1/4096 =
#: 2.44e-4. The limit lies between; the phase prints all three readings
#: for every variant and checks that the control exceeds it.
KDEPTH_REL = 1e-5
KDEPTH_FULL_REL = 1e-4
#: the probe's grid (tools/mxu_kdepth.py's default)
KDEPTH_GRID = 4096
PARAM_NAMES = ("F", "Psi", "omega", "tau0", "c0", "beta")
#: the kernels of csrc/epoch.cu, each launched once per batch
EPOCH_STAGES = ("forward_kernel", "backward_kernel", "update_kernel")
#: phase 9's traces of one epoch at most, until one holds every launch
PROFILE_TRIES = 3
NPZ_KEYS = {"ll": "ll", "hmean": "hmean", "hcov": "hcov",
            "continuum": "cont", "continuum_std": "uncertainty"}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(msg):
    print(msg, flush=True)


def uniform(g, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=g)


def seeded_params(grid, device, regime="moderate", nh=NH):
    """Parameters inside ParamBounds and a mean continuum, from a seed."""
    from qfa_tpu_torch.models.params import ParamBounds, QFAParams

    r, b = REGIMES[regime], ParamBounds()
    g = torch.Generator().manual_seed(SEED)
    params = QFAParams(
        F=uniform(g, (grid.npix, nh), -0.5, 0.5),
        Psi=uniform(g, (grid.npix,), *r["psi"]),
        omega=uniform(g, (grid.nb,), *r["omega"]),
        tau0=torch.tensor(0.12), c0=torch.tensor(0.2), beta=torch.tensor(2.4),
    ).to(device)
    for name, lo, hi in (("Psi", b.var_min, b.var_max),
                         ("omega", b.var_min, b.var_max),
                         ("tau0", b.tau0_min, b.tau0_max),
                         ("c0", b.c0_min, b.c0_max),
                         ("beta", b.beta_min, b.beta_max)):
        v = getattr(params, name).detach()
        check(lo <= float(v.min()) and float(v.max()) <= hi,
              f"seeded {name} outside ParamBounds")
    return params, uniform(g, (grid.npix,), 0.8, 1.2).to(device)


@torch.no_grad()
def draw_spectra(params, mu, grid, n, seed, regime="moderate", mask_frac=0.1):
    """n spectra from the generative model on the params' device:
    z in [2, 3.5], continuum mu + F h, blue absorption and forest noise,
    the regime's pixel error, and one contiguous masked chunk of
    ``mask_frac`` of the pixels per spectrum. Returns flux, error, mask
    (float) and zqso, unsanitized."""
    from qfa_tpu_torch.data.grid import LYA_WAVELENGTH
    from qfa_tpu_torch.models.qfa import absorption
    from qfa_tpu_torch.physics.tau import omega_func

    dev = params.F.device
    g = torch.Generator(device=dev).manual_seed(seed)
    zq = 2.0 + 1.5 * torch.rand(n, generator=g, device=dev)
    blue = torch.tensor(grid.blue, dtype=torch.float32, device=dev)
    zabs = (1.0 + zq)[:, None] * blue / LYA_WAVELENGTH - 1.0
    h = torch.randn(n, params.F.shape[1], generator=g, device=dev)
    cont = mu + h @ params.F.T
    amp = absorption(zabs, grid.nr)
    zdep = omega_func(zabs, params.tau0, params.beta, params.c0)
    forest = torch.cat([params.omega * zdep,
                        torch.zeros(n, grid.nr, device=dev)], dim=1)
    lo, hi = REGIMES[regime]["err"]
    error = lo + (hi - lo) * torch.rand(n, grid.npix, generator=g, device=dev)
    d = amp * amp * params.Psi + forest + error * error
    flux = amp * cont + torch.sqrt(d) * torch.randn(
        n, grid.npix, generator=g, device=dev)
    span = max(int(mask_frac * grid.npix), 1)
    start = torch.randint(0, grid.npix - span + 1, (n, 1), generator=g,
                          device=dev)
    cols = torch.arange(grid.npix, device=dev)[None, :]
    mask = (~((cols >= start) & (cols < start + span))).float()
    return flux, error, mask, zq


def compare(name, got, want, tol):
    """Max abs error over the outputs, and the worst relative error of
    each; raises (after checking every output) beyond the tolerances."""
    worst, rel, bad = 0.0, {}, []
    for field in got._fields:
        a, b = getattr(got, field), getattr(want, field)
        if a is None and b is None:
            continue
        check(a is not None and b is not None, f"{name}: {field} missing")
        check(bool(torch.isfinite(a).all()), f"{name}: {field} not finite")
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()))
        rel[field] = float((diff / b.abs().clamp(min=1e-30)).max())
        t = tol[field]
        excess = float((diff - t["atol"] - t["rtol"] * b.abs()).max())
        if excess > 0:
            bad.append(f"{field} (worst excess {excess:.3g})")
    detail = " ".join(f"{k}={v:.2e}" for k, v in rel.items())
    check(not bad, f"{name}: kernel and plain version disagree on "
          f"{', '.join(bad)}; max rel err {detail}")
    return worst, detail


def predict_modes(grid, zabs, mask, zq, device):
    """The two modes of the prediction path: (name, args, kwargs)."""
    from qfa_tpu_torch.ops.common import loglam_row, zq_column

    return (("mask plane + zabs plane", (zabs, mask), {}),
            ("derived mask + zq column", (zq_column(zq), None),
             dict(loglam=loglam_row(grid.wav, device=device),
                  derive_zabs=True)))


def predict_problem(grid_kw, n, device, regime="moderate", nh=NH):
    """Grid, seeded parameters and n drawn spectra (rows 0, 17 and n - 1
    fully masked, where they exist) on the device."""
    from qfa_tpu_torch.data.grid import make_grid

    grid = make_grid(**grid_kw)
    params, mu = seeded_params(grid, device, regime, nh)
    flux, error, mask, zq = draw_spectra(params, mu, grid, n, SEED + n,
                                         regime)
    mask[[r for r in (0, 17, n - 1) if r < n]] = 0.0
    flux, error = flux * mask, error * mask
    zabs = torch.tensor(grid.zabs(zq.cpu().numpy()), dtype=torch.float32,
                        device=device)
    return grid, params, mu, (flux, error), predict_modes(grid, zabs, mask,
                                                          zq, device)


def rows_of(out, rows):
    return type(out)(*(None if t is None else t[rows] for t in out))


def check_bitwise(name, got, want):
    for field in got._fields:
        a, b = getattr(got, field), getattr(want, field)
        check((a is None and b is None) or torch.equal(a, b),
              f"{name}: {field} differs bitwise")


def phase_kernel_vs_plain(device):
    from qfa_tpu_torch.ops.infer_kernel import fused_predict, fused_predict_plain

    worst = 0.0

    def held(name, params, mu, planes, args, kw, tol=TOL, stats_only=False,
             n_label=None):
        nonlocal worst
        got = fused_predict(params, mu, *planes, *args,
                            stats_only=stats_only, **kw)
        torch.cuda.synchronize()
        want = fused_predict_plain(params, mu, *planes, *args,
                                   stats_only=stats_only, **kw)
        torch.cuda.synchronize()
        err, detail = compare(name, got, want, tol)
        worst = max(worst, err)
        n = planes[0].shape[0]
        say(f"  {name}: n={n} npix={planes[0].shape[1]} ll in "
            f"[{float(got.ll.min()):.1f}, {float(got.ll.max()):.1f}]; "
            f"max_abs_err={err!r}; max rel err {detail}")
        return got

    cases = (("SDSS", SDSS, 4096, "moderate"), ("DESI", DESI, 512, "moderate"),
             ("SDSS", SDSS, 4096, "low-noise"))
    for label, grid_kw, n, regime in cases:
        grid, params, mu, planes, modes = predict_problem(grid_kw, n, device,
                                                          regime)
        tol = dict(TOL)
        if regime == "low-noise":
            tol["ll"] = dict(rtol=LOW_NOISE_LL_RTOL, atol=0.0)
        for mode, args, kw in modes:
            for stats_only in (False, True):
                name = (f"{label} {regime} {mode}"
                        f"{' stats_only' if stats_only else ''}")
                got = held(name, params, mu, planes, args, kw, tol,
                           stats_only)
                check(float(got.ll[0]) == 0.0 and float(got.n_obs[0]) == 0.0,
                      f"{name}: fully masked row is not inert")
            if (label, regime) != ("SDSS", "moderate"):
                continue
            # bitwise: a second launch, and rows 0-63 and row 1000 alone
            batch = fused_predict(params, mu, *planes, *args, **kw)
            again = fused_predict(params, mu, *planes, *args, **kw)
            check_bitwise(f"{label} {mode}: second launch", again, batch)
            for rows in (slice(0, 64), slice(1000, 1001)):
                sub = [None if t is None else t[rows].contiguous()
                       for t in args]
                alone = fused_predict(params, mu, *(t[rows].contiguous()
                                                    for t in planes),
                                      *sub, **kw)
                check_bitwise(f"{label} {mode}: rows {rows.start}-"
                              f"{rows.stop - 1} alone", alone,
                              rows_of(batch, rows))
            say(f"  {label} {mode}: a second launch, rows 0-63 alone and row "
                "1000 alone equal the 4096 batch bitwise")
    # every instantiated nh at both widths (modes in turn), n = 1 and a
    # ragged n
    for label, grid_kw, n in (("SDSS", SDSS, 512), ("DESI", DESI, 128)):
        for nh in range(1, 11):
            grid, params, mu, planes, modes = predict_problem(
                grid_kw, n, device, nh=nh)
            mode, args, kw = modes[nh % 2]
            held(f"{label} nh={nh} {mode}", params, mu, planes, args, kw)
    grid, params, mu, planes, modes = predict_problem(SDSS, 302, device)
    for n in (1, 301):  # rows 1.. (row 0 is fully masked)
        for mode, args, kw in modes:
            sub = [None if t is None else t[1:1 + n].contiguous()
                   for t in args]
            held(f"SDSS n={n} {mode}", params, mu,
                 [t[1:1 + n].contiguous() for t in planes], sub, kw)
    return worst


#: phase 3's bfloat16 cases: which of the planes are stored as bf16
#: (mask and zabs only where the mode has those planes)
BF16_CASES = {"bf16 flux/error": ("flux", "error"),
              "bf16 mask plane": ("mask",), "bf16 zabs plane": ("zabs",),
              "bf16 flux/error/mask/zabs": ("flux", "error", "mask",
                                            "zabs")}
#: ... at these widths and batch sizes
BF16_WIDTHS = (("SDSS", SDSS, 512), ("DESI", DESI, 128))


def check_bf16_out(name, f32, out):
    """``out`` (out_dtype=bfloat16) against ``f32`` (the same call with
    float32 output): the planes bitwise ``f32``'s cast, the stats float32
    and bitwise equal."""
    for field in f32._fields:
        a, b = getattr(out, field), getattr(f32, field)
        if field.startswith("continuum"):
            b = b.to(torch.bfloat16)
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"{name} out_dtype=bfloat16: {field} is not the float32 "
              f"call's {'cast ' if b.dtype != torch.float32 else ''}bitwise")


def phase_bf16_vs_plain(device):
    """Phase 3's bfloat16 modes: at SDSS and DESI width and nh 1, 8, 10,
    in both modes, full output and stats_only, every case of BF16_CASES
    (a) within TOL of the plain version on the same planes, (b) bitwise
    the float32 kernel on the planes upcast (exact), (c) rows 0-63 alone
    bitwise the batch's; and ``out_dtype=bfloat16`` on float32 planes and
    on each case's planes: its planes bitwise the float32-out call's
    cast, its stats float32 and bitwise unchanged. Returns (max abs error
    against the plain version, calls made)."""
    from qfa_tpu_torch.ops.infer_kernel import fused_predict, fused_predict_plain

    bf = torch.bfloat16
    worst, calls = 0.0, 0

    def cast(ts, names, which):
        return [None if t is None else t.to(bf) if name in which else t
                for t, name in zip(ts, names)]

    def upcast(ts):
        return [None if t is None else t.float() for t in ts]

    for label, grid_kw, n in BF16_WIDTHS:
        for nh in (1, 8, 10):
            grid, params, mu, planes, modes = predict_problem(
                grid_kw, n, device, nh=nh)
            for mode, args, kw in modes:
                seen, done = [], set()
                for case, which in BF16_CASES.items():
                    p_b = cast(planes, ("flux", "error"), which)
                    a_b = cast(args, ("zq column" if kw else "zabs", "mask"),
                               which)
                    # the planes of the mode this case stores as bf16
                    cast_ = tuple(x is not y for x, y in
                                  zip((*p_b, *a_b), (*planes, *args)))
                    if not any(cast_) or cast_ in done:
                        continue  # none, or an earlier case's, in this mode
                    done.add(cast_)
                    seen.append(case)
                    name = f"{label} nh={nh} {mode} {case}"
                    full = None
                    for stats_only in (False, True):
                        tag = f"{name}{' stats_only' if stats_only else ''}"
                        got = fused_predict(params, mu, *p_b, *a_b,
                                            stats_only=stats_only, **kw)
                        want = fused_predict_plain(
                            params, mu, *p_b, *a_b, stats_only=stats_only,
                            **kw)
                        err, _ = compare(tag, got, want, TOL)
                        worst = max(worst, err)
                        check_bitwise(f"{tag} against float32 on the "
                                      "upcast planes", got, fused_predict(
                                          params, mu, *upcast(p_b),
                                          *upcast(a_b),
                                          stats_only=stats_only, **kw))
                        rows = slice(0, 64)
                        alone = fused_predict(
                            params, mu, *(t[rows].contiguous() for t in p_b),
                            *(None if t is None else t[rows].contiguous()
                              for t in a_b), stats_only=stats_only, **kw)
                        check_bitwise(f"{tag}: rows 0-63 alone", alone,
                                      rows_of(got, rows))
                        calls += 3
                        full = full if stats_only else got
                    check_bf16_out(name, full, fused_predict(
                        params, mu, *p_b, *a_b, out_dtype=bf, **kw))
                    calls += 1
                check_bf16_out(f"{label} nh={nh} {mode}", fused_predict(
                    params, mu, *planes, *args, **kw), fused_predict(
                    params, mu, *planes, *args, out_dtype=bf, **kw))
                calls += 2
                say(f"  {label} nh={nh} {mode}, bfloat16: {', '.join(seen)}"
                    " (full output and stats_only) within TOL of the plain "
                    "version on the same planes, bitwise equal to the "
                    "float32 kernel on the planes upcast, rows 0-63 alone "
                    "bitwise; out_dtype=bfloat16 (on these planes and on "
                    "float32 ones) planes bitwise the float32 planes cast, "
                    "stats bitwise unchanged")
    return worst, calls


PLANE_TYPES = {"f": "float32", "13__nv_bfloat16": "bfloat16"}


def predict_build_report(lib, log):
    """{(nh, flux/error type, flags): registers, spill stores/loads
    (ptxas -v) and, in each mode, dynamic shared memory per block and
    resident blocks per SM} of the prediction kernel (flags: the mask and
    zabs planes' and the outputs' types read from run-time flags); fails
    if a mode of an instantiation cannot launch."""
    import ctypes

    report, key = {}, None
    for line in log.splitlines():
        name = re.search(r"Compiling entry function '(\w+)'", line)
        if name:
            m = re.search(r"predict_kernelILi(\d+)E(f|13__nv_bfloat16)Lb([01])E",
                          name[1])
            key = (int(m[1]), PLANE_TYPES[m[2]], m[3] == "1") if m else None
            if key is not None:
                report[key] = {"registers": None, "spill": None}
        elif key is not None and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill", line)
            report[key]["spill"] = f"{st}/{ld}"
        elif key is not None and "registers" in line:
            report[key]["registers"] = int(re.search(r"(\d+) registers",
                                                     line)[1])
    want = sorted((nh, t, f) for nh in range(1, 11)
                  for t in PLANE_TYPES.values() for f in (False, True))
    check(sorted(report) == want,
          f"ptxas reported predict_kernel for {sorted(report)}")
    for (nh, ptype, flags), r in sorted(report.items()):
        r["modes"] = {}
        for mode, dm, dz in (("derived mask + zq column", 1, 1),
                             ("mask plane + zabs plane", 0, 0)):
            b, k = ctypes.c_int(), ctypes.c_int()
            rc = lib.qfa_predict_occupancy(nh, int(ptype == "bfloat16"),
                                           int(flags), dm, dz, 0,
                                           ctypes.byref(b), ctypes.byref(k))
            check(rc == 0 and k.value >= 1,
                  f"predict_kernel nh={nh} {ptype} flags={flags} {mode}: "
                  f"occupancy rc {rc}, {k.value} blocks per SM at "
                  f"{b.value} B")
            r["modes"][mode] = (b.value, k.value)
    return dict(sorted(report.items()))


def step_build_report(log, nh=NH):
    """{kernel: (registers, spill stores/loads, static shared memory bytes)}
    of step.cu's kernels at nh from ptxas -v, in launch order."""
    report, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            m = re.search(rf"(forward|backward|finish)_kernelILi{nh}E\w*"
                          "StepArgs", entry[1])
            name = f"{m[1]}_kernel" if m else None
            if name:
                report[name] = [None, None, None]
        elif name and "spill stores" in line:
            report[name][1] = "/".join(re.findall(r"(\d+) bytes spill", line))
        elif name and "registers" in line:
            report[name][0] = int(re.search(r"(\d+) registers", line)[1])
            smem = re.search(r"(\d+) bytes smem", line)
            report[name][2] = int(smem[1]) if smem else 0
    order = ("forward_kernel", "backward_kernel", "finish_kernel")
    return {k: tuple(report.get(k, ("not found",) * 3)) for k in order}


def write_survey(root, params, mu, grid, n):
    """Checkpoint, n spectra npz files with -999 sentinels, and a predict
    catalog under root."""
    from qfa_tpu_torch.models.params import save_npz

    ckpt = os.path.join(root, "model.npz")
    save_npz(ckpt, params, mu)
    flux, error, mask, zq = (t.cpu().numpy() for t in
                             draw_spectra(params, mu, grid, n, SEED + 7))
    keep = mask > 0
    data_dir = os.path.join(root, "spectra")
    os.makedirs(data_dir)
    names = [f"spec-{i:05d}.npz" for i in range(n)]
    for i, name in enumerate(names):
        np.savez(os.path.join(data_dir, name),
                 flux=np.where(keep[i], flux[i], -999.0),
                 error=np.where(keep[i], error[i], -999.0), z=zq[i])
    catalog = os.path.join(root, "predict-catalog.csv")
    with open(catalog, "w") as f:
        f.write("\n".join(names) + "\n")
    raw = dict(flux=np.where(keep, flux, -999.0).astype(np.float32),
               error=np.where(keep, error, -999.0).astype(np.float32), zqso=zq)
    return ckpt, data_dir, catalog, names, raw


def phase_cli(root, ckpt, data_dir, catalog, names, grid):
    from qfa_tpu_torch import cli
    from qfa_tpu_torch.data.loader import SpectraDataset
    from qfa_tpu_torch.infer.predict import predict_dataset
    from qfa_tpu_torch.models.params import load_npz
    from qfa_tpu_torch.ops import infer_kernel

    out = os.path.join(root, "predict_out")
    before = infer_kernel.LAUNCHES
    timing = cli.main(["--type", "predict", "--catalog", catalog,
                       "--data_dir", data_dir, "--output_dir", out,
                       "--resume", ckpt, "--device", "cuda"])
    launches = infer_kernel.LAUNCHES - before
    check(launches >= 1, "CLI predict launched no kernel")
    check(timing["n"] == len(names), f"CLI predicted {timing['n']} spectra")
    check_native_read(timing, "CLI predict")
    with open(os.path.join(out, "log.txt")) as f:
        log = f.read()
    check("fused CUDA kernel" in log, "CLI did not take the kernel")
    check("with the native npz reader" in log,
          "CLI predict's log does not name the native reader")
    outputs = {}
    for name in names:
        with np.load(os.path.join(out, "predict", name)) as r:
            check(r["cont"].shape == (grid.npix,)
                  and r["hcov"].shape == (NH, NH), f"{name}: bad shapes")
            for key in NPZ_KEYS.values():
                check(bool(np.isfinite(r[key]).all()), f"{name}: {key} not finite")
            outputs[name] = {k: r[k] for k in r.files}
    # a sample against the plain path on the CPU
    sample = names[::32]
    params, mu = load_npz(ckpt, device="cpu")
    ds = SpectraDataset.from_paths([os.path.join(data_dir, s) for s in sample])
    ref = predict_dataset(params, mu, ds, grid, batch_size=64)
    for field, key in NPZ_KEYS.items():
        got = np.stack([outputs[s][key] for s in sample])
        want = np.asarray(getattr(ref, field), np.float32)
        if key == "hmean":
            want = want[..., None]
        np.testing.assert_allclose(got, want, err_msg=f"CLI vs CPU {key}",
                                   **TOL[field])
    return launches, timing, len(sample)


def phase_serving(ckpt, raw):
    from qfa_tpu_torch.ops import infer_kernel
    from qfa_tpu_torch.serve import QFAPredictor, make_http_server

    pred = QFAPredictor(ckpt, device="cuda")
    check(pred.engine == "fused", f"serving engine is {pred.engine}")
    server = make_http_server(pred, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]

    def call(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=data,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            check(resp.status == 200, f"{path}: HTTP {resp.status}")
            return json.loads(resp.read())

    before = infer_kernel.LAUNCHES
    responses, latencies = [], []
    try:
        health = call("/healthz")
        check(health["engine"] == "fused", f"/healthz engine {health['engine']}")
        start = 0
        for size in (1, 37, 200):
            sl = slice(start, start + size)
            start += size
            payload = {k: raw[k][sl].tolist() for k in ("flux", "error", "zqso")}
            t0 = time.perf_counter()
            responses.append((sl, call("/predict", payload)))
            latencies.append((size, time.perf_counter() - t0))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    launches = infer_kernel.LAUNCHES - before
    check(launches >= 3, f"serving launched the kernel {launches} times")
    return launches, latencies, pred, responses


def check_responses(pred, responses, raw):
    """The HTTP responses equal the predictor's direct call."""
    for sl, resp in responses:
        direct = pred.predict(raw["flux"][sl], raw["error"][sl],
                              raw["zqso"][sl])
        for key, val in direct.items():
            got = np.asarray(resp[key], val.dtype)
            np.testing.assert_array_equal(got, val, err_msg=f"HTTP {key}")


def kernel_modules():
    """The wrapper modules of the port's kernels, each with LAUNCHES."""
    from qfa_tpu_torch.ops import (
        alu_chain,
        epoch_kernel,
        fused_step,
        infer_kernel,
        kdepth,
    )

    return infer_kernel, epoch_kernel, fused_step, alu_chain, kdepth


def zero_counts():
    for mod in kernel_modules():
        mod.LAUNCHES = 0
    kernel_modules()[1].WINDOW_LAUNCHES = 0  # epoch_kernel's window mode
    kernel_modules()[0].BF16_LAUNCHES = 0  # infer_kernel's bf16 modes


def other_counts(mod):
    """Launches of every kernel but ``mod``'s."""
    return sum(m.LAUNCHES for m in kernel_modules() if m is not mod)


def time_cuda(fn, reps):
    """Median ms of fn() over reps runs, by CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_cuda_queued(fn, reps):
    """Median ms of fn() over reps runs, by CUDA events, each run queued
    behind one more untimed run of fn, so that the host's time to launch it
    overlaps the device's work: the device's time per call."""
    times = []
    for _ in range(reps):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


#: phase 6's sizes: a survey sweep, the CLI's chunk (infer/predict.py),
#: serving's max_batch and a single spectrum
PREDICT_SIZES = (65536, 8192, 64, 1)
#: kernel calls under torch.profiler per size (device time per launch)
PROFILED_CALLS = 5


def phase_times(device, reps=5):
    """Kernel and plain times of the derived layout (the CLI's) at each of
    PREDICT_SIZES, full output and stats_only: {(n, stats_only): {...}}."""
    from qfa_tpu_torch.data.grid import make_grid
    from qfa_tpu_torch.ops.common import loglam_row, zq_column
    from qfa_tpu_torch.ops.infer_kernel import fused_predict, fused_predict_plain

    grid = make_grid(**SDSS)
    params, mu = seeded_params(grid, device)
    flux, error, mask, zq = draw_spectra(params, mu, grid, PREDICT_SIZES[0],
                                         SEED + 3)
    flux, error = flux * mask, error * mask
    zqc = zq_column(zq)
    kw = dict(loglam=loglam_row(grid.wav, device=device), derive_zabs=True)
    out = {}
    for n in PREDICT_SIZES:
        args = (params, mu, flux[:n].contiguous(), error[:n].contiguous(),
                zqc[:n].contiguous())
        for stats_only in (False, True):
            runs = {
                "plain": lambda: fused_predict_plain(
                    *args, stats_only=stats_only, **kw),
                "kernel": lambda: fused_predict(*args, stats_only=stats_only,
                                                **kw),
            }
            t = turns(runs, reps)
            t["bound"] = predict_bound(grid, n, stats_only)
            # the kernel's own span, without the wrapper's host time that
            # a lone call's CUDA events also hold at small n
            _, by_name, _, _, counts = profile_run(
                lambda: [runs["kernel"]() for _ in range(PROFILED_CALLS)])
            spans = {k: v for k, v in (by_name or {}).items()
                     if "predict_kernel" in k}
            t["device"] = None if not spans else \
                sum(spans.values()) * 1e3 / sum(counts[k] for k in spans)
            out[n, stats_only] = t
    return out


def train_problem(grid, params, mu, n, seed, regime="moderate"):
    """Residual planes of n drawn spectra on the params' device, with the
    zabs plane, the mask and the zq column."""
    from qfa_tpu_torch.models.qfa import absorption
    from qfa_tpu_torch.ops.common import zq_column

    flux, error, mask, zq = draw_spectra(params, mu, grid, n, seed, regime)
    zabs = torch.tensor(grid.zabs(zq.cpu().numpy()), dtype=torch.float32,
                        device=flux.device)
    delta = (flux - mu * absorption(zabs, grid.nr)) * mask
    return dict(delta=delta, error=error * mask, mask=mask, zabs=zabs,
                zq=zq_column(zq))


def pad_rows(data, pad):
    """data with ``pad`` zero (inert) rows appended to every plane."""
    return {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
            for k, v in data.items()}


def layout(grid, data, name):
    """(zabs, mask, kwargs) of the derived or the plane layout."""
    from qfa_tpu_torch.ops.common import loglam_row

    if name == "derived":
        return data["zq"], None, dict(
            derive_zabs=True,
            loglam=loglam_row(grid.wav, device=data["delta"].device))
    return data["zabs"], data["mask"], {}


def norm_rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def epoch_tensors(out):
    """Every tensor an epoch call returns: loss sums, n_real, params, m, v."""
    from qfa_tpu_torch.models.params import PARAM_NAMES

    return [out.loss_sums, out.n_real] + [
        getattr(getattr(out, part), k) for part in ("params", "m", "v")
        for k in PARAM_NAMES]


def compare_epoch(name, got, want, mode, starts_epoch=True):
    """Kernel against plain outputs of fused_train_epoch, held to
    EPOCH_LIMITS[mode] (the first batch's loss to FIRST_LOSS_RTOL when the
    call starts from the same state in both, ``starts_epoch``); returns
    the max abs error over the parameters and a summary."""
    lim = EPOCH_LIMITS[mode]
    lk, lp = got.loss_sums.flatten(), want.loss_sums.flatten()
    rel = first = 0.0  # a window-mode call with no batch has no loss row
    if lp.numel():
        check(bool(torch.isfinite(lk).all()), f"{name}: loss sums not "
              "finite")
        rel = float(((lk - lp).abs() / lp.abs()).max())
        check(rel <= lim["loss"], f"{name}: per-batch loss sums differ by "
              f"{rel:.3g}")
        first = float((lk[0] - lp[0]).abs() / lp[0].abs())
        check(first <= FIRST_LOSS_RTOL or not starts_epoch,
              f"{name}: first batch loss differs by {first:.3g}")
    check(torch.equal(got.n_real, want.n_real), f"{name}: n_real differs")
    worst, worst_norm, outside, total = 0.0, {}, 0, 0
    for part in ("params", "m", "v"):
        for k in PARAM_NAMES:
            a = getattr(getattr(got, part), k).detach()
            b = getattr(getattr(want, part), k).detach()
            check(bool(torch.isfinite(a).all()),
                  f"{name}: {part}.{k} not finite")
            t = JAX_TOL[part]
            outside += int(((a - b).abs() > t["atol"] + t["rtol"] * b.abs())
                           .sum())
            total += a.numel()
            kind = "params" if part == "params" else "moments"
            if a.ndim == 0:
                kind = "scalar " + kind
            if lim[kind] == "elementwise":
                excess = float(((a - b).abs() - TRAIN_TOL["atol"]
                                - TRAIN_TOL["rtol"] * b.abs()).max())
                check(excess <= 0, f"{name}: {part}.{k} exceeds tolerance "
                      f"by {excess:.3g}")
            else:
                r = norm_rel(a, b)
                worst_norm[kind] = max(worst_norm.get(kind, 0.0), r)
                check(lim[kind] is None or r <= lim[kind],
                      f"{name}: {part}.{k} norm-wise error {r:.3g}")
            if part == "params":
                worst = max(worst, float((a - b).abs().max()))
    detail = (f"loss max rel {rel:.2e}, first {first:.2e}; norm-wise "
              + ", ".join(f"{k} {v:.2e}" for k, v in worst_norm.items())
              + f"; {outside} of {total} elements outside the JAX "
              "elementwise tolerances")
    return worst, detail


def phase_epoch_vs_plain(device):
    from qfa_tpu_torch.data.grid import make_grid
    from qfa_tpu_torch.ops.epoch_kernel import (
        fused_train_epoch,
        fused_train_epoch_plain,
    )
    from qfa_tpu_torch.train import adam

    from qfa_tpu_torch.train import pick_tiling

    worst = 0.0
    tb = 64
    # (label, grid, spectra, batch, tile, epochs, layouts, plane types);
    # the last case is the training CLI's shape in phase 8: 2048 spectra
    # padded to 5 batches of 500 rows (the last backward chunk of each
    # batch holds 20 of 32 rows), tile 4, 4 epochs, derived layout. bf16
    # planes: kernel and plain version get the same bfloat16 delta and
    # error planes and are held to the float32 planes' limits
    both = (torch.float32, torch.bfloat16)
    cases = (("SDSS", SDSS, 4096, 512, tb, 2, ("derived", "plane"), both),
             ("DESI", DESI, 512, 256, tb, 1, ("derived", "plane"), both),
             ("SDSS CLI shape", SDSS, 2048, 500, pick_tiling(500)[0], 4,
              ("derived",), (torch.float32,)))
    for label, grid_kw, n, batch, tile, n_epochs, layouts, planes in cases:
        grid = make_grid(**grid_kw)
        params, mu = seeded_params(grid, device)
        data = pad_rows(train_problem(grid, params, mu, n, SEED + 21),
                        -(-n // batch) * batch - n)
        rows = data["delta"].shape[0]
        st = adam.init(params)
        g = torch.Generator().manual_seed(SEED)
        perm = torch.stack([torch.randperm(rows // tile, generator=g)
                            for _ in range(n_epochs)])
        for name, dtype, mxu in itertools.product(layouts, planes,
                                                  (False, True)):
            zabs, mask, kw = layout(grid, data, name)
            args = (params, st.m, st.v, data["delta"].to(dtype),
                    data["error"].to(dtype), zabs, perm, mask)
            kw2 = dict(kw, epoch=0, n_batches=rows // batch,
                       n_epochs=n_epochs, tile_batch=tile, mxu_bf16=mxu)
            got = fused_train_epoch(*args, **kw2)
            torch.cuda.synchronize()
            want = fused_train_epoch_plain(*args, **kw2)
            torch.cuda.synchronize()
            case = (f"{label} {name} layout, "
                    f"{'bf16' if dtype == torch.bfloat16 else 'f32'} "
                    f"planes, {'bf16' if mxu else 'f32'} operands")
            err, detail = compare_epoch(case, got, want,
                                        "bf16" if mxu else "f32")
            worst = max(worst, err)
            say(f"  {case}: n={n} ({rows} rows) batch={batch} "
                f"tile={tile} epochs={n_epochs}; params "
                f"max_abs_err={err!r}; {detail}")
    # 3 epochs in one call against 3 chained calls; inert padding rows
    grid = make_grid(**SDSS)
    params, mu = seeded_params(grid, device)
    data = train_problem(grid, params, mu, 4096, SEED + 22)
    st = adam.init(params)
    zabs, _, kw = layout(grid, data, "derived")
    kw.update(n_batches=8, tile_batch=tb, mxu_bf16=True)
    g = torch.Generator().manual_seed(SEED + 1)
    perm = torch.stack([torch.randperm(4096 // tb, generator=g)
                        for _ in range(3)])
    one = fused_train_epoch(params, st.m, st.v, data["delta"], data["error"],
                            zabs, perm, epoch=5, n_epochs=3, **kw)
    p, m, v, losses = params, st.m, st.v, []
    for e in range(3):
        out = fused_train_epoch(p, m, v, data["delta"], data["error"], zabs,
                                perm[e], epoch=5 + e, **kw)
        p, m, v = out.params, out.m, out.v
        losses.append(out.loss_sums)
    torch.cuda.synchronize()
    same = torch.equal(one.loss_sums, torch.stack(losses)) and all(
        torch.equal(getattr(getattr(one, part), k), getattr(x, k))
        for part, x in (("params", p), ("m", m), ("v", v))
        for k in PARAM_NAMES)
    check(same, "3 epochs in one call differ from 3 chained calls")
    say("  SDSS derived layout, bf16 operands: 3 epochs in one call are "
        "bitwise equal to 3 chained calls")
    n_tiles = 4096 // tb  # one zero tile after each batch
    padded = pad_rows(data, 8 * tb)
    perm_pad = torch.cat([perm[0].reshape(8, -1),
                          torch.arange(n_tiles, n_tiles + 8)[:, None]],
                         dim=1).reshape(-1)
    a = fused_train_epoch(params, st.m, st.v, data["delta"], data["error"],
                          zabs, perm[0], epoch=0, **kw)
    b = fused_train_epoch(params, st.m, st.v, padded["delta"],
                          padded["error"], padded["zq"], perm_pad, epoch=0,
                          **kw)
    torch.cuda.synchronize()
    same = torch.equal(a.loss_sums, b.loss_sums) and torch.equal(
        a.n_real, b.n_real) and all(
        torch.equal(getattr(getattr(a, part), k), getattr(getattr(b, part), k))
        for part in ("params", "m", "v") for k in PARAM_NAMES)
    check(same, "inert padding rows changed the epoch")
    say("  SDSS derived layout: a zero tile after each batch changes nothing "
        "(bitwise)")
    return worst


def write_training_survey(root, grid, n):
    """n spectra (-999 sentinels in masked pixels) and a training catalog
    (file,snr,z,num_mask) under root; returns the catalog, the data
    directory and the file names."""
    params, mu = seeded_params(grid, torch.device("cpu"))
    flux, error, mask, zq = (t.numpy() for t in
                             draw_spectra(params, mu, grid, n, SEED + 31))
    keep = mask > 0
    data_dir = os.path.join(root, "train_spectra")
    os.makedirs(data_dir)
    names = [f"train-{i:05d}.npz" for i in range(n)]
    rows = ["file,snr,z,num_mask"]
    for i, name in enumerate(names):
        np.savez(os.path.join(data_dir, name),
                 flux=np.where(keep[i], flux[i], -999.0),
                 error=np.where(keep[i], error[i], -999.0), z=zq[i])
        rows.append(f"{name},10.0,{zq[i]:.6f},0")
    catalog = os.path.join(root, "train-catalog-in.csv")
    with open(catalog, "w") as f:
        f.write("\n".join(rows) + "\n")
    return catalog, data_dir, names


def phase_train_cli(root, grid, n=2048, epochs=4):
    """The training main path through the CLI on the kernel, counted from
    zero; then ``fit_fused(plain=True)`` called directly on the same loaded
    data and seed, the CLI once more with ``TRAIN.ENGINE xla`` (the
    per-step trainer ``train.fit``, no epoch kernel), and a prediction
    from the trained model."""
    from qfa_tpu_torch import cli
    from qfa_tpu_torch.config import get_config
    from qfa_tpu_torch.data.loader import bf16_planes
    from qfa_tpu_torch.models.params import load_npz, random_init
    from qfa_tpu_torch.ops import epoch_kernel, infer_kernel
    from qfa_tpu_torch.train import fit_fused

    catalog, data_dir, names = write_training_survey(root, grid, n)
    base = ["--type", "train", "--catalog", catalog, "--data_dir", data_dir,
            "--data_num", str(n), "--batch_size", "500", "--n_epochs",
            str(epochs), "--seed", str(SEED), "--device", "cuda"]
    opts = ["--opts", "TRAIN.SMOOTH_INTERVAL", "2", "TRAIN.SAVE_INTERVAL",
            "2"]
    out_k = os.path.join(root, "train_kernel")
    # the training path's launches are counted from here ...
    epoch_kernel.LAUNCHES = infer_kernel.LAUNCHES = 0
    run_k = cli.main(base + ["--output_dir", out_k] + opts)
    launches = epoch_kernel.LAUNCHES  # ... to here
    check(launches >= 1, "CLI train launched no epoch kernel")
    check_native_read(run_k, "CLI train")
    run_k["reads"] = read_engines(
        [os.path.join(data_dir, name) for name in names])
    check(infer_kernel.LAUNCHES == 0, "CLI train launched the predict kernel")
    check(run_k["engine"] == "kernel", f"CLI train engine {run_k['engine']}")
    with open(os.path.join(out_k, "log.txt")) as f:
        log = f.read()
    check("trainer engine: fused CUDA epoch kernel" in log,
          "CLI train did not take the epoch kernel")
    check("derived mask + zq-column redshifts" in log,
          "CLI train did not take the derived layout")
    with open(os.path.join(out_k, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    check(len(metrics) == epochs and all(np.isfinite(r["loss"])
                                          for r in metrics),
          "metrics.jsonl lacks finite per-epoch losses")
    ckpts = sorted(os.listdir(os.path.join(out_k, "checkpoints")))
    check(ckpts == sorted(f"{kind}_epoch_{e:02d}.npz"
                          for kind in ("model_parameters", "state")
                          for e in range(2, epochs + 1, 2)),
          f"checkpoints {ckpts}")
    model = os.path.join(out_k, "model_parameters.npz")
    params, mu = load_npz(model)
    check(tuple(params.F.shape) == (grid.npix, NH)
          and all(bool(torch.isfinite(getattr(params, k)).all())
                  for k in PARAM_NAMES), "trained model has bad values")

    def against_plain(run, extra):
        """The kernel run against the plain version of the same engine,
        called directly on the data as the CLI loads it (and casts it,
        with TRAIN.BF16_PLANES), from the same seed."""
        cfg = get_config(cli.build_parser().parse_args(
            base + ["--output_dir", os.path.join(root, "train_plain")]
            + opts + extra))
        dataset, mu_p, residuals, val = cli._load_training_data(
            cfg, grid, torch.device("cuda"))
        if cfg.TRAIN.BF16_PLANES:
            residuals = bf16_planes(residuals)
        residuals, layout_kw = cli.resident_layout(dataset, residuals, grid,
                                                   torch.device("cuda"))
        check(bool(layout_kw), "the direct run did not take the derived "
              "layout")
        before = epoch_kernel.LAUNCHES
        t0 = time.perf_counter()
        _, hp = fit_fused(
            random_init(grid.npix, grid.nb, NH,
                        generator=torch.Generator().manual_seed(SEED)).cuda(),
            residuals, mu_p, cli.train_config(cfg), seed=SEED, val_data=val,
            plain=True, **layout_kw)
        plain_s = time.perf_counter() - t0
        check(epoch_kernel.LAUNCHES == before,
              "fit_fused(plain=True) launched the epoch kernel")
        hk = np.asarray(run["history"])
        rel = float(np.max(np.abs(hk - np.asarray(hp)) / np.abs(hp)))
        check(rel <= CLI_LOSS_RTOL, f"CLI train losses of the kernel and of "
              f"fit_fused(plain=True) differ by {rel:.3g}: {hk} vs {hp}")
        return rel, plain_s

    rel, plain_s = against_plain(run_k, [])

    # TRAIN.BF16_PLANES: the planes stay bfloat16 on the card and the
    # kernel reads them (no cast back to float32)
    out_b = os.path.join(root, "train_bf16_planes")
    before = epoch_kernel.LAUNCHES
    run_b = cli.main(base + ["--output_dir", out_b] + opts
                     + ["TRAIN.BF16_PLANES", "True"])
    check(run_b["engine"] == "kernel" and epoch_kernel.LAUNCHES > before,
          "CLI train with TRAIN.BF16_PLANES did not launch the epoch kernel")
    with open(os.path.join(out_b, "log.txt")) as f:
        check("capacity mode: bf16-stored delta/error planes" in f.read(),
              "CLI train with TRAIN.BF16_PLANES did not store bf16 planes")
    rel_b, _ = against_plain(run_b, ["TRAIN.BF16_PLANES", "True"])
    launches = epoch_kernel.LAUNCHES

    # TRAIN.ENGINE xla: the per-step trainer train.fit, as in the JAX CLI
    out_x = os.path.join(root, "train_fit")
    run_x = cli.main(base + ["--output_dir", out_x] + opts
                     + ["TRAIN.ENGINE", "xla"])
    check(epoch_kernel.LAUNCHES == launches,
          "TRAIN.ENGINE xla launched the epoch kernel")
    check(run_x["engine"] == "fit", f"xla run engine {run_x['engine']}")
    with open(os.path.join(out_x, "log.txt")) as f:
        check("trainer engine: XLA trainer (train.fit" in f.read(),
              "TRAIN.ENGINE xla did not log the fit engine")
    with open(os.path.join(out_x, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    check(len(losses) == epochs and bool(np.isfinite(losses).all()),
          f"TRAIN.ENGINE xla losses {losses}")

    pred_catalog = os.path.join(root, "train-predict-catalog.csv")
    with open(pred_catalog, "w") as f:
        f.write("\n".join(names[:512]) + "\n")
    before = infer_kernel.LAUNCHES
    out_pred = os.path.join(root, "train_predict")
    timing = cli.main(["--type", "predict", "--catalog", pred_catalog,
                       "--data_dir", data_dir, "--output_dir", out_pred,
                       "--resume", model, "--device", "cuda"])
    check(infer_kernel.LAUNCHES > before and timing["n"] == 512,
          "predict from the trained model did not run the kernel")
    with np.load(os.path.join(out_pred, "predict", names[0])) as r:
        check(all(bool(np.isfinite(r[k]).all()) for k in NPZ_KEYS.values()),
              "predictions from the trained model are not finite")
    return launches, run_k, run_x, rel, plain_s, run_b, rel_b


def phase_train_times(device, n=65536, batch=500, plain_reps=1, reps=3):
    """One epoch of n SDSS spectra at the CLI's batch and tiling, derived
    layout; kernel and plain version, bf16 operands on and off, and bf16
    operands on bf16 planes. Then one kernel epoch (bf16 operands) with no
    early launch, timed and under torch.profiler: device time and
    launches by kernel, busy share."""
    from qfa_tpu_torch.data.grid import make_grid
    from qfa_tpu_torch.ops import epoch_kernel
    from qfa_tpu_torch.ops.epoch_kernel import (
        fused_train_epoch,
        fused_train_epoch_plain,
    )
    from qfa_tpu_torch.train import adam, pick_tiling

    grid = make_grid(**SDSS)
    params, mu = seeded_params(grid, device)
    n_batches = -(-n // batch)
    data = pad_rows(train_problem(grid, params, mu, n, SEED + 41),
                    n_batches * batch - n)
    tb, _ = pick_tiling(batch)
    zq, _, kw = layout(grid, data, "derived")
    st = adam.init(params)
    perm = torch.randperm(n_batches * batch // tb,
                          generator=torch.Generator().manual_seed(SEED))
    out = {}
    for label, mxu, dtype in (("bf16 operands", True, torch.float32),
                              ("f32 operands", False, torch.float32),
                              ("bf16 operands, bf16 planes", True,
                               torch.bfloat16)):
        args = (params, st.m, st.v, data["delta"].to(dtype),
                data["error"].to(dtype), zq, perm)
        kw2 = dict(kw, epoch=0, n_batches=n_batches, tile_batch=tb,
                   mxu_bf16=mxu)
        runs = {"kernel": lambda: fused_train_epoch(*args, **kw2),
                "plain": lambda: fused_train_epoch_plain(*args, **kw2)}
        # the warm-up outputs, held against each other
        got, want = runs["kernel"](), runs["plain"]()
        torch.cuda.synchronize()
        err, detail = compare_epoch(
            f"one epoch of {n} spectra, {label}", got, want,
            f"bf16, {n_batches} updates" if mxu else "f32")
        samples = {"kernel": [], "plain": []}
        for order in (("plain", "kernel"), ("kernel", "plain")):
            for which in order:
                samples[which].append(time_cuda(
                    runs[which], reps if which == "kernel" else plain_reps))
        out[label] = {k: statistics.median(v) for k, v in samples.items()}
        out[label].update(max_abs_err=err, detail=detail)
    # the stages of one kernel epoch (bf16 operands, float32 planes), each
    # kernel launched when the one before it has ended: with the early
    # launch, a kernel's span would count its wait for the one before
    args = (params, st.m, st.v, data["delta"], data["error"], zq, perm)
    kw2 = dict(kw, epoch=0, n_batches=n_batches, tile_batch=tb, mxu_bf16=True)
    epoch_kernel.EARLY_LAUNCH = False
    try:
        alone = fused_train_epoch(*args, **kw2)
        ms_alone = time_cuda(lambda: fused_train_epoch(*args, **kw2), reps)
        # a trace that lost a kernel's event cannot show the launches per
        # batch (the profiler drops events now and then, as phase 12's
        # whole-run traces showed); trace again, up to PROFILE_TRIES
        for tries in range(1, PROFILE_TRIES + 1):
            _, by_name, _, busy, counts = profile_run(
                lambda: fused_train_epoch(*args, **kw2))
            seen = {}
            for k, c in (counts or {}).items():
                short = re.search(r"\w+_kernel", k)
                if short:
                    seen[short[0]] = seen.get(short[0], 0) + c
            if by_name is None or all(seen.get(k) == n_batches
                                      for k in EPOCH_STAGES):
                break
    finally:
        epoch_kernel.EARLY_LAUNCH = True
    early = fused_train_epoch(*args, **kw2)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(epoch_tensors(alone),
                                                 epoch_tensors(early))),
          "the epoch kernel's results depend on the early launch")
    stages = None if by_name is None else {}
    for k, v in (by_name or {}).items():  # ms and launches by short name
        short = (re.search(r"\w+_kernel", k) or re.match(".{0,40}", k))[0]
        ms, calls = stages.get(short, (0.0, 0))
        stages[short] = (ms + v * 1e3, calls + counts[k])
    out["profile"] = dict(stages=stages, busy=busy, ms_alone=ms_alone,
                          tries=tries)
    return out, n, n_batches, tb


def step_batch(data, n_real=None):
    """A SpectraBatch of the drawn planes; with ``n_real``, the stream's
    tail batch: the first n_real rows, then weight-0 copies of row 0."""
    from qfa_tpu_torch.data.batch import SpectraBatch

    n = data["delta"].shape[0]
    idx = torch.arange(n, device=data["delta"].device)
    weight = torch.ones(n, device=idx.device)
    if n_real is not None:
        idx[n_real:] = 0
        weight[n_real:] = 0.0
    return SpectraBatch(delta=data["delta"][idx], error=data["error"][idx],
                        zabs=data["zabs"][idx], mask=data["mask"][idx],
                        weight=weight)


def grad_rel(a, b):
    """max|a - b| / max|b| of each gradient."""
    out = {}
    for k in PARAM_NAMES:
        x = getattr(a.grads, k).detach().cpu()
        y = getattr(b.grads, k).detach().cpu()
        out[k] = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
    return out


def compare_step(name, got, want, loss_rtol, grad_rel_lim):
    """Step kernel against plain outputs: loss sum (relative), counts
    exact, gradient k to atol grad_rel_lim[k] * max|g|. Returns the max
    abs gradient error, the per-gradient readings and the failures."""
    bad = []
    lk, lp = float(got.loss_sum), float(want.loss_sum)
    rel = abs(lk - lp) / abs(lp)
    if not (np.isfinite(lk) and rel <= loss_rtol):
        bad.append(f"loss sums differ by {rel:.3g} ({lk!r} vs {lp!r})")
    if not (torch.equal(got.counts.pix, want.counts.pix)
            and float(got.counts.scalar) == float(want.counts.scalar)):
        bad.append("counts differ")
    worst = 0.0
    for k in PARAM_NAMES:
        a = getattr(got.grads, k).detach()
        if not bool(torch.isfinite(a).all()):
            bad.append(f"grads.{k} not finite")
        worst = max(worst, float((a - getattr(want.grads, k)).abs().max()))
    readings = grad_rel(got, want)
    bad += [f"grads.{k} differ by {r:.3g} of max|g|"
            for k, r in readings.items() if not r <= grad_rel_lim[k]]
    return worst, rel, readings, [f"{name}: {b}" for b in bad]


def phase_step_vs_plain(device):
    """Each case: the kernel against the plain version on the card, and
    two readings beside it: the witness (the plain version on the CPU
    against itself on the card: same code, other float32 summation order)
    and the control (the plain version with one real row's weight set to
    0, what a kernel that dropped a row would give)."""
    from qfa_tpu_torch.data.grid import make_grid
    from qfa_tpu_torch.models.params import QFAParams
    from qfa_tpu_torch.ops.fused_step import (
        fused_loss_grads,
        fused_loss_grads_plain,
    )

    worst, failures = 0.0, []
    # (label, grid, rows, real rows or None, regime, tau law, nh)
    cases = [("SDSS tail batch", SDSS, 500, 384, "moderate", "becker", NH),
             ("DESI", DESI, 128, None, "moderate", "becker", NH),
             ("SDSS low-noise tail batch", SDSS, 500, 384, "low-noise",
              "becker", NH)]
    cases += [(f"SDSS {law}", SDSS, 64, None, "moderate", law, NH)
              for law in TAU_LAWS]
    # a small tail batch per nh: with few real rows, leaving one out moves
    # every gradient well past its limit (at 53 real rows the control moved
    # nh 10's dtau0 by only 1.77e-4 of max|g| on an H100)
    cases += [(f"SDSS nh={nh} tail batch", SDSS, 24, 19, "moderate",
               "becker", nh) for nh in range(1, 11)]
    for label, grid_kw, n, n_real, regime, law, nh in cases:
        grid = make_grid(**grid_kw)
        params, mu = seeded_params(grid, device, regime, nh)
        batch = step_batch(train_problem(grid, params, mu, n, SEED + 61 + n,
                                         regime), n_real)
        got = fused_loss_grads(params, batch, tau_which=law)
        again = fused_loss_grads(params, batch, tau_which=law)
        torch.cuda.synchronize()
        if not (torch.equal(got.loss_sum, again.loss_sum)
                and torch.equal(got.counts.pix, again.counts.pix)
                and torch.equal(got.counts.scalar, again.counts.scalar)
                and all(torch.equal(getattr(got.grads, k),
                                    getattr(again.grads, k))
                        for k in PARAM_NAMES)):
            failures.append(f"{label}: a second call is not bitwise equal "
                            "to the first")
        want = fused_loss_grads_plain(params, batch, tau_which=law)
        torch.cuda.synchronize()
        low = regime == "low-noise"
        lim = LOW_NOISE_GRAD_REL if low else STEP_GRAD_REL
        err, rel, readings, bad = compare_step(
            label, got, want, LOW_NOISE_LL_RTOL if low else STEP_LOSS_RTOL,
            lim)
        failures += bad
        if n_real is not None and not (
                float(got.counts.scalar) <= n_real
                and float(got.counts.pix.max()) <= n_real):
            failures.append(f"{label}: weight-0 rows were counted")
        cpu = fused_loss_grads_plain(
            QFAParams(**{k: getattr(params, k).detach().cpu()
                         for k in PARAM_NAMES}),
            type(batch)(*(t.cpu() for t in batch)), tau_which=law)
        witness = grad_rel(cpu, want)
        weight = batch.weight.clone()
        weight[1] = 0.0
        control = grad_rel(fused_loss_grads_plain(
            params, batch._replace(weight=weight), tau_which=law), want)
        failures += [f"{label}: the control moves grads.{k} by only "
                     f"{control[k]:.3g}, inside its limit {lim[k]:g}"
                     for k in PARAM_NAMES if not control[k] > lim[k]]
        worst = max(worst, err)
        say(f"  {label} ({regime}, {law}, nh {nh}): rows={n} real="
            f"{n if n_real is None else n_real} npix={grid.npix}; loss rel "
            f"{rel:.2e}; counts exact; a second call bitwise equal; grads "
            f"max_abs_err={err!r}; "
            "max|kernel - plain| / max|plain| (witness, control): "
            + ", ".join(f"{k} {readings[k]:.2e} ({witness[k]:.2e}, "
                        f"{control[k]:.2e})" for k in PARAM_NAMES))
    check(not failures, "; ".join(failures))
    return worst


def streaming_problem(device, n=16384, n_val=512):
    """n SDSS-width training spectra in host RAM (HostResiduals, numpy)
    and n_val held-out spectra (a CPU ResidualDataset), drawn on the card;
    start parameters and mu on the CPU."""
    from qfa_tpu_torch.data.grid import make_grid
    from qfa_tpu_torch.data.loader import ResidualDataset
    from qfa_tpu_torch.data.streaming import HostResiduals

    grid = make_grid(**SDSS)
    params, mu = seeded_params(grid, device)
    data = train_problem(grid, params, mu, n + n_val, SEED + 51)
    planes = ("delta", "error", "zabs", "mask")
    host = HostResiduals(*(data[k][:n].cpu().numpy() for k in planes))
    val = ResidualDataset(*(data[k][n:].cpu() for k in planes))
    params, mu = seeded_params(grid, torch.device("cpu"))
    return grid, host, val, params, mu


def phase_streaming(root, problem, device):
    """The streaming main path on the step kernel, counted from zero; then
    the same run on the plain step and one epoch on the autograd step."""
    import logging

    from qfa_tpu_torch.ops import epoch_kernel, fused_step, infer_kernel
    from qfa_tpu_torch.train import (
        TrainConfig,
        fit_streaming,
        make_fused_step_fn,
    )

    grid, host, val, params, mu = problem
    cfg = TrainConfig(n_epochs=2, batch_size=500, save_interval=1,
                      smooth_interval=1, stop_on_negative_loss=False)
    logger = logging.getLogger("chip_smoke.streaming")
    logger.setLevel(logging.INFO)
    messages = []

    class Keep(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    logger.addHandler(Keep())
    out_k = os.path.join(root, "stream_kernel")
    t0 = time.perf_counter()
    # the streaming path's launches are counted from here ...
    fused_step.LAUNCHES = epoch_kernel.LAUNCHES = infer_kernel.LAUNCHES = 0
    pk, hk = fit_streaming(params, host, mu, cfg, seed=SEED,
                           step_fn=make_fused_step_fn(cfg),
                           output_dir=out_k, val_data=val, logger=logger,
                           device=device)
    launches = fused_step.LAUNCHES  # ... to here
    wall_k = time.perf_counter() - t0
    n_batches = -(-host.size // cfg.batch_size)
    check(launches == cfg.n_epochs * n_batches,
          f"fit_streaming launched the step kernel {launches} times, "
          f"expected {cfg.n_epochs * n_batches}")
    check(epoch_kernel.LAUNCHES == 0 and infer_kernel.LAUNCHES == 0,
          "fit_streaming launched the epoch or the predict kernel")
    check(len(hk) == cfg.n_epochs and bool(np.isfinite(hk).all()),
          f"streaming losses {hk}")
    check(sum("val_loss" in m for m in messages) == cfg.n_epochs,
          "validation did not run every epoch")
    ckpts = sorted(os.listdir(os.path.join(out_k, "checkpoints")))
    check(ckpts == sorted(f"{kind}_epoch_{e:02d}.npz"
                          for kind in ("model_parameters", "state")
                          for e in range(1, cfg.n_epochs + 1)),
          f"checkpoints {ckpts}")
    with np.load(os.path.join(out_k, "checkpoints",
                              f"state_epoch_{cfg.n_epochs:02d}.npz")) as f:
        check(int(f["epoch"]) == cfg.n_epochs, "full state epoch counter")
        check(np.array_equal(f["F"], pk.F.detach().cpu().numpy()),
              "the last checkpoint is not the returned model")
    check(tuple(pk.F.shape) == (grid.npix, NH)
          and all(bool(torch.isfinite(getattr(pk, k)).all())
                  for k in PARAM_NAMES), "trained model has bad values")

    t0 = time.perf_counter()
    pp, hp = fit_streaming(params, host, mu, cfg, seed=SEED,
                           step_fn=make_fused_step_fn(cfg, plain=True),
                           device=device)
    wall_p = time.perf_counter() - t0
    check(fused_step.LAUNCHES == launches,
          "the plain step launched the step kernel")
    rel = float(np.max(np.abs(np.asarray(hk) - hp) / np.abs(hp)))
    check(rel <= CLI_LOSS_RTOL, f"streaming losses of the step kernel and "
          f"the plain step differ by {rel:.3g}: {hk} vs {hp}")
    t0 = time.perf_counter()
    _, ha = fit_streaming(params, host, mu,
                          TrainConfig(n_epochs=1, batch_size=500,
                                      stop_on_negative_loss=False),
                          seed=SEED, device=device)
    wall_a = time.perf_counter() - t0
    check(np.isfinite(ha[0]), "autograd streaming loss not finite")
    return dict(launches=launches, hk=hk, hp=hp, ha=ha, rel=rel,
                wall_k=wall_k, wall_p=wall_p, wall_a=wall_a,
                n_batches=n_batches)


def profile_run(run):
    """Run ``run()`` under torch.profiler. Returns (wall s, device time
    by kernel or copy name in s, H2D copy s, device busy share of the
    wall, device events by name); the last four are None when the
    profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    # a trace started right before the run loses the device events of its
    # first launches now and then (a whole state copy, or an epoch's first
    # forward); so the profiler first traces a warm-up step whose events
    # it drops, and records only the step after it
    warm = torch.zeros(256, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(8):
            warm.add_(1.0)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    # the step's own span on the device is a range, not device work
    dev = [e for e in prof.events()
           if getattr(e, "device_type", None) == DeviceType.CUDA
           and not e.name.startswith("ProfilerStep")]
    if not dev:
        return wall, None, None, None, None
    by_name, counts = {}, {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() * 1e-6
        counts[e.name] = counts.get(e.name, 0) + 1
    h2d = sum(v for k, v in by_name.items() if "HtoD" in k)
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    return wall, by_name, h2d, busy * 1e-6 / wall, counts


def phase_step_times(device, problem, reps=20):
    """One step at SDSS width and batch 500 (kernel, plain version,
    autograd loss_and_grads; the whole fused step function), and one
    streaming epoch of the problem's spectra on the step kernel."""
    from qfa_tpu_torch.data.streaming import stream_batches
    from qfa_tpu_torch.models.qfa import loss_and_grads
    from qfa_tpu_torch.ops import fused_step
    from qfa_tpu_torch.ops.fused_step import (
        fused_loss_grads,
        fused_loss_grads_plain,
    )
    from qfa_tpu_torch.train import TrainConfig, TrainState, adam
    from qfa_tpu_torch.train import make_fused_step_fn, make_step_fn

    grid, host = problem[:2]
    params, _ = seeded_params(grid, device)
    batch = step_batch({k: torch.from_numpy(getattr(host, k)[:500]).to(device)
                        for k in ("delta", "error", "zabs", "mask")})
    cfg = TrainConfig(batch_size=500)
    step = make_fused_step_fn(cfg)
    state = TrainState(params, adam.init(params))
    runs = {"kernel": lambda: fused_loss_grads(params, batch),
            "plain": lambda: fused_loss_grads_plain(params, batch),
            "autograd": lambda: loss_and_grads(params, batch),
            "step function": lambda: step(state, batch)}
    for fn in runs.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    # neither step function waits for the card: any synchronizing CUDA
    # call inside one raises in this mode
    autograd_step = make_step_fn(cfg)
    autograd_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state, batch)
        autograd_step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    samples = {k: [] for k in runs}
    for order in (tuple(runs), tuple(reversed(runs))):
        for which in order:
            samples[which].append(time_cuda(runs[which], reps))
    out = {k: statistics.median(v) for k, v in samples.items()}

    def epoch(seed):
        st = state
        for b in stream_batches(host, cfg.batch_size,
                                np.random.default_rng(seed), device=device):
            st, _ = step(st, b)
        return st

    # device time per launch of each of the step's kernels (one launch
    # each per call), each launched when the one before it has ended
    # (early launch off: with it, a kernel's span would count its wait for
    # the one before), and the call time by CUDA events in that mode
    calls = 20

    def short(name):
        return (re.search(r"\w+_kernel(<\d+>)?", name)
                or re.match(".{0,40}", name))[0]

    fused_step.EARLY_LAUNCH = False
    try:
        out["kernel alone"] = time_cuda(runs["kernel"], reps)
        _, stages, _, _, counts = profile_run(
            lambda: [fused_loss_grads(params, batch) for _ in range(calls)])
    finally:
        fused_step.EARLY_LAUNCH = True
    out["stages_us"] = None if stages is None else {
        short(k): v / counts[k] * 1e6 for k, v in stages.items()}
    out["stage_launches"] = None if stages is None else {
        short(k): counts[k] for k in stages}
    # with the early launch: the device's busy time per call (the union of
    # the kernels' spans; only when the profiler saw every launch), and the
    # wrapper's host time per call (calls enqueued back to back, host
    # clock)
    wall, _, _, busy, counts = profile_run(
        lambda: [fused_loss_grads(params, batch) for _ in range(calls)])
    seen = sorted(c for k, c in (counts or {}).items()
                  if re.search(r"(forward|backward|finish)_kernel", k))
    out["busy_us"] = busy * wall / calls * 1e6 \
        if busy is not None and seen == [calls] * 3 else None
    out["busy_seen"] = seen
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):  # few enough that no launch waits for the card
        fused_loss_grads(params, batch)
    out["host_us"] = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    epoch(0)  # warm-up (pinned staging buffers, streams)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch(1)
    torch.cuda.synchronize()
    out["epoch_wall_s"] = time.perf_counter() - t0
    _, _, out["h2d_s"], out["busy"], _ = profile_run(lambda: epoch(2))
    out["n"] = host.size
    return out, batch


def phase_alu(device, smi):
    """B4: the alu_chain kernel against its plain version for each op at
    n_iters 0, 1 and 3 over the (256, 1024) tile; one launch at the fma
    calibration's larger count, kernel and plain; then the calibration
    path (calibrate_peaks, calibrate_alu), its launches counted from
    zero."""
    from qfa_tpu_torch import calibrate
    from qfa_tpu_torch.ops import alu_chain as ac

    g = torch.Generator(device=device).manual_seed(SEED)
    x = 0.5 + 0.5 * torch.rand(calibrate.ALU_SHAPE, generator=g,
                               device=device)
    worst = 0.0
    for op in ac.OPS:
        for n_iters in (0, 1, 3):
            got = ac.alu_chain(x, n_iters, op)
            want = ac.alu_chain_plain(x, n_iters, op)
            torch.cuda.synchronize()
            check(got.shape == x.shape and bool(torch.isfinite(got).all()),
                  f"alu_chain {op} x{n_iters}: bad output")
            diff = (got - want).abs()
            rel = float((diff / want.abs()).max())
            limit = ALU_RTOL[op] if n_iters else 0.0
            check(rel <= limit, f"alu_chain {op} x{n_iters}: kernel and "
                  f"plain version differ by {rel:.3g} (relative)")
            worst = max(worst, float(diff.max()))
            say(f"  alu_chain {op}, n_iters {n_iters}, (256, 1024): max rel "
                f"err {rel:.2e} (limit {limit:g})")
    i1, i2 = calibrate.ALU_ITERS["fma"]
    ms = time_cuda(lambda: ac.alu_chain(x, i2, "fma"), 5)
    plain_ms = time_cuda(lambda: ac.alu_chain_plain(x, i2, "fma"), 1)

    # the calibration path's launches are counted from here ...
    zero_counts()
    t0 = time.perf_counter()
    f32, bf16, read = calibrate.calibrate_peaks(device)
    alu = calibrate.calibrate_alu(device)
    launches = ac.LAUNCHES  # ... to here
    check(launches >= 1, "calibrate_alu launched no alu_chain kernel")
    check(other_counts(ac) == 0, "the calibration launched another kernel")
    parts = [f"f32 {f32:.2f} TFLOP/s ({f32 * 1e12 / FP32_FLOP_PER_S:.1%} "
             "of 67 published)",
             f"bf16 {bf16:.1f} TFLOP/s ({bf16 * 1e12 / BF16_FLOP_PER_S:.1%} "
             "of 989 dense)",
             f"read {read:.1f} GB/s ({read * 1e9 / HBM_BYTES_PER_S:.1%} of "
             "3350)"]
    for op in ac.OPS:
        rate = alu[op]
        check(rate is not None and rate > 0, f"calibrate_alu {op}: no rate")
        delta = calibrate.alu_op_count(op, *calibrate.ALU_ITERS[op],
                                       x.numel()) / rate
        check(delta >= ALU_MIN_DELTA_S, f"calibrate_alu {op}: delta "
              f"{delta * 1e3:.3f} ms under {ALU_MIN_DELTA_S * 1e3:g} ms")
        share = (f", {rate / FP32_FLOP_PER_S:.1%} of 67 TFLOP/s"
                 if op == "fma" else ", no published rate")
        parts.append(f"{op} {rate / 1e12:.4f} Top/s (delta "
                     f"{delta * 1e3:.3f} ms{share})")
    say(f"phase 13 calibration ({smi}): " + "; ".join(parts)
        + f"; {launches} alu_chain launch(es); "
        f"{time.perf_counter() - t0:.1f} s")
    n_ops = calibrate.alu_op_count("fma", 0, i2, x.numel())
    return dict(launches=launches, worst=worst, ms=ms, plain_ms=plain_ms,
                bound=bound(2 * nbytes(x), n_ops), i2=i2)


def phase_kdepth(device, smi):
    """B5: the contraction probe against its plain version, every variant
    at grid 3 and at the probe's grid (with the float64 witness and the
    last-step-left-out control), each with a repeat call bitwise equal and
    its device time growing with the grid, and timed per call with the
    chunks the library picks and with one chunk; times of pair36+8's plain
    version and of the torch.addmm yardstick; then the probe tool, its
    launches counted from zero."""
    from qfa_tpu_torch.ops import _build
    from qfa_tpu_torch.ops import kdepth as kd
    from qfa_tpu_torch.tools import mxu_kdepth

    pool_l, pool_lt, r, r2 = mxu_kdepth.make_operands(1, device)
    ops = (pool_l[0], pool_lt[0], r, r2)
    lib = _build.load_library()
    index = torch.cuda.current_device()
    worst = 0.0
    times = {}

    def rel_err(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    for name, k1, k2, vpu_k2 in kd.VARIANTS:
        kw = dict(k1=k1, k2=k2, vpu_k2=vpu_k2)
        got = kd.contraction_probe(*ops, **kw, grid=3)
        again = kd.contraction_probe(*ops, **kw, grid=3)
        want = kd.contraction_probe_plain(*ops, **kw, grid=3)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"probe {name}: not finite")
        rel = rel_err(got, want)
        check(rel <= KDEPTH_REL, f"probe {name}, grid 3: kernel and plain "
              f"version differ by {rel:.3g} of max|out|")
        check(torch.equal(again, got), f"probe {name}, grid 3: a repeat "
              "call differs")
        worst = max(worst, float((got - want).abs().max()))

        full = dict(kw, grid=KDEPTH_GRID)
        got = kd.contraction_probe(*ops, **full)
        again = kd.contraction_probe(*ops, **full)
        want = kd.contraction_probe_plain(*ops, **full)
        ref = kd.contraction_probe_plain(*(t.double() for t in ops), **full)
        control = rel_err(kd.contraction_probe_plain(
            *ops, **dict(full, grid=KDEPTH_GRID - 1)), want)
        torch.cuda.synchronize()
        rel_full, witness = rel_err(got, want), rel_err(want, ref)
        check(bool(torch.isfinite(got).all()), f"probe {name}, grid "
              f"{KDEPTH_GRID}: not finite")
        check(rel_full <= KDEPTH_FULL_REL, f"probe {name}, grid "
              f"{KDEPTH_GRID}: kernel and plain version differ by "
              f"{rel_full:.3g} of max|out|")
        check(control > KDEPTH_FULL_REL, f"probe {name}: control "
              f"{control:.3g} inside the limit {KDEPTH_FULL_REL:g}")
        check(torch.equal(again, got), f"probe {name}, grid {KDEPTH_GRID}: "
              "a repeat call differs")
        worst = max(worst, float((got - want).abs().max()))

        chunks = kd._chunks(lib, (kd.TB, kd.P, k1, k2 or 0,
                                  kd._MODE[vpu_k2], KDEPTH_GRID), index)
        # per call from an idle device, the host's time to launch it
        # included, as every kernel of the `kernels` line is timed
        ms = time_cuda(lambda: kd.contraction_probe(*ops, **full), 5)
        # device time per call for the grows-with-the-grid check: at an
        # eighth of the grid single8 takes ~0.07 ms on the device, and the
        # host's time to launch it would count there
        dev = time_cuda_queued(lambda: kd.contraction_probe(*ops, **full), 5)
        dev_8th = time_cuda_queued(lambda: kd.contraction_probe(
            *ops, **dict(full, grid=KDEPTH_GRID // 8)), 5)
        check(dev >= 4 * dev_8th, f"probe {name}: time does not grow with "
              f"the grid: {dev!r} ms at {KDEPTH_GRID} steps, {dev_8th!r} ms "
              f"at {KDEPTH_GRID // 8} (on the device)")
        one = kd._launch(*ops, k1, k2, vpu_k2, KDEPTH_GRID, chunks=1)
        torch.cuda.synchronize()
        rel_one = rel_err(one, want)
        check(rel_one <= KDEPTH_FULL_REL, f"probe {name}, one chunk: "
              f"kernel and plain version differ by {rel_one:.3g}")
        ms_one = time_cuda(lambda: kd._launch(
            *ops, k1, k2, vpu_k2, KDEPTH_GRID, chunks=1), 5)
        times[name] = ms
        say(f"  probe {name}: grid 3 {rel:.2e} (limit {KDEPTH_REL:g}); grid "
            f"{KDEPTH_GRID} {rel_full:.2e} (limit {KDEPTH_FULL_REL:g}; "
            f"witness plain float32 vs float64 {witness:.2e}, kernel vs "
            f"float64 {rel_err(got, ref):.2e}, control {control:.2e}); "
            f"repeat calls bitwise equal; {chunks} chunks: {ms!r} ms per "
            f"call ({ms / KDEPTH_GRID * 1e3:.4f} us per step); on the "
            f"device {dev!r} ms, {dev_8th!r} ms at grid {KDEPTH_GRID // 8}; "
            f"one chunk: {ms_one!r} ms per call ({rel_one:.2e} from plain)")

    _, k1, k2, vpu_k2 = kd.VARIANTS[0]  # pair36+8
    kw = dict(k1=k1, k2=k2, vpu_k2=vpu_k2, grid=KDEPTH_GRID)
    want = kd.contraction_probe_plain(*ops, **kw)
    plain_ms = time_cuda(lambda: kd.contraction_probe_plain(*ops, **kw), 1)
    # yardstick, never called by the port: one torch.addmm per step,
    # o += s_j (L[:44]^T @ (w R[:44])) with w 0.5 on the 36 dw rows and
    # 0.25 on the 8 du rows (TF32 off since phase 1)
    lt44 = ops[0][:44].T.contiguous()
    rw = r[:44] * torch.cat([torch.full((36, 1), 0.5, device=device),
                             torch.full((8, 1), 0.25, device=device)])
    scales = [kd.step_scale(j) for j in range(KDEPTH_GRID)]
    o = torch.zeros((kd.TB, kd.P), device=device)

    def addmm_loop():
        o.zero_()
        for s_j in scales:
            o.addmm_(lt44, rw, alpha=s_j)
        return o

    eager_ms = time_cuda(addmm_loop, 3)
    # the loop captured once in a CUDA graph and replayed: cuBLAS's time
    # per step, without the host's 4096 launches (eager_ms above)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        addmm_loop()  # warm-up on a side stream, as capture needs
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        addmm_loop()
    library_ms = time_cuda(graph.replay, 3)
    lib_rel = rel_err(o, want)

    # the probe tool's launches are counted from here ...
    zero_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kdepth_") as tmp:
        record = mxu_kdepth.main(["--out", tmp])
        check(os.path.isfile(os.path.join(tmp, mxu_kdepth.RECORD_NAME)),
              "the probe wrote no record")
    launches = kd.LAUNCHES  # ... to here
    check(launches >= 1, "the probe launched no kdepth kernel")
    check(other_counts(kd) == 0, "the probe launched another kernel")
    check(record["grid"] == KDEPTH_GRID, "the probe's grid")
    ms = times["pair36+8"]
    # bound: the 44 rows of l and r the variant reads and the output once;
    # 2 * TB * P * 44 operations per step, three TF32 passes of them
    n_bytes = 4 * (44 * kd.TB + 44 * kd.P + kd.TB * kd.P)
    bnd = bound(n_bytes, 3 * 2 * kd.TB * kd.P * 44 * KDEPTH_GRID,
                TF32_FLOP_PER_S)
    per = ", ".join(f"{k} {v['us_per_step']!r}"
                    for k, v in record["variants"].items())
    say(f"phase 14 probe ({smi}): us per step: {per}; "
        f"k_scaling_128_over_8 {record['k_scaling_128_over_8']!r}, "
        f"flat_in_k {record['flat_in_k']}; f32 peak "
        f"{record['mxu_peak_tflops_f32']!r} TFLOP/s; pair36+8 at grid "
        f"{KDEPTH_GRID}: kernel {ms!r} ms per call ({bnd[0] / ms:.3f} of its "
        f"tensor-core bound {bnd[0]:.4f} ms), plain {plain_ms!r} ms, "
        f"torch.addmm per step {library_ms!r} ms in a CUDA graph, "
        f"{eager_ms!r} ms launched from the host (its result {lib_rel:.2e} "
        f"of max|out| from the plain version); {launches} kdepth launches; "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(launches=launches, worst=worst, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound=bnd)


#: B2d, the epoch kernel's window mode (phase 15), against its plain
#: version: each window's state and loss rows to phase 7's EPOCH_LIMITS of
#: the operand mode; its exported pending buffer part by part, norm-wise:
#: the books (loss sum, has-blue rows, n_real) to the mode's loss limit,
#: the update blocks' scalar sums and the accumulator rows (a batch's
#: gradient sums) to the mode's moments limit (after one update the first
#: moment is (1 - b1) times the gradient). At one rank a window's export,
#: summed over the rank and applied by the next call, is the batch's own
#: update: sync_dp then equals the plain kernel epoch bit for bit.
WINDOW_KS = (1, 3, 8)
#: phase 16, two ranks on the one card over gloo: the parameters after one
#: epoch against the plain composition of the same global batches (each
#: global batch the union of the ranks' local batches), run on one device:
#: exact DP (K = 1) against the single-device kernel epoch on the composed
#: tile permutation, to phase 7's bf16 limits (the same sums in another
#: order); K = 2 and 16 (local updates inside a window, the state
#: averaged at its end) and local SGD against the same window and epoch calls
#: made rank by rank in one process and summed as the all_reduce sums
#: them, norm-wise 1e-6 (two addends sum the same in any order, so equal
#: bits are expected and reported); fit(mesh=) per-batch DP, both
#: engines, against the single-device autograd epoch on the composed
#: batches: losses CLI_LOSS_RTOL, parameters norm-wise 1e-4 (phase 7's
#: f32 moments limit: four Adam steps from gradients summed in another
#: order, and for the step kernel from the analytic backward);
#: prediction bitwise (a row's outputs do not depend on its batch).
DIST_STATE_REL = 1e-6
DIST_FIT_REL = 1e-4


def pending_parts(npix, nh):
    from qfa_tpu_torch.ops import epoch_kernel

    n_up = 3 * epoch_kernel._n_upd_pad(npix)
    return {"block sums": slice(0, n_up), "books": slice(n_up, n_up + 4),
            "rows": slice(n_up + 4, epoch_kernel.pending_len(npix, nh))}


def compare_pending(name, got, want, mode, npix, nh=NH):
    """A window's exported pending buffer, kernel against plain; returns
    the worst norm-wise error of its parts."""
    lim = EPOCH_LIMITS[mode]
    check(got.shape == want.shape, f"{name}: pending shape {got.shape}")
    worst = {}
    for part, sl in pending_parts(npix, nh).items():
        a, b = got[sl], want[sl]
        check(bool(torch.isfinite(a).all()), f"{name}: pending {part} not "
              "finite")
        r = norm_rel(a, b)
        lim_p = lim["loss"] if part == "books" else lim["moments"]
        check(r <= lim_p, f"{name}: pending {part} norm-wise error {r:.3g}"
              f" above {lim_p}")
        worst[part] = r
    return worst


def run_windows(fn, params, m, v, planes, mask, perm, kw, n_batches, tpb,
                K):
    """One epoch through windows of K batches and the flush, each call on
    the pending buffer of the one before: the calls' outputs."""
    outs, pend = [], None
    for lo in range(0, n_batches, K):
        k = min(K, n_batches - lo)
        out = fn(params, m, v, *planes, perm[lo * tpb:(lo + k) * tpb], mask,
                 n_batches=k, tiles_per_batch=tpb, sync_grads=True,
                 pending=pend, apply_pending=int(pend is not None), **kw)
        outs.append(out)
        params, m, v, pend = out.params, out.m, out.v, out.pending
    outs.append(fn(params, m, v, *planes, perm[:0], mask, n_batches=0,
                   tiles_per_batch=tpb, sync_grads=True, pending=pend,
                   apply_pending=1, **kw))
    return outs


def outputs_equal(a, b):
    """Every tensor of two window calls' outputs (pending too) equal."""
    same = all(torch.equal(x, y) for x, y in zip(epoch_tensors(a),
                                                  epoch_tensors(b)))
    if a.pending is None or b.pending is None:
        return same and a.pending is b.pending
    return same and torch.equal(a.pending, b.pending)


def window_problem(grid_kw, n, device, seed):
    from qfa_tpu_torch.data.grid import make_grid
    from qfa_tpu_torch.train import adam

    grid = make_grid(**grid_kw)
    params, mu = seeded_params(grid, device)
    return grid, params, adam.init(params), train_problem(grid, params, mu,
                                                          n, seed)


def phase_window_vs_plain(device, mesh):
    """B2d on the card: every window call (K 1, 3 with a remainder window,
    8) of an SDSS epoch and its flush, kernel against plain version on the
    same CUDA tensors, in both layouts, float32 and bfloat16 planes, bf16
    operands off and on; a repeat call bitwise; a DESI window; then
    sync_dp at one rank (NCCL) at K 1 and 16 against the plain kernel
    epoch on the same permutation, bitwise."""
    from qfa_tpu_torch.data.loader import ResidualDataset
    from qfa_tpu_torch.ops import epoch_kernel
    from qfa_tpu_torch.ops.epoch_kernel import (
        fused_train_epoch,
        fused_train_epoch_plain,
    )
    from qfa_tpu_torch.parallel import make_sync_dp_epoch_fn
    from qfa_tpu_torch.train import TrainConfig, TrainState, adam, pick_tiling

    worst = 0.0
    n, batch, tile = 4096, 512, 64
    tpb, n_batches = batch // tile, n // batch
    grid, params, st, data = window_problem(SDSS, n, device, SEED + 51)
    perm = torch.randperm(n // tile, generator=torch.Generator().manual_seed(
        SEED + 5))
    both = (torch.float32, torch.bfloat16)
    for K in WINDOW_KS:
        for name, dtype, mxu in itertools.product(("derived", "plane"), both,
                                                  (False, True)):
            zabs, mask, kw = layout(grid, data, name)
            planes = (data["delta"].to(dtype), data["error"].to(dtype), zabs)
            kw2 = dict(kw, epoch=2, tile_batch=tile, mxu_bf16=mxu)
            args = (params, st.m, st.v, planes, mask, perm, kw2, n_batches,
                    tpb, K)
            before = epoch_kernel.WINDOW_LAUNCHES
            got = run_windows(fused_train_epoch, *args)
            check(epoch_kernel.WINDOW_LAUNCHES - before == len(got),
                  "a window call did not count one window launch")
            want = run_windows(fused_train_epoch_plain, *args)
            torch.cuda.synchronize()
            mode = "bf16" if mxu else "f32"
            case = (f"SDSS {name} layout, "
                    f"{'bf16' if dtype == torch.bfloat16 else 'f32'} "
                    f"planes, {mode} operands, K={K}")
            err, pend = 0.0, {}
            for j, (a, b) in enumerate(zip(got, want)):
                e, detail = compare_epoch(f"{case} call {j}", a, b, mode,
                                          starts_epoch=j == 0)
                err = max(err, e)
                if b.pending is None:
                    check(a.pending is None, f"{case}: the flush exported")
                    continue
                for part, r in compare_pending(f"{case} call {j}",
                                               a.pending, b.pending, mode,
                                               grid.npix).items():
                    pend[part] = max(pend.get(part, 0.0), r)
            worst = max(worst, err)
            say(f"  {case}: {len(got) - 1} windows and the flush, each "
                f"against the plain version: params max_abs_err={err!r}; "
                f"the last call: {detail}; exported pending norm-wise "
                + ", ".join(f"{k} {v:.2e}" for k, v in pend.items()))
    # a repeat call, bitwise (a window that applies a pending and exports)
    zabs, mask, kw = layout(grid, data, "derived")
    kw2 = dict(kw, epoch=2, tile_batch=tile, mxu_bf16=True)
    first = fused_train_epoch(params, st.m, st.v, data["delta"],
                              data["error"], zabs, perm[:3 * tpb], mask,
                              n_batches=3, tiles_per_batch=tpb,
                              sync_grads=True, **kw2)
    calls = [fused_train_epoch(
        first.params, first.m, first.v, data["delta"], data["error"], zabs,
        perm[3 * tpb:6 * tpb], mask, n_batches=3, tiles_per_batch=tpb,
        sync_grads=True, pending=first.pending, apply_pending=1, **kw2)
        for _ in range(2)]
    torch.cuda.synchronize()
    check(outputs_equal(*calls), "a repeat window call differs")
    say("  SDSS derived layout, bf16 operands: a repeat window call (apply,"
        " 3 batches, export) is bitwise equal to the first")
    # DESI width, one window of the epoch's two batches, and the flush
    dgrid, dparams, dst, ddata = window_problem(DESI, 512, device, SEED + 52)
    dperm = torch.randperm(8, generator=torch.Generator().manual_seed(SEED))
    for name, mxu in (("derived", True), ("plane", False)):
        zabs, mask, kw = layout(dgrid, ddata, name)
        kw2 = dict(kw, epoch=0, tile_batch=64, mxu_bf16=mxu)
        args = (dparams, dst.m, dst.v, (ddata["delta"], ddata["error"], zabs),
                mask, dperm, kw2, 2, 4, 2)
        got = run_windows(fused_train_epoch, *args)
        want = run_windows(fused_train_epoch_plain, *args)
        torch.cuda.synchronize()
        mode = "bf16" if mxu else "f32"
        err, _ = compare_epoch("DESI window", got[0], want[0], mode)
        pend = compare_pending("DESI window", got[0].pending,
                               want[0].pending, mode, dgrid.npix)
        err2, detail = compare_epoch("DESI flush", got[1], want[1], mode,
                                     starts_epoch=False)
        worst = max(worst, err, err2)
        say(f"  DESI {name} layout, {mode} operands: 512 spectra, one "
            f"window of 2 batches (256 rows, tile 64) and the flush: params "
            f"max_abs_err={max(err, err2)!r}; {detail}; pending norm-wise "
            + ", ".join(f"{k} {v:.2e}" for k, v in pend.items()))
    # sync_dp at one rank against the plain kernel epoch, bitwise
    n, batch = 8192, 500
    tb = pick_tiling(batch)[0]
    n_batches = -(-n // batch)
    grid, params, st, data = window_problem(SDSS, n, device, SEED + 53)
    data = pad_rows(data, n_batches * batch - n)
    zq, _, kw = layout(grid, data, "derived")
    perm = torch.randperm(n_batches * batch // tb,
                          generator=torch.Generator().manual_seed(SEED + 6))
    cfg = TrainConfig(batch_size=batch, mxu_bf16=True)
    ref = fused_train_epoch(params, st.m, st.v, data["delta"], data["error"],
                            zq, perm, epoch=0, n_batches=n_batches,
                            tile_batch=tb, mxu_bf16=True, **kw)
    ref_loss = float((ref.loss_sums / ref.n_real.clamp(min=1.0)).sum()
                     / (n // batch))
    shard = ResidualDataset(delta=data["delta"], error=data["error"],
                            zabs=zq, mask=None)
    for K in (1, 16):
        fn = make_sync_dp_epoch_fn(cfg, mesh, batches_per_launch=K,
                                   tile_batch=tb, batch_rows=batch,
                                   loglam=kw["loglam"], n_real=n)
        before = epoch_kernel.WINDOW_LAUNCHES
        out, loss = fn(TrainState(params, st), shard, perm)
        torch.cuda.synchronize()
        calls = epoch_kernel.WINDOW_LAUNCHES - before
        check(calls == -(-n_batches // K) + 1,
              f"sync_dp K={K} made {calls} window calls")
        same = all(
            torch.equal(getattr(a, k).detach(), getattr(b, k).detach())
            for a, b in ((out.params, ref.params), (out.opt_state.m, ref.m),
                         (out.opt_state.v, ref.v)) for k in PARAM_NAMES)
        check(same, f"sync_dp at one rank, K={K}, differs from the plain "
              "kernel epoch")
        check(abs(float(loss) - ref_loss) <= 1e-6 * abs(ref_loss),
              f"sync_dp K={K} loss {float(loss)} against {ref_loss}")
        say(f"  sync_dp at one rank (NCCL), SDSS, {n} spectra, batch "
            f"{batch} ({n_batches} batches, tile {tb}), bf16 operands, K={K}:"
            f" {calls} window calls; params and moments bitwise equal to "
            f"the plain kernel epoch on the same permutation; loss "
            f"{float(loss)!r} (epoch {ref_loss!r})")
    return worst


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_problem(device):
    """Phase 16's problem, the same on every rank (drawn on the card from a
    seed): SDSS parameters; 4096 spectra in the derived layout for the
    epoch engines; 1024 in the plane layout for fit; 1000 for predict."""
    from qfa_tpu_torch.data.grid import make_grid
    from qfa_tpu_torch.data.loader import ResidualDataset, SpectraDataset
    from qfa_tpu_torch.ops.common import loglam_row

    grid = make_grid(**SDSS)
    params, mu = seeded_params(grid, device)
    d = train_problem(grid, params, mu, 4096, SEED + 61)
    derived = ResidualDataset(delta=d["delta"], error=d["error"],
                              zabs=d["zq"], mask=None)
    p = train_problem(grid, params, mu, 1024, SEED + 62)
    plane = ResidualDataset(delta=p["delta"], error=p["error"],
                            zabs=p["zabs"], mask=p["mask"])
    flux, error, mask, zq = draw_spectra(params, mu, grid, 1000, SEED + 63)
    host = SpectraDataset(
        flux=(flux * mask).cpu().numpy(), error=(error * mask).cpu().numpy(),
        mask=mask.cpu().numpy() > 0, zqso=zq.cpu().numpy(), paths=())
    return dict(grid=grid, params=params, mu=mu, derived=derived,
                loglam=loglam_row(grid.wav, device=device), plane=plane,
                host=host)


#: phase 16's runs of the epoch engines: one epoch of 4096 spectra, batch
#: 512, tile 64, bf16 operands (the CLI's default), derived layout
DIST_CFG = dict(n_epochs=1, batch_size=512, smooth_interval=5,
                save_interval=5, mxu_bf16=True)
DIST_RUNS = (("exact DP K=1", dict(dp_exact=True)),
             ("exact DP K=2", dict(dp_exact=True, batches_per_launch=2)),
             ("exact DP K=16", dict(dp_exact=True, batches_per_launch=16)),
             ("local SGD", dict()))
#: ... and of fit: one epoch of 1024 spectra, batch 256, plane layout
FIT_CFG = dict(n_epochs=1, batch_size=256, smooth_interval=5,
               save_interval=5)


def dist_runs(P, mesh):
    """The library entry points the CLI uses, on ``mesh``: fit_fused in
    each mode of DIST_RUNS, fit with both per-step engines, and
    predict_dataset_fused; each run's parameters (numpy), losses and
    kernel launches of this rank."""
    from qfa_tpu_torch.infer.predict import predict_dataset_fused
    from qfa_tpu_torch.ops import epoch_kernel, fused_step, infer_kernel
    from qfa_tpu_torch.train import TrainConfig, fit, fit_fused

    out = {}

    def counts():
        return (epoch_kernel.LAUNCHES, epoch_kernel.WINDOW_LAUNCHES,
                fused_step.LAUNCHES, infer_kernel.LAUNCHES)

    for label, kw in DIST_RUNS:
        if mesh.size == 1 and label == "exact DP K=2":
            continue
        c0 = counts()
        p, h = fit_fused(P["params"], P["derived"], P["mu"],
                         TrainConfig(**DIST_CFG), seed=SEED, tile_batch=64,
                         loglam=P["loglam"], mesh=mesh, **kw)
        out[label] = dict(params=p.to_numpy(), history=h, launches=[
            b - a for a, b in zip(c0, counts())])
    for engine in ("xla", "pallas"):
        c0 = counts()
        p, h = fit(P["params"], P["plane"], P["mu"], TrainConfig(**FIT_CFG),
                   seed=SEED, mesh=mesh, dp_engine=engine)
        out[f"fit {engine}"] = dict(params=p.to_numpy(), history=h,
                                    launches=[b - a for a, b in
                                              zip(c0, counts())])
    c0 = counts()
    res = predict_dataset_fused(P["params"], P["mu"], P["host"], P["grid"],
                                mesh=mesh)
    out["predict"] = dict(result=None if res is None else tuple(res),
                          launches=[b - a for a, b in zip(c0, counts())])
    return out


def params_rel(a, b):
    """Worst norm-wise error over the parameters (name -> array dicts)."""
    return max(float(np.linalg.norm(a[k] - b[k])
                     / max(np.linalg.norm(b[k]), 1e-30)) for k in PARAM_NAMES)


def params_equal(a, b):
    return all(np.array_equal(a[k], b[k]) for k in PARAM_NAMES)


def phase_dist_world1(device, mesh):
    """At world size 1 over NCCL, every run of dist_runs against the same
    call without a mesh: fit_fused bitwise (rank 0 shuffles as one
    device, and a sum over one rank changes nothing), fit and predict as
    DIST_FIT_REL says. Returns the lines to print and the window-mode
    launches of the exact-DP runs."""
    from qfa_tpu_torch.infer.predict import predict_dataset_fused
    from qfa_tpu_torch.ops import epoch_kernel
    from qfa_tpu_torch.train import TrainConfig, fit, fit_fused

    P = dist_problem(device)
    ref_p, ref_h = fit_fused(P["params"], P["derived"], P["mu"],
                             TrainConfig(**DIST_CFG), seed=SEED,
                             tile_batch=64, loglam=P["loglam"])
    fit_ref = fit(P["params"], P["plane"], P["mu"], TrainConfig(**FIT_CFG),
                  seed=SEED)
    pred_ref = predict_dataset_fused(P["params"], P["mu"], P["host"],
                                     P["grid"])
    zero_counts()  # the multi-device entry points are counted from here
    runs = dist_runs(P, mesh)
    window_launches = epoch_kernel.WINDOW_LAUNCHES  # ... to here
    check(window_launches >= 1, "no window-mode launch at world size 1")
    lines = []
    for label, r in runs.items():
        if label.startswith("fit "):
            rel_l = max(abs(a - b) / abs(b) for a, b in zip(r["history"],
                                                           fit_ref[1]))
            rel_p = params_rel(r["params"], fit_ref[0].to_numpy())
            check(rel_l <= CLI_LOSS_RTOL and rel_p <= DIST_FIT_REL,
                  f"world size 1, {label}: loss {rel_l:.3g}, params "
                  f"{rel_p:.3g} from fit without a mesh")
            lines.append(f"{label}: losses within {rel_l:.2e}, params "
                         f"norm-wise {rel_p:.2e} of fit() without a mesh")
        elif label == "predict":
            same = all(np.array_equal(a, b) for a, b in zip(r["result"],
                                                           pred_ref))
            check(same, "world size 1: predict differs from the mesh-free "
                  "call")
            lines.append("predict: bitwise equal to the mesh-free call")
        else:
            same = r["history"] == ref_h and params_equal(
                r["params"], ref_p.to_numpy())
            check(same, f"world size 1, fit_fused {label}: differs from "
                  "fit_fused without a mesh")
            lines.append(f"fit_fused {label}: bitwise equal to fit_fused "
                         f"without a mesh ({r['launches'][0]} epoch-kernel "
                         f"calls, {r['launches'][1]} in window mode)")
    return lines, window_launches


def rank_worker(out_dir):
    """One rank of phase 16's two-rank run over gloo on the one card
    (started by phase_dist_ranks with torchrun's variables): which gloo
    collectives take CUDA tensors, then dist_runs; saved to
    ``out_dir/rank<r>.pt``."""
    import torch.distributed as dist

    from qfa_tpu_torch.parallel import make_mesh

    rank = int(os.environ["RANK"])
    device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(2, device=device, backend="gloo")
    probe = {}
    for op in ("all_reduce", "broadcast", "gather", "all_gather"):
        x = torch.full((4,), float(rank + 1), device=device)
        try:
            if op == "all_reduce":
                dist.all_reduce(x)
                ok = float(x[0]) == 3.0
            elif op == "broadcast":
                dist.broadcast(x, src=0)
                ok = float(x[0]) == 1.0
            elif op == "gather":
                parts = [torch.empty_like(x) for _ in range(2)] \
                    if rank == 0 else None
                dist.gather(x, parts, dst=0)
                ok = rank != 0 or float(parts[1][0]) == 2.0
            else:
                parts = [torch.empty_like(x) for _ in range(2)]
                dist.all_gather(parts, x)
                ok = float(parts[1][0]) == 2.0
            probe[op] = "ok" if ok else "wrong result"
        except Exception as e:  # a finding to report, not a failure
            probe[op] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    torch.save(dict(probe=probe, runs=dist_runs(dist_problem(device), mesh)),
               os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def compose(perms, tiles_per_rank, tpb):
    """One device's tile permutation whose batch i is every rank's local
    batch i: rank d's tiles offset by d * tiles_per_rank."""
    parts = [p.reshape(-1, tpb) + d * tiles_per_rank
             for d, p in enumerate(perms)]
    return torch.cat(parts, dim=1).reshape(-1)


def simulate_sync(P, shards, perms, K, tpb, n_batches, kw):
    """sync_dp's windows made rank by rank in one process: each window's
    pending buffers and (K > 1) the ranks' states at 1/2 each, summed as
    the all_reduce sums them."""
    from qfa_tpu_torch.ops.epoch_kernel import fused_train_epoch
    from qfa_tpu_torch.parallel.mesh import pack, unpack
    from qfa_tpu_torch.train import adam

    st = adam.init(P["params"])
    state, pend = (P["params"], st.m, st.v), None
    for lo in range(0, n_batches, K):
        k = min(K, n_batches - lo)
        outs = [fused_train_epoch(
            *state, *shard, perms[d][lo * tpb:(lo + k) * tpb], None,
            n_batches=k, tiles_per_batch=tpb, sync_grads=True, pending=pend,
            apply_pending=int(pend is not None), **kw)
            for d, shard in enumerate(shards)]
        pend = outs[0].pending + outs[1].pending
        state = (outs[0].params, outs[0].m, outs[0].v)
        if K > 1:
            state = unpack(sum(pack((o.params, o.m, o.v), 0.5)
                               for o in outs), (outs[0].params, outs[0].m,
                                                outs[0].v))
    out = fused_train_epoch(*state, *shards[0], perms[0][:0], None,
                            n_batches=0, tiles_per_batch=tpb,
                            sync_grads=True, pending=pend, apply_pending=1,
                            **kw)
    return out.params.to_numpy()


def phase_dist_ranks(device):
    """Two ranks spawned on the one card over gloo (``--rank-worker``):
    dist_runs on each, then, here, the plain composition of the same
    global batches on one device; every rank's launches. Returns the
    lines to print and the gloo probe."""
    import subprocess

    from qfa_tpu_torch.data.loader import EpochIndices
    from qfa_tpu_torch.infer.predict import predict_dataset_fused
    from qfa_tpu_torch.ops.epoch_kernel import fused_train_epoch
    from qfa_tpu_torch.parallel._common import kernel_kwargs
    from qfa_tpu_torch.parallel.dp import shard_epoch_indices
    from qfa_tpu_torch.parallel.mesh import DataMesh
    from qfa_tpu_torch.train import (
        SeededShuffler,
        TrainConfig,
        TrainState,
        adam,
    )
    from qfa_tpu_torch.train.loop import make_epoch_fn

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as d:
        env = dict(os.environ, WORLD_SIZE="2", LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-worker", d],
            env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, o) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"rank {r} failed:\n{o[-3000:]}")
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"),
                            weights_only=False) for r in (0, 1)]
    probe = ranks[0]["probe"]
    runs = [r["runs"] for r in ranks]
    P = dist_problem(device)
    lines = []
    # the epoch engines: shards of 2048 rows, 32 tiles of 64, 4 per
    # local batch of 256, 8 batches
    cfg = TrainConfig(**DIST_CFG)
    kw = dict(kernel_kwargs(cfg, P["loglam"]), epoch=0, tile_batch=64)
    perms = [SeededShuffler(SEED, r).tiles(0, 32) for r in (0, 1)]
    D = P["derived"]
    shards = [(D.delta[r * 2048:(r + 1) * 2048],
               D.error[r * 2048:(r + 1) * 2048],
               D.zabs[r * 2048:(r + 1) * 2048]) for r in (0, 1)]
    st = adam.init(P["params"])
    exact = fused_train_epoch(P["params"], st.m, st.v, D.delta, D.error,
                              D.zabs, compose(perms, 32, 4), None,
                              n_batches=8, **kw)
    exact_loss = float((exact.loss_sums / exact.n_real.clamp(min=1.0)).sum()
                       / 8)
    refs = {"exact DP K=1": exact.params.to_numpy(),
            "exact DP K=2": simulate_sync(P, shards, perms, 2, 4, 8, kw),
            "exact DP K=16": simulate_sync(P, shards, perms, 16, 4, 8, kw)}
    local = [fused_train_epoch(P["params"], st.m, st.v, *shards[r],
                               perms[r][None], None, n_batches=8,
                               **kw).params.to_numpy() for r in (0, 1)]
    refs["local SGD"] = {k: np.float32(0.5) * local[0][k]
                         + np.float32(0.5) * local[1][k]
                         for k in PARAM_NAMES}
    windows = {"exact DP K=1": 9, "exact DP K=2": 5, "exact DP K=16": 2,
               "local SGD": 0}
    for label, _ in DIST_RUNS:
        a, b = runs[0][label], runs[1][label]
        check(params_equal(a["params"], b["params"]) and
              a["history"] == b["history"],
              f"two ranks, {label}: the ranks' parameters differ")
        rel = params_rel(a["params"], refs[label])
        lim = EPOCH_LIMITS["bf16"]["params"] if label == "exact DP K=1" \
            else DIST_STATE_REL
        check(rel <= lim, f"two ranks, {label}: params {rel:.3g} from the "
              f"composition (limit {lim})")
        for r in (0, 1):
            n_calls = runs[r][label]["launches"]
            check(n_calls[1] == windows[label] and n_calls[0] ==
                  max(windows[label], 1) and n_calls[2:] == [0, 0],
                  f"two ranks, {label}: rank {r} launches {n_calls}")
        extra = ""
        if label == "exact DP K=1":
            rel_l = abs(a["history"][0] - exact_loss) / abs(exact_loss)
            check(rel_l <= EPOCH_LIMITS["bf16"]["loss"],
                  f"two ranks, {label}: loss {rel_l:.3g} off")
            extra = f", loss within {rel_l:.2e}"
        lines.append(
            f"{label}: both ranks' parameters bitwise equal; norm-wise "
            f"{rel:.2e} from the single-device composition (limit {lim})"
            f"{extra}; bitwise: {params_equal(a['params'], refs[label])}; "
            f"epoch-kernel calls per rank {a['launches'][0]}, "
            f"{a['launches'][1]} in window mode")
    # fit: shards of 512 rows, local batches of 128, composed batches
    cfgf = TrainConfig(**FIT_CFG)
    two = [DataMesh(rank=r, size=2, device=device) for r in (0, 1)]
    eis = [shard_epoch_indices(None, 1024, 256, two[r],
                               perm=SeededShuffler(SEED, r).rows(0, 512))
           for r in (0, 1)]
    idx = torch.cat([eis[0].idx, 512 + eis[1].idx], dim=1)
    wt = torch.cat([eis[0].weight, eis[1].weight], dim=1)
    ref_st, ref_loss = make_epoch_fn(cfgf)(
        TrainState(P["params"], adam.init(P["params"])), P["plane"], idx, wt)
    for engine in ("xla", "pallas"):
        a, b = runs[0][f"fit {engine}"], runs[1][f"fit {engine}"]
        check(params_equal(a["params"], b["params"]),
              f"two ranks, fit {engine}: the ranks' parameters differ")
        rel = params_rel(a["params"], ref_st.params.to_numpy())
        rel_l = abs(a["history"][0] - float(ref_loss)) / abs(float(ref_loss))
        check(rel <= DIST_FIT_REL and rel_l <= CLI_LOSS_RTOL,
              f"two ranks, fit {engine}: params {rel:.3g}, loss {rel_l:.3g}"
              " from the composition")
        steps = [0, 0, 4 if engine == "pallas" else 0, 0]
        for r in (0, 1):
            check(runs[r][f"fit {engine}"]["launches"] == steps,
                  f"two ranks, fit {engine}: rank {r} launches "
                  f"{runs[r][f'fit {engine}']['launches']}")
        lines.append(f"fit {engine}: both ranks equal; params norm-wise "
                     f"{rel:.2e}, loss {rel_l:.2e} from the single-device "
                     "epoch on the composed batches; step-kernel launches "
                     f"per rank {steps[2]}")
    pred_ref = predict_dataset_fused(P["params"], P["mu"], P["host"],
                                     P["grid"])
    got = runs[0]["predict"]["result"]
    check(runs[1]["predict"]["result"] is None, "rank 1 returned a result")
    check(all(np.array_equal(x, y) for x, y in zip(got, pred_ref)),
          "two ranks: predict differs from the single-device call")
    check(all(runs[r]["predict"]["launches"] == [0, 0, 0, 1]
              for r in (0, 1)), "two ranks: predict launches "
          f"{[runs[r]['predict']['launches'] for r in (0, 1)]}")
    lines.append("predict (1000 spectra padded to 1008, 504 per rank): rank "
                 "0's gathered result bitwise equal to the single-device "
                 "call, one prediction-kernel launch per rank")
    return lines, probe


def phase_dp_times(device, mesh, n=65536, batch=500, reps=3):
    """One epoch of n SDSS spectra at batch 500, bf16 operands, derived
    layout, at world size 1 over NCCL: the plain fit_fused epoch (one
    epoch-kernel call), sync_dp at K 1 and 16, epoch_dp; and the window
    mode's plain version at K 1 (once). Per engine: ms per epoch (CUDA
    events, median of reps), the host's time to issue the epoch and per
    call (host clock, no sync inside), the all_reduce's device time (the
    profiler's NCCL events) and, alone on the epoch's vector size, by
    CUDA events, the device busy share and launches (torch.profiler), the
    epoch kernel's calls."""
    import torch.distributed as dist

    from qfa_tpu_torch.data.loader import ResidualDataset
    from qfa_tpu_torch.ops import epoch_kernel
    from qfa_tpu_torch.ops.epoch_kernel import (
        fused_train_epoch,
        pending_len,
    )
    from qfa_tpu_torch.parallel import make_epoch_dp_fn, make_sync_dp_epoch_fn
    from qfa_tpu_torch.train import TrainConfig, TrainState, pick_tiling

    n_batches = -(-n // batch)
    tb = pick_tiling(batch)[0]
    grid, params, st, data = window_problem(SDSS, n, device, SEED + 71)
    data = pad_rows(data, n_batches * batch - n)
    zq, _, kw = layout(grid, data, "derived")
    perm = torch.randperm(n_batches * batch // tb,
                          generator=torch.Generator().manual_seed(SEED + 7))
    cfg = TrainConfig(batch_size=batch, mxu_bf16=True)
    shard = ResidualDataset(delta=data["delta"], error=data["error"],
                            zabs=zq, mask=None)
    state = TrainState(params, st)
    dp_kw = dict(tile_batch=tb, batch_rows=batch, loglam=kw["loglam"],
                 n_real=n)
    fns = {
        "plain fit_fused epoch": lambda: fused_train_epoch(
            params, st.m, st.v, data["delta"], data["error"], zq, perm,
            epoch=0, n_batches=n_batches, tile_batch=tb, mxu_bf16=True,
            **kw),
        "sync_dp K=1": lambda f=make_sync_dp_epoch_fn(
            cfg, mesh, batches_per_launch=1, **dp_kw): f(state, shard, perm),
        "sync_dp K=16": lambda f=make_sync_dp_epoch_fn(
            cfg, mesh, batches_per_launch=16, **dp_kw): f(state, shard, perm),
        "epoch_dp": lambda f=make_epoch_dp_fn(cfg, mesh, **dp_kw):
            f(state, shard, perm[None]),
    }
    vec_floats = {"plain fit_fused epoch": 0,
                  "sync_dp K=1": pending_len(grid.npix, NH) + 2,
                  "sync_dp K=16": pending_len(grid.npix, NH) + 32,
                  "epoch_dp": 3 * (grid.npix * NH + grid.npix + grid.nb + 3)
                  + 2 * n_batches}
    out = {}
    for label, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        ms = time_cuda(fn, reps)
        c0 = epoch_kernel.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        calls = epoch_kernel.LAUNCHES - c0
        _, by_name, _, busy, counts = profile_run(fn)
        r = dict(ms=ms, host_ms=host_s * 1e3, calls=calls,
                 host_ms_per_call=host_s * 1e3 / max(calls, 1), busy=busy)
        if by_name is not None:
            r["device_launches"] = sum(counts.values())
            r["epoch_launches"] = sum(c for k, c in counts.items()
                                      if re.search(r"\w+_kernel", k) and
                                      re.search(r"\w+_kernel", k)[0]
                                      in EPOCH_STAGES)
            nccl = {k: v for k, v in by_name.items() if "nccl" in k.lower()}
            r["allreduce_device_ms"] = sum(nccl.values()) * 1e3 \
                if nccl else None
            r["allreduce_events"] = sum(counts[k] for k in nccl)
        if vec_floats[label]:
            vec = torch.zeros(vec_floats[label], device=device)
            r["allreduce_ms"] = time_cuda(lambda: dist.all_reduce(vec), 20)
        out[label] = r
    # the window mode's plain version, one epoch at K = 1
    t0 = time.perf_counter()
    make_sync_dp_epoch_fn(cfg, mesh, plain=True, **dp_kw)(state, shard, perm)
    torch.cuda.synchronize()
    out["plain_ms"] = (time.perf_counter() - t0) * 1e3
    return out, n, n_batches, tb


#: phase 18, the survey-scale OOD sweep: bench.py's 1,474,560 SDSS
#: spectra stored as bfloat16 planes, made on the card in chunks; the
#: first SWEEP_KEEP rows are also kept as their float32 originals
SWEEP_N = 1_474_560
SWEEP_CHUNK = 98_304
SWEEP_KEEP = 65_536
SWEEP_SLICE = (1_000_003, 4_096)  # (start, rows) called alone
SWEEP_TOP_K = 1_024
SWEEP_SAMPLED = 64  # selected spectra whose continua are sampled ...
SWEEP_DRAWS = 100  # ... this many times each
#: batch sizes of predict_resident and score_resident
RESIDENT_BATCH = (4096, 8192)
#: the phase's timed calls: repeats per turn (CUDA events)
SWEEP_REPS = 3


def sweep_survey(params, mu, grid, device):
    """The survey on the card: bfloat16 flux and error planes in the
    production layout (sanitized: masked pixels carry flux and error 0,
    so the mask is derived), the (N, 2) zq column, and the first
    SWEEP_KEEP rows' float32 flux, error, mask and zabs plane. Each
    chunk is drawn in float32 from its own seed and rounded to
    bfloat16 as it is stored."""
    from qfa_tpu_torch.ops.common import zq_column

    flux = torch.empty((SWEEP_N, grid.npix), dtype=torch.bfloat16,
                       device=device)
    error = torch.empty_like(flux)
    zq = torch.empty((SWEEP_N,), device=device)
    keep = None
    for i, start in enumerate(range(0, SWEEP_N, SWEEP_CHUNK)):
        n = min(SWEEP_CHUNK, SWEEP_N - start)
        f, e, m, z = draw_spectra(params, mu, grid, n, SEED + 18 + i)
        f, e = f * m, e * m
        flux[start:start + n] = f
        error[start:start + n] = e
        zq[start:start + n] = z
        if start == 0:
            k = slice(0, SWEEP_KEEP)
            zabs = torch.tensor(grid.zabs(z[k].cpu().numpy()),
                                dtype=torch.float32, device=device)
            keep = (f[k].clone(), e[k].clone(), zabs, m[k].clone(),
                    zq_column(z[k].clone()))
        del f, e, m, z
    return flux, error, zq_column(zq), keep


def phase_sweep(device, smi):
    """Phase 18: the OOD sweep of a device-resident survey in bfloat16
    (B1b) and resident prediction (A3b), driven with every count at 0 and
    read right after; then the readings. Returns the results for the
    kernels line and prints every check and reading."""
    from qfa_tpu_torch.data.grid import make_grid
    from qfa_tpu_torch.infer import (
        ood_scores,
        predict_resident,
        sample_posterior_continua,
        score_resident,
        select_ood,
    )
    from qfa_tpu_torch.ops import infer_kernel
    from qfa_tpu_torch.ops.common import loglam_row
    from qfa_tpu_torch.ops.infer_kernel import fused_predict, fused_predict_plain

    bf = torch.bfloat16
    grid = make_grid(**SDSS)
    params, mu = seeded_params(grid, device)
    kw = dict(loglam=loglam_row(grid.wav, device=device), derive_zabs=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    flux, error, zqc, keep = sweep_survey(params, mu, grid, device)
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    twin = (flux.float(), error.float())  # exact: the same values
    kf, ke, kzabs, kmask, kzq = keep
    k = slice(0, SWEEP_KEEP)

    def host(out):
        return type(out)(*(None if t is None else t.cpu() for t in out))

    # the path, with every count at 0 from here ...
    t0 = time.perf_counter()
    zero_counts()
    sweep = fused_predict(params, mu, flux, error, zqc, None,
                          stats_only=True, **kw)
    sweep32 = fused_predict(params, mu, *twin, zqc, None, stats_only=True,
                            **kw)
    start, rows = SWEEP_SLICE
    sl = slice(start, start + rows)
    alone = fused_predict(params, mu, flux[sl], error[sl], zqc[sl], None,
                          stats_only=True, **kw)
    scores = host(sweep)
    top = select_ood(scores, top_k=SWEEP_TOP_K, n_obs=scores.n_obs.numpy())
    idx = torch.as_tensor(top, device=device)
    picked = fused_predict(params, mu, flux[idx], error[idx], zqc[idx], None,
                           out_dtype=bf, **kw)
    g = torch.Generator(device=device).manual_seed(SEED)
    draws = sample_posterior_continua(
        params, mu, rows_of(picked, slice(0, SWEEP_SAMPLED)), g,
        SWEEP_DRAWS)
    full = fused_predict(params, mu, kf, ke, kzq, None, **kw)
    lean = fused_predict(params, mu, kf, ke, kzq, None, stats_only=True,
                         **kw)
    res = predict_resident(params, mu, kf, ke, kzabs, kmask,
                           batch_size=RESIDENT_BATCH[0])
    ll = score_resident(params, mu, kf, ke, kzabs, kmask,
                        batch_size=RESIDENT_BATCH[1])
    torch.cuda.synchronize()
    launches, bf16_launches = infer_kernel.LAUNCHES, \
        infer_kernel.BF16_LAUNCHES
    others = other_counts(infer_kernel)
    # ... to here
    path_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches == 6 and bf16_launches == 3 and others == 0,
          f"phase 18 made 6 prediction-kernel calls, 3 of them bfloat16, "
          f"and no other kernel's; the counts read {launches}, "
          f"{bf16_launches} and {others}")

    check_bitwise("sweep: bfloat16 planes against their float32 upcast",
                  sweep, sweep32)
    check_bitwise(f"sweep: rows {start}-{start + rows - 1} alone", alone,
                  rows_of(sweep, sl))
    want = fused_predict_plain(params, mu, flux[k], error[k], zqc[k], None,
                               stats_only=True, **kw)
    err, detail = compare(f"sweep rows 0-{SWEEP_KEEP - 1} against the plain"
                          " version", rows_of(sweep, k), want, TOL)
    check(bool(torch.isfinite(sweep.ll).all())
          and float(sweep.n_obs.max()) <= grid.npix,
          "sweep: non-finite ll or n_obs past Npix")
    for field in ("ll", "hmean", "hcov", "n_obs"):
        check(torch.equal(getattr(picked, field), getattr(sweep, field)[idx]),
              f"selected spectra: {field} differs bitwise from the sweep's")
    for field in ("continuum", "continuum_std"):
        x = getattr(picked, field)
        check(x.dtype == bf and x.shape == (SWEEP_TOP_K, grid.npix)
              and bool(torch.isfinite(x).all()),
              f"selected spectra: {field} is not a finite bfloat16 plane of "
              f"({SWEEP_TOP_K}, {grid.npix})")
    check(draws.shape == (SWEEP_DRAWS, SWEEP_SAMPLED, grid.npix)
          and draws.device.type == device.type
          and bool(torch.isfinite(draws).all()),
          f"sample_posterior_continua gave {tuple(draws.shape)} on "
          f"{draws.device}, or non-finite values")
    err_r, detail_r = compare("predict_resident against the kernel", res,
                              full, TOL)
    err_s, detail_s = compare("score_resident against the kernel",
                              rows_of(lean, slice(None))._replace(ll=ll),
                              lean, TOL)
    scores32 = host(lean)
    top32 = select_ood(scores32, top_k=SWEEP_TOP_K,
                       n_obs=scores32.n_obs.numpy())
    top16 = np.argsort(-ood_scores(rows_of(scores, k),
                                   scores.n_obs[k].numpy()))[:SWEEP_TOP_K]
    overlap = len(set(top16.tolist()) & set(top32.tolist()))
    say(f"  survey of {SWEEP_N} SDSS spectra made on the card in "
        f"{made_s:.1f} s ({2 * nbytes(flux) / 1e9:.2f} GB of bfloat16 "
        f"flux/error planes, {2 * nbytes(twin[0]) / 1e9:.2f} GB float32 "
        f"twin); the path ran in {path_s:.1f} s: {launches} kernel calls, "
        f"{bf16_launches} of them bfloat16, no other kernel; peak device "
        f"memory {peak_gb:.2f} GB")
    say(f"  stats_only sweep over bfloat16 planes bitwise equal to the "
        f"float32 upcast over all {SWEEP_N} rows; rows {start}-"
        f"{start + rows - 1} alone bitwise; rows 0-{SWEEP_KEEP - 1} against "
        f"the plain version max_abs_err={err!r} ({detail}); top "
        f"{SWEEP_TOP_K} selected, predicted with bfloat16 planes (stats "
        f"bitwise the sweep's); {SWEEP_DRAWS} posterior draws of "
        f"{SWEEP_SAMPLED} of them, finite, on the card; predict_resident "
        f"against the kernel max_abs_err={err_r!r} ({detail_r}); "
        f"score_resident ll against the kernel ({detail_s})")
    say(f"  the top {SWEEP_TOP_K} of rows 0-{SWEEP_KEEP - 1} by bfloat16 "
        f"planes and by their float32 originals share {overlap} spectra "
        "(a reading of data quantization)")

    # readings: launches from here on are not the path's
    def sweep_call(planes):
        return lambda: fused_predict(params, mu, *planes, zqc, None,
                                     stats_only=True, **kw)

    runs = {"bfloat16": sweep_call((flux, error)),
            "float32": sweep_call(twin)}
    t = turns(runs, SWEEP_REPS)
    for name, ms in t.items():
        b_ms, b_by, b_bytes = predict_bound(
            grid, SWEEP_N, True, plane_bytes=2 if name == "bfloat16" else 4)
        say(f"  sweep ({smi}), {SWEEP_N} spectra, stats_only, {name} planes:"
            f" {ms!r} ms per call (CUDA events; "
            f"{SWEEP_N / ms * 1e3:.0f} spectra/s, "
            f"{b_bytes / ms / 1e6:.1f} GB/s, {b_ms / ms:.3f} of its bound "
            f"{b_ms:.4f} ms by {b_by})")
    del twin, runs
    bf_k = (flux[k], error[k])
    pairs = {}
    for pname, planes in (("float32", (kf, ke)), ("bfloat16", bf_k)):
        for oname, odt in (("float32", torch.float32), ("bfloat16", bf)):
            pairs[pname, oname] = (lambda planes=planes, odt=odt:
                                   fused_predict(params, mu, *planes, kzq,
                                                 None, out_dtype=odt, **kw))
    t = turns(pairs, SWEEP_REPS)
    out = {}
    for (pname, oname), ms in t.items():
        pb, ob = (2 if pname == "bfloat16" else 4), \
            (2 if oname == "bfloat16" else 4)
        b = predict_bound(grid, SWEEP_KEEP, plane_bytes=pb, out_bytes=ob)
        _, by_name, _, _, counts = profile_run(
            lambda fn=pairs[pname, oname]: [fn() for _ in
                                            range(PROFILED_CALLS)])
        spans = {n: v for n, v in (by_name or {}).items()
                 if "predict_kernel" in n}
        dev = None if not spans else \
            sum(spans.values()) * 1e3 / sum(counts[n] for n in spans)
        out[pname, oname] = dict(ms=ms, device=dev, bound=b)
        dev_s = "device time not measured (torch.profiler saw no kernel)" \
            if dev is None else (f"device {dev!r} ms per launch "
                                 f"(torch.profiler, {b[0] / dev:.3f} of "
                                 "its bound)")
        say(f"  full output ({smi}), {SWEEP_KEEP} spectra, {pname} planes, "
            f"{oname} continuum/std: {ms!r} ms per call (CUDA events; "
            f"{b[2] / ms / 1e6:.1f} GB/s, {b[0] / ms:.3f} of its bound "
            f"{b[0]:.4f} ms by {b[1]}); {dev_s}")
    plain_ms = time_cuda(lambda: fused_predict_plain(
        params, mu, *bf_k, kzq, None, out_dtype=bf, **kw), SWEEP_REPS)
    res_ms = time_cuda(lambda: predict_resident(
        params, mu, kf, ke, kzabs, kmask, batch_size=RESIDENT_BATCH[0]),
        SWEEP_REPS)
    score_ms = time_cuda(lambda: score_resident(
        params, mu, kf, ke, kzabs, kmask, batch_size=RESIDENT_BATCH[1]),
        SWEEP_REPS)
    say(f"  ({smi}) plain version, {SWEEP_KEEP} spectra, bfloat16 planes "
        f"and continuum/std: {plain_ms!r} ms; predict_resident (batch "
        f"{RESIDENT_BATCH[0]}) {res_ms!r} ms, score_resident (batch "
        f"{RESIDENT_BATCH[1]}) {score_ms!r} ms over {SWEEP_KEEP} float32 "
        "spectra (CUDA events)")
    del flux, error, zqc, keep, kf, ke, kzabs, kmask, kzq, bf_k, pairs
    torch.cuda.empty_cache()
    bf16 = out["bfloat16", "bfloat16"]
    return {"launches": bf16_launches, "worst": max(err, err_r),
            "ms": bf16["ms"], "plain_ms": plain_ms,
            "bound": bf16["bound"][:2]}


def read_engines(paths):
    """The same npz files through the native reader and the Python pool
    (``data.loader.read_spectra``): every array bitwise equal, dtypes
    included. Returns (native s, Python s) by the host clock."""
    from qfa_tpu_torch.data.loader import read_spectra

    t0 = time.perf_counter()
    nat = read_spectra(paths, engine="native")
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = read_spectra(paths, engine="python")
    t_py = time.perf_counter() - t0
    for name, a, b in zip(("flux", "error", "mask", "zqso", "flux_ok"), nat,
                          py):
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"the native reader's {name} differs from the Python pool's")
    return t_nat, t_py


def check_native_read(run, what):
    """A CLI run read its spectra through the native reader."""
    from qfa_tpu_torch import native

    check(run["read_engine"] == "native",
          f"{what} read with the {run['read_engine']} reader, not the "
          f"native one ({native.build_error()})")


#: phase 19's facade run: 2048 SDSS spectra at batch 500 for 2 epochs,
#: Nh 8; the per-epoch losses of QFA.train(engine="auto") (the epoch
#: kernel, float32 operands: the facade's TrainConfig) against
#: fit_fused(plain=True) on the same data and seed to CLI_LOSS_RTOL
FACADE_N, FACADE_EPOCHS, FACADE_BATCH = 2048, 2, 500
#: phase 19's MDN fit: 4096 conditions (z, lum) -> an Nh-dim latent
MDN_N, MDN_STEPS = 4096, 300


def trace_kernel_counts(log_dir):
    """Launches by kernel short name (``forward_kernel``, ...) among the
    device kernel events of the one Chrome trace in ``log_dir``."""
    import glob

    files = glob.glob(os.path.join(log_dir, "*.json"))
    check(len(files) == 1, f"{log_dir} holds {len(files)} traces, not 1")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    counts = {}
    for e in events:
        short = re.search(r"\w+_kernel", e.get("name", "")) \
            if e.get("cat") == "kernel" else None
        if short:
            counts[short[0]] = counts.get(short[0], 0) + 1
    return counts


def phase_facade(root, grid):
    """The reference-API facade, the CLI's profiling and NaN debugging,
    and the MDN, on the card (phase 19). Returns the phase's readings."""
    from qfa_tpu_torch import cli, compat, native
    from qfa_tpu_torch.config import load_config
    from qfa_tpu_torch.models.mdn import MDNConfig, fit_mdn, \
        sample_mock_continua
    from qfa_tpu_torch.models.params import random_init, save_npz
    from qfa_tpu_torch.ops import epoch_kernel, fused_step, infer_kernel
    from qfa_tpu_torch.utils.profiling import nan_debugging

    r = {}
    n, epochs, batch = FACADE_N, FACADE_EPOCHS, FACADE_BATCH
    catalog, data_dir, names = write_training_survey(root, grid, n)

    # 1. compat.Dataloader and QFA(device="cuda").train(engine="auto")
    reads = native.READS
    t0 = time.perf_counter()
    dl = compat.Dataloader(load_config(opts=[
        "TYPE", "train", "DATA.CATALOG", catalog, "DATA.DATA_DIR", data_dir,
        "DATA.DATA_NUM", str(n), "DATA.BATCH_SIZE", str(batch)]), seed=SEED)
    dl.set_device("cuda")
    r["load_s"] = time.perf_counter() - t0
    check(native.READS == reads + 1, "compat.Dataloader did not read "
          "through the native reader")
    check(dl.residuals().delta.device.type == "cuda",
          "Dataloader.set_device did not move the residuals")
    model = compat.QFA(dl.Nb, dl.Nr, NH, device="cuda", seed=SEED)
    seen = {}
    real = compat.fit_fused

    def spy(*args, **kw):  # the facade's own call, kept for the plain run
        seen.update(args=args, kw=kw)
        out = real(*args, **kw)
        seen["history"] = out[1]
        return out

    compat.fit_fused = spy
    try:
        epoch_kernel.LAUNCHES = 0  # the facade path is counted from here
        t0 = time.perf_counter()
        model.train(dataloader=dl, n_epochs=epochs, quiet=True,
                    output_dir=os.path.join(root, "facade"), engine="auto")
        torch.cuda.synchronize()
        r["train_s"] = time.perf_counter() - t0
        r["launches"] = epoch_kernel.LAUNCHES  # ... to here
    finally:
        compat.fit_fused = real
    check("history" in seen, "QFA.train(engine='auto') on the card did not "
          "run fit_fused")
    check(r["launches"] == epochs, f"QFA.train launched the epoch kernel "
          f"{r['launches']} times for {epochs} epochs")
    check(infer_kernel.LAUNCHES == 0 and fused_step.LAUNCHES == 0,
          "QFA.train launched another kernel")
    _, hp = real(*seen["args"], **dict(
        seen["kw"], output_dir=os.path.join(root, "facade_plain"),
        plain=True))
    check(epoch_kernel.LAUNCHES == r["launches"],
          "fit_fused(plain=True) launched the epoch kernel")
    hk, hp = np.asarray(seen["history"]), np.asarray(hp)
    r["loss_rel"] = float(np.max(np.abs(hk - hp) / np.abs(hp)))
    r["history"] = hk.tolist()
    check(r["loss_rel"] <= CLI_LOSS_RTOL, f"QFA.train losses {hk} against "
          f"fit_fused(plain=True) {hp}: {r['loss_rel']:.3g}")
    # the single-spectrum prediction on the card against the CPU
    cpu = compat.QFA(dl.Nb, dl.Nr, NH, device="cpu", model_params={
        k: v.cpu() for k, v in model.parameters.items()})
    cpu.mu = model.mu.cpu()
    row = dl[11][:4]
    got = model.prediction_for_single_spectra(*row)
    want = cpu.prediction_for_single_spectra(*(x.cpu() for x in row))
    check(tuple(got[1].shape) == (NH, 1), "hmean is not an (Nh, 1) column")
    for field, a, b in zip(("ll", "hmean", "hcov", "continuum",
                            "continuum_std"), got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                   err_msg=f"facade prediction {field}, card "
                                   "against CPU", **TOL[field])

    # 2-3. the CLI with RUNTIME.PROFILE_DIR and RUNTIME.DEBUG_NANS
    base = ["--type", "train", "--catalog", catalog, "--data_dir", data_dir,
            "--data_num", str(n), "--batch_size", str(batch), "--n_epochs",
            str(epochs), "--seed", str(SEED), "--device", "cuda"]

    def cli_run(name, *opts):
        out = os.path.join(root, name)
        run = cli.main(base + ["--output_dir", out]
                       + (["--opts", *opts] if opts else []))
        check_native_read(run, f"CLI train ({name})")
        with np.load(os.path.join(out, "model_parameters.npz")) as f:
            run["model"] = {k: f[k] for k in f.files}
        return run

    def same(a, b):
        return a["history"] == b["history"] and all(
            np.array_equal(a["model"][k], b["model"][k]) for k in a["model"])

    plain = cli_run("cli_plain")
    n_batches = -(-n // batch) * epochs
    for tries in range(1, PROFILE_TRIES + 1):
        prof_dir = os.path.join(root, f"profile{tries}")
        before = epoch_kernel.LAUNCHES
        traced = cli_run(f"cli_traced{tries}", "RUNTIME.PROFILE_DIR",
                         prof_dir)
        check(epoch_kernel.LAUNCHES - before == epochs,
              "the profiled CLI train did not launch the epoch kernel")
        check(same(traced, plain), "tracing changed the CLI train's outputs")
        counts = trace_kernel_counts(prof_dir)
        # a trace loses a launch's event now and then (phase 9): again
        if all(counts.get(k) == n_batches for k in EPOCH_STAGES):
            break
    r["trace"], r["trace_tries"] = counts, tries
    check(all(counts.get(k) == n_batches for k in EPOCH_STAGES),
          f"the PROFILE_DIR trace holds {counts}, not {n_batches} of each "
          f"of {EPOCH_STAGES}")
    debug = cli_run("cli_debug_nans", "RUNTIME.DEBUG_NANS", "True")
    check(same(debug, plain), "RUNTIME.DEBUG_NANS changed the CLI train's "
          "outputs on finite data")
    bad = random_init(grid.npix, grid.nb, NH,
                      generator=torch.Generator().manual_seed(SEED))
    bad.F.data[7, 3] = float("nan")
    nan_init = os.path.join(root, "nan_init.npz")
    save_npz(nan_init, bad, np.ones(grid.npix, np.float32))
    try:
        cli.main(base + ["--output_dir", os.path.join(root, "cli_nan"),
                         "--resume", nan_init, "--opts",
                         "RUNTIME.DEBUG_NANS", "True"])
        r["nan_error"] = None
    except FloatingPointError as e:
        r["nan_error"] = str(e)
    check(r["nan_error"] is not None, "RUNTIME.DEBUG_NANS with a NaN in "
          "the initial parameters did not raise FloatingPointError")
    check(not nan_debugging(), "NaN debugging stayed on after the CLI run")

    # 4. the MDN on the card: losses finite and falling; mock continua
    rng = np.random.default_rng(SEED)
    cond = np.stack([rng.uniform(2.0, 3.5, MDN_N),
                     rng.uniform(-1.0, 1.0, MDN_N)], 1).astype(np.float32)
    h = (cond @ rng.normal(size=(2, NH))
         + 0.3 * rng.normal(size=(MDN_N, NH))).astype(np.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mdn_cfg = MDNConfig(cond_dim=2, out_dim=NH)
    t0 = time.perf_counter()
    mdn, info = fit_mdn(gen, cond, h, mdn_cfg, n_steps=MDN_STEPS,
                        device="cuda")
    r["mdn_s"] = time.perf_counter() - t0
    r["mdn_losses"] = info["losses"]
    check(bool(np.isfinite(info["losses"]).all())
          and info["losses"][-1] < info["losses"][0],
          f"fit_mdn losses {info['losses']} are not finite and falling")
    cont = sample_mock_continua(mdn, gen, cond[:16], model.parameters["F"],
                                model.mu, 4, mdn_cfg, info)
    check(tuple(cont.shape) == (4, 16, grid.npix) and cont.is_cuda
          and bool(torch.isfinite(cont).all()),
          f"sample_mock_continua gave {tuple(cont.shape)}")
    return r


def turns(runs, reps):
    """Median ms per call of each of ``runs`` by CUDA events (after one
    warm-up call each), timed in turns: in order, then in reverse."""
    for fn in runs.values():
        fn()
    torch.cuda.synchronize()
    samples = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            samples[name].append(time_cuda(runs[name], reps))
    return {name: statistics.median(v) for name, v in samples.items()}


def bound(n_bytes, flops, flop_per_s=FP32_FLOP_PER_S):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    card's HBM rate and the operations over their peak (fp32 outside the
    tensor cores unless given)."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / flop_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def predict_bound(grid, n, stats_only=False, plane_bytes=4, out_bytes=4):
    """(ms, "bytes" or "operations", bytes) of the prediction kernel on n
    spectra in the derived layout: flux, error (``plane_bytes`` each per
    pixel), zq column, loglam, mu and the params in; ll, n_obs, hmean,
    hcov (and continuum and std, ``out_bytes`` each per pixel) out; the
    FMAs of K triangle + W (and continuum + std), 2 operations each."""
    npix, nb = grid.npix, grid.nb
    ntri = NH * (NH + 1) // 2
    params = 4 * (npix * NH + npix + nb + 3)
    planes = 0 if stats_only else 2
    n_bytes = (plane_bytes * 2 * n * npix + 4 * (2 * n + 2 * npix) + params
               + 4 * n * (2 + NH + NH * NH) + out_bytes * planes * n * npix)
    flops = 2 * (ntri + NH) * (1 if stats_only else 2) * n * npix
    return (*bound(n_bytes, flops), n_bytes)


def bounds(grid, n_epoch, n_batches, tile, batch):
    """bound_ms of the training kernels at the shapes they were timed at
    (the epoch, the step, and the epoch in window calls at K = 1): every
    input read once and every output written once, and the FMAs of their
    products (2 operations each; the exp/log/pow chain is not counted).
    Per (row, pixel): forward K + W, backward dw, du, dG, dF
    (3 (ntri + nh))."""
    npix, nb = grid.npix, grid.nb
    ntri = NH * (NH + 1) // 2
    params = 4 * (npix * NH + npix + nb + 3)
    rows = n_batches * 500  # phase 9's padded dataset (batch 500)
    # epoch: delta, error, zq column, loglam, tile permutation, params and
    # both moments in and out, loss sums and n_real out
    ep = bound(4 * (2 * rows * npix + 2 * rows + npix) + 4 * (rows // tile)
               + 6 * params + 8 * n_batches,
               2 * 3 * (ntri + NH) * n_epoch * npix)
    st = bound(nbytes(batch.delta, batch.error, batch.zabs, batch.mask,
                      batch.weight) + params
               + 4 * (npix * NH + npix + nb + npix + 5),
               2 * 3 * (ntri + NH) * batch.delta.shape[0] * npix)
    # the epoch at K = 1 in window calls (phase 17): the epoch's traffic,
    # and each batch's pending buffer written once and read once
    from qfa_tpu_torch.ops.epoch_kernel import pending_len

    win = bound(4 * (2 * rows * npix + 2 * rows + npix) + 4 * (rows // tile)
                + 6 * params + 8 * n_batches
                + 2 * 4 * pending_len(npix, NH) * n_batches,
                2 * 3 * (ntri + NH) * n_epoch * npix)
    return ep, st, win


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run after phases 1-2 "
                    "(e.g. 10,11,12); a partial run prints no kernels line "
                    "and no ok line")
    ap.add_argument("--rank-worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_worker:  # one rank of phase 16's two-rank run
        return rank_worker(args.rank_worker)
    only = {int(x) for x in args.only.split(",") if x}

    def want(*phases):
        return not only or bool(only & set(phases))

    if not torch.cuda.is_available():
        say("chip_smoke: FAIL: torch.cuda.is_available() is False")
        return 1
    from qfa_tpu_torch.calibrate import card_info
    from qfa_tpu_torch.data.grid import make_grid
    from qfa_tpu_torch.ops import _build, epoch_kernel, fused_step, infer_kernel

    device = torch.device("cuda")
    # 1. device
    smi = card_info()["nvidia_smi"]
    kind = torch.cuda.get_device_name(0)
    say(smi)
    say(f"phase 1 device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    # the plain version runs in full fp32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("  TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    say(f"phase 2 build: {time.perf_counter() - t0:.3f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    kernel = "?"
    for line in _build.build_log().splitlines():
        name = re.search(r"Compiling entry function '(\w+)'", line)
        if name:
            kernel = name[1]
        elif "predict_kernel" in kernel:
            continue  # reported per nh below
        elif "registers" in line or ("spill" in line
                                     and " 0 bytes spill" not in line):
            say(f"  {kernel}: {line.strip()}")
    for (nh, ptype, flags), r in predict_build_report(
            _build.load_library(), _build.build_log()).items():
        say(f"  predict_kernel nh={nh}, {ptype} flux/error"
            f"{', run-time mask/zabs/output types' if flags else ''}: "
            f"{r['registers']} registers, "
            f"{r['spill']} spill stores/loads (bytes); dynamic shared memory"
            " and resident blocks per SM: " + ", ".join(
                f"{m} {b} B, {k}" for m, (b, k) in r["modes"].items()))

    grid = make_grid(**SDSS)
    if want(3):
        say("phase 3 kernel vs plain version on the card:")
        worst = phase_kernel_vs_plain(device)
        t0 = time.perf_counter()
        worst_bf16, n_bf16 = phase_bf16_vs_plain(device)
        say(f"  bfloat16 modes: {n_bf16} kernel calls, max_abs_err="
            f"{worst_bf16!r} against the plain version; "
            f"{time.perf_counter() - t0:.1f} s")

    if want(4, 5):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
            params, mu = seeded_params(grid, torch.device("cpu"))
            ckpt, data_dir, catalog, names, raw = write_survey(
                root, params.to(device), mu.to(device), grid, 2048)
            zero_counts()  # the main path's launches are counted from here
            cli_launches, timing, n_sample = phase_cli(
                root, ckpt, data_dir, catalog, names, grid)
            say(f"phase 4 CLI predict: {timing['n']} spectra, read "
                f"{timing['read_s']:.3f} s ({timing['read_engine']} "
                f"reader), device "
                f"{timing['predict_s']:.3f} s, write "
                f"{timing['write_s']:.3f} s; {cli_launches} launch(es); "
                f"{n_sample} spectra match the CPU plain path")
            t_nat, t_py = read_engines(
                [os.path.join(data_dir, name) for name in names])
            say(f"  the same {len(names)} files read again ({smi}, host "
                f"clock): native reader {t_nat:.4f} s, Python pool "
                f"{t_py:.4f} s ({t_py / t_nat:.1f}x); arrays bitwise equal")
            serve_launches, latencies, pred, responses = phase_serving(
                ckpt, raw)
            main_launches = infer_kernel.LAUNCHES  # ... to here
            check_responses(pred, responses, raw)
            say("phase 5 serving: /healthz engine fused; " + ", ".join(
                f"{n} spectra {dt * 1e3:.1f} ms" for n, dt in latencies)
                + f" (HTTP, host clock); {serve_launches} launch(es); "
                "responses equal the direct call")
        check(main_launches == cli_launches + serve_launches,
              "launch count moved outside the main path")
        check(epoch_kernel.LAUNCHES == 0 and fused_step.LAUNCHES == 0,
              "the predict path launched a training kernel")
    if want(6):
        times = phase_times(device)
        for (n, stats_only), t in times.items():
            mode = "stats_only" if stats_only else "full output"
            b_ms, b_by, b_bytes = t["bound"]
            dev = "device time not measured (torch.profiler saw no " \
                "kernel)" if t["device"] is None else (
                    f"device {t['device']!r} ms per launch (torch.profiler,"
                    f" {b_bytes / t['device'] / 1e6:.1f} GB/s, "
                    f"{b_ms / t['device']:.3f} of its bound)")
            say(f"phase 6 times ({smi}), SDSS width, derived layout, {n} "
                f"spectra, {mode}: kernel {t['kernel']!r} ms per call "
                f"(CUDA events; {n / t['kernel'] * 1e3:.0f} spectra/s, "
                f"{b_bytes / t['kernel'] / 1e6:.1f} GB/s, "
                f"{b_ms / t['kernel']:.3f} of its bound {b_ms:.4f} ms by "
                f"{b_by}); {dev}; plain {t['plain']!r} ms "
                f"({n / t['plain'] * 1e3:.0f} spectra/s)")

    if want(7):
        say("phase 7 epoch kernel vs plain version on the card:")
        train_worst = phase_epoch_vs_plain(device)

    if want(8):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
            t0 = time.perf_counter()
            zero_counts()
            train_launches, run_k, run_x, rel, plain_s, run_b, rel_b = \
                phase_train_cli(root, grid)
            check(fused_step.LAUNCHES == 0,
                  "the training CLI launched the step kernel")
            say(f"phase 8 CLI train: {run_k['n']} spectra, batch 500, "
                f"{len(run_k['history'])} epochs; read "
                f"{run_k['read_s']:.3f} s, train {run_k['train_s']:.3f} s "
                f"(kernel) / {plain_s:.3f} s (fit_fused(plain=True), "
                f"direct); {train_launches} epoch-kernel call(s); losses "
                f"{[round(x, 4) for x in run_k['history']]} match "
                f"fit_fused(plain=True) to {rel:.2e}; checkpoints, "
                "metrics.jsonl and model_parameters.npz written; TRAIN.ENGINE"
                f" xla ran train.fit, no epoch kernel, train "
                f"{run_x['train_s']:.3f} s, losses "
                f"{[round(x, 4) for x in run_x['history']]}; --type predict "
                "from the trained model ran the prediction kernel; "
                "TRAIN.BF16_PLANES on the kernel: train "
                f"{run_b['train_s']:.3f} s, losses "
                f"{[round(x, 4) for x in run_b['history']]} match "
                f"fit_fused(plain=True) on the same bf16 planes to "
                f"{rel_b:.2e}; phase {time.perf_counter() - t0:.1f} s")
            t_nat, t_py = run_k["reads"]
            say(f"  CLI train read its {run_k['n']} spectra with the "
                f"{run_k['read_engine']} reader; the same files read again "
                f"({smi}, host clock): native reader {t_nat:.4f} s, Python "
                f"pool {t_py:.4f} s ({t_py / t_nat:.1f}x); arrays bitwise "
                "equal")

    if want(9):
        ttimes, tn, n_batches, tb = phase_train_times(device)
        prof = ttimes.pop("profile")
        for label, t in ttimes.items():
            say(f"phase 9 times ({smi}), one training epoch, SDSS width, "
                f"{tn} spectra, batch 500 ({n_batches} batches, tile {tb}), "
                f"derived layout, {label}: "
                f"kernel {t['kernel']!r} ms ({tn / t['kernel'] * 1e3:.0f} "
                f"spectra/s), plain {t['plain']!r} ms "
                f"({tn / t['plain'] * 1e3:.0f} spectra/s); kernel against "
                f"plain: params max_abs_err={t['max_abs_err']!r}; "
                f"{t['detail']}")
            train_worst = max(train_worst, t["max_abs_err"]) if want(7) \
                else t["max_abs_err"]
        if prof["stages"] is None:
            say("  epoch kernel by stage: not measured (torch.profiler saw "
                "no device activity)")
        else:
            launches = {k: c for k, (_, c) in prof["stages"].items()}
            say(f"  one kernel epoch, bf16 operands, each kernel launched "
                f"when the one before it has ended (no early launch): "
                f"{prof['ms_alone']!r} ms; by stage (torch.profiler, "
                f"{smi}): " + ", ".join(
                    f"{k} {ms!r} ms in {c} launches "
                    f"({ms / c * 1e3:.2f} us each)"
                    for k, (ms, c) in prof["stages"].items())
                + f"; device busy share {prof['busy']!r}; "
                f"{sum(launches.values())} device launches in the call "
                f"(trace {prof['tries']} of at most {PROFILE_TRIES}), "
                f"{sum(c for k, c in launches.items() if k in EPOCH_STAGES)}"
                f" of them epoch.cu's ({n_batches} batches); results "
                "bitwise equal to the early launch's")
            check(all(launches.get(k) == n_batches for k in EPOCH_STAGES),
                  f"epoch.cu launched {launches}, not one of each of "
                  f"{EPOCH_STAGES} per batch")

    if want(10):
        say("phase 10 step kernel vs plain version on the card:")
        step_worst = phase_step_vs_plain(device)

    if want(11, 12):
        problem = streaming_problem(device)
    if want(11):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as root:
            st = phase_streaming(root, problem, device)
        step_launches = st["launches"]
        say(f"phase 11 fit_streaming: {problem[1].size} SDSS spectra in host "
            f"RAM, batch 500 ({st['n_batches']} steps, the last with "
            f"{problem[1].size - 500 * (st['n_batches'] - 1)} real rows), "
            f"{len(st['hk'])} epochs, validation on {problem[2].size}; "
            f"{step_launches} step-kernel launches, no epoch or predict "
            f"kernel; losses {st['hk']!r} (kernel) match the plain step "
            f"{st['hp']!r} to {st['rel']:.2e}; autograd step, one epoch: "
            f"{st['ha']!r}; wall {st['wall_k']:.3f} s (kernel, with "
            f"validation and checkpoints) / {st['wall_p']:.3f} s (plain) / "
            f"{st['wall_a']:.3f} s (autograd, 1 epoch); checkpoints "
            "written every epoch")

    if want(12):
        t12, step_b = phase_step_times(device, problem)
        n_stream = t12["n"]
        busy = "not measured" if t12["busy"] is None else \
            f"{t12['busy']!r}"
        h2d = "not measured" if t12["h2d_s"] is None else \
            f"{t12['h2d_s']!r} s"
        say(f"phase 12 times ({smi}), SDSS width, batch 500, CUDA events "
            f"(median): step kernel {t12['kernel']!r} ms, plain version "
            f"{t12['plain']!r} ms, autograd loss_and_grads "
            f"{t12['autograd']!r} ms, whole fused step function (kernel, "
            f"normalization, Adam, clip, guard) {t12['step function']!r} "
            "ms (it and the autograd step ran once with no host sync "
            "inside, set_sync_debug_mode error); "
            f"one streaming epoch of {n_stream} spectra on the step kernel: "
            f"wall {t12['epoch_wall_s']!r} s "
            f"({n_stream / t12['epoch_wall_s']:.0f} "
            f"spectra/s), H2D copy {h2d}, device busy share {busy} "
            "(torch.profiler, profiled epoch)")
        if t12["stages_us"] is None:
            say("  step kernels' device time: not measured (torch.profiler "
                "saw no device activity)")
        else:
            dev_us = sum(t12["stages_us"].values())
            say(f"  step kernels, each launched when the one before it has "
                f"ended (no early launch), device time per launch "
                f"(torch.profiler, {smi}, one launch each per call): "
                + ", ".join(
                    f"{k} {v:.2f} us ({t12['stage_launches'][k]} launches "
                    "seen of 20)" for k, v in t12["stages_us"].items())
                + f"; sum {dev_us:.2f} us; call time by CUDA events "
                f"{t12['kernel'] * 1e3:.2f} us with the early launch, "
                f"{t12['kernel alone'] * 1e3:.2f} us without: "
                f"{t12['kernel'] * 1e3 / dev_us:.2f}x the device time")
        busy = f"{t12['busy_us']:.2f} us" if t12["busy_us"] is not None \
            else ("not measured (the profiler saw "
                  f"{t12['busy_seen']} of 20 launches of each kernel)")
        say(f"  with the early launch: device busy per call {busy} "
            f"(torch.profiler); the wrapper's host time "
            f"{t12['host_us']:.2f} us per call (20 calls enqueued back to "
            "back, host clock)")
        say("  step kernels at nh 8 (ptxas -v): " + ", ".join(
            f"{k} {r} registers, {sp} B spill stores/loads, {sm} B shared"
            for k, (r, sp, sm) in step_build_report(
                _build.build_log()).items()))

    if want(13):
        say("phase 13 alu_chain kernel vs plain version on the card:")
        alu = phase_alu(device, smi)

    if want(14):
        say("phase 14 contraction probe kernel vs plain version on the card:")
        kdp = phase_kdepth(device, smi)

    if want(15, 16, 17):
        import torch.distributed as dist

        from qfa_tpu_torch.parallel import initialize_distributed, make_mesh

        initialize_distributed(
            backend="nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
            rank=0, world_size=1)
        mesh = make_mesh(1, device=device, backend="nccl")
    if want(15):
        say("phase 15 epoch kernel window mode vs plain version on the card:")
        window_worst = phase_window_vs_plain(device, mesh)

    if want(16):
        t0 = time.perf_counter()
        lines, window_launches = phase_dist_world1(device, mesh)
        say(f"phase 16 torch.distributed, world size 1 over NCCL "
            f"({time.perf_counter() - t0:.1f} s): " + "; ".join(lines)
            + f"; {window_launches} window-mode calls in these runs")
        t0 = time.perf_counter()
        lines, probe = phase_dist_ranks(device)
        say(f"  two ranks on the one card over gloo "
            f"({time.perf_counter() - t0:.1f} s): " + "; ".join(lines))
        say("  gloo collectives on CUDA tensors: " + ", ".join(
            f"{k} {v}" for k, v in probe.items()))

    if want(17):
        dpt, dn, dbatches, dtb = phase_dp_times(device, mesh)
        for label, r in dpt.items():
            if label == "plain_ms":
                continue
            ar = "" if "allreduce_ms" not in r else (
                f"; all_reduce of its {label} vector alone "
                f"{r['allreduce_ms']!r} ms (CUDA events), in the epoch "
                + ("not seen by the profiler" if r.get("allreduce_device_ms")
                   is None else f"{r['allreduce_device_ms']!r} ms of device"
                   f" time in {r['allreduce_events']} NCCL events"))
            dev = "device busy share and launches not measured (the " \
                "profiler saw no device activity)" if r["busy"] is None \
                else (f"device busy share {r['busy']!r}, "
                      f"{r['device_launches']} device launches, "
                      f"{r['epoch_launches']} of them epoch.cu's")
            say(f"phase 17 times ({smi}), world size 1 (NCCL), one epoch of "
                f"{dn} SDSS spectra, batch 500 ({dbatches} batches, tile "
                f"{dtb}), bf16 operands, {label}: {r['ms']!r} ms per epoch "
                f"(CUDA events, {dn / r['ms'] * 1e3:.0f} spectra/s); "
                f"{r['calls']} epoch-kernel call(s), host "
                f"{r['host_ms']!r} ms to issue the epoch, "
                f"{r['host_ms_per_call']!r} ms per call; {dev}{ar}")
        say(f"  window mode's plain version, one epoch at K=1: "
            f"{dpt['plain_ms']!r} ms (host clock)")

    if want(15, 16, 17):
        dist.destroy_process_group()

    if want(18):
        t0 = time.perf_counter()
        say("phase 18 survey OOD sweep (B1b, A3b):")
        sweep = phase_sweep(device, smi)
        say(f"  phase 18 took {time.perf_counter() - t0:.1f} s")

    if want(19):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_facade_") as root:
            zero_counts()
            fr = phase_facade(root, grid)
        say(f"phase 19 facade, profiling, NaN debugging, MDN: "
            f"compat.Dataloader read {FACADE_N} SDSS spectra (native "
            f"reader) and moved them to the card in {fr['load_s']:.3f} s; "
            f"QFA(device='cuda').train(engine='auto'), {FACADE_EPOCHS} "
            f"epochs at batch {FACADE_BATCH}: {fr['launches']} epoch-kernel "
            f"call(s), {fr['train_s']:.3f} s, losses "
            f"{[round(x, 4) for x in fr['history']]} match "
            f"fit_fused(plain=True) to {fr['loss_rel']:.2e}; "
            "prediction_for_single_spectra on the card within TOL of the "
            "CPU; CLI train with RUNTIME.PROFILE_DIR: outputs bitwise "
            f"unchanged, its trace holds {fr['trace']} (trace "
            f"{fr['trace_tries']} of at most {PROFILE_TRIES}); "
            "RUNTIME.DEBUG_NANS: outputs bitwise unchanged on finite data, "
            f"a NaN init raised FloatingPointError ({fr['nan_error']}); "
            f"fit_mdn {MDN_STEPS} steps on the card in {fr['mdn_s']:.3f} s, "
            f"losses {[round(x, 3) for x in fr['mdn_losses']]}; "
            "sample_mock_continua finite; phase "
            f"{time.perf_counter() - t0:.1f} s")

    if only:
        say(f"partial run of phases 1, 2 and {sorted(only)}: no kernels "
            "line, no result")
        return 0
    b_epoch, b_step, b_window = bounds(grid, tn, n_batches, tb, step_b)
    t_pred = times[PREDICT_SIZES[0], False]

    def entry(name, src, replaces, launches, err, ms, plain_ms, bnd,
              library_ms=None):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    say(json.dumps({"kernels": [
        entry("predict_kernel", "qfa_tpu_torch/csrc/predict.cu",
              "qfa_tpu/ops/infer_kernel.py:90", main_launches, worst,
              t_pred["kernel"], t_pred["plain"], t_pred["bound"][:2]),
        entry("epoch_kernel", "qfa_tpu_torch/csrc/epoch.cu",
              "qfa_tpu/ops/epoch_kernel.py:237", train_launches, train_worst,
              ttimes["bf16 operands"]["kernel"],
              ttimes["bf16 operands"]["plain"], b_epoch),
        entry("step_kernel", "qfa_tpu_torch/csrc/step.cu",
              "qfa_tpu/ops/fused_step.py:155", step_launches, step_worst,
              t12["kernel"], t12["plain"], b_step),
        entry("alu_chain_kernel", "qfa_tpu_torch/csrc/alu_chain.cu",
              "bench.py:410", alu["launches"], alu["worst"], alu["ms"],
              alu["plain_ms"], alu["bound"]),
        entry("kdepth_kernel", "qfa_tpu_torch/csrc/kdepth.cu",
              "tools/mxu_kdepth.py:87", kdp["launches"], kdp["worst"],
              kdp["ms"], kdp["plain_ms"], kdp["bound"], kdp["library_ms"]),
        entry("epoch_kernel_window", "qfa_tpu_torch/csrc/epoch.cu",
              "qfa_tpu/ops/epoch_kernel.py:478", window_launches,
              window_worst, dpt["sync_dp K=1"]["ms"], dpt["plain_ms"],
              b_window),
        entry("predict_kernel_bf16", "qfa_tpu_torch/csrc/predict.cu",
              "qfa_tpu/ops/infer_kernel.py:126", sweep["launches"],
              max(worst_bf16, sweep["worst"]), sweep["ms"],
              sweep["plain_ms"], sweep["bound"]),
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
