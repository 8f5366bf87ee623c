#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs the port's prediction and serving path and its training path once on
the card, at the full width of the SDSS model the repository ships (Npix
1913, Nb 720, Nh 8), with parameters and spectra made from a seed:

1. device: requires CUDA; prints the card's name and power limit
   (``nvidia-smi``); turns TF32 off for matmuls and cuDNN, so the plain
   torch version runs in full fp32;
2. build: compiles the CUDA kernels from ``qfa_tpu_torch/csrc`` with nvcc;
3. kernel against its plain version on the same CUDA tensors, within the
   tolerances of the CPU parity tests, at SDSS width (4096 spectra) and
   DESI width (Npix 9243, Nb 2238; 512 spectra), in each mode of the path;
4. main path: ``qfa_tpu_torch.cli.main(["--type", "predict", ...])`` on
   2048 spectra written to disk, checked against the plain path on the
   CPU;
5. serving: ``QFAPredictor(device="cuda")`` behind its HTTP server;
6. times of the kernel and the plain version over 65536 spectra;
7. the epoch kernel against its plain version on the same CUDA tensors:
   SDSS width (4096 spectra, batch 512, 2 epochs) and DESI width (512
   spectra, 1 epoch), derived and plane layouts, and the training CLI's
   shape (2048 spectra padded to 2500 rows, batch 500, tile 4, 4
   epochs, derived layout), bf16 operands off and on; 3 epochs in one
   call against 3 chained calls, and inert padding rows, both bitwise;
8. training main path: ``cli.main(["--type", "train", ..., "--device",
   "cuda"])`` on 2048 spectra written to disk, the same run on the plain
   version (``TRAIN.ENGINE xla``) for comparison, then ``--type predict``
   from the trained model through the prediction kernel;
9. times of one training epoch of 65536 spectra, kernel and plain, and
   the two epochs' outputs held against each other as in phase 7.

Prints a JSON line of kernel results, then, as its last line,
``{"ok": true, "device": {...}}``. Any failure exits non-zero without
that line. Imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
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
#: training CLI: per-epoch losses of the kernel engine against the plain
#: engine, both with bf16 operands (the CLI default), over 4 epochs
CLI_LOSS_RTOL = 1e-5
PARAM_NAMES = ("F", "Psi", "omega", "tau0", "c0", "beta")
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


def seeded_params(grid, device, regime="moderate"):
    """Parameters inside ParamBounds and a mean continuum, from a seed."""
    from qfa_tpu_torch.models.params import ParamBounds, QFAParams

    r, b = REGIMES[regime], ParamBounds()
    g = torch.Generator().manual_seed(SEED)
    params = QFAParams(
        F=uniform(g, (grid.npix, NH), -0.5, 0.5),
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
    h = torch.randn(n, NH, generator=g, device=dev)
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


def phase_kernel_vs_plain(device):
    from qfa_tpu_torch.data.grid import make_grid
    from qfa_tpu_torch.ops.common import loglam_row, zq_column
    from qfa_tpu_torch.ops.infer_kernel import fused_predict, fused_predict_plain

    worst = 0.0
    cases = (("SDSS", SDSS, 4096, "moderate"), ("DESI", DESI, 512, "moderate"),
             ("SDSS", SDSS, 4096, "low-noise"))
    for label, grid_kw, n, regime in cases:
        grid = make_grid(**grid_kw)
        params, mu = seeded_params(grid, device, regime)
        flux, error, mask, zq = draw_spectra(params, mu, grid, n, SEED + n,
                                             regime)
        mask[[0, 17, n - 1]] = 0.0  # fully masked rows
        flux, error = flux * mask, error * mask
        zabs = torch.tensor(grid.zabs(zq.cpu().numpy()), dtype=torch.float32,
                            device=device)
        tol = dict(TOL)
        if regime == "low-noise":
            tol["ll"] = dict(rtol=LOW_NOISE_LL_RTOL, atol=0.0)
        modes = {
            "mask plane + zabs plane": ((zabs, mask), {}),
            "derived mask + zq column": (
                (zq_column(zq), None),
                dict(loglam=loglam_row(grid.wav, device=device),
                     derive_zabs=True)),
        }
        for mode, (args, kw) in modes.items():
            for stats_only in (False, True):
                got = fused_predict(params, mu, flux, error, *args,
                                    stats_only=stats_only, **kw)
                torch.cuda.synchronize()
                want = fused_predict_plain(params, mu, flux, error, *args,
                                           stats_only=stats_only, **kw)
                torch.cuda.synchronize()
                name = (f"{label} {regime} {mode}"
                        f"{' stats_only' if stats_only else ''}")
                err, detail = compare(name, got, want, tol)
                check(float(got.ll[0]) == 0.0 and float(got.n_obs[0]) == 0.0,
                      f"{name}: fully masked row is not inert")
                worst = max(worst, err)
                say(f"  {name}: n={n} npix={grid.npix} ll in "
                    f"[{float(got.ll[1:].min()):.1f}, "
                    f"{float(got.ll.max()):.1f}]; max_abs_err={err!r}; "
                    f"max rel err {detail}")
    return worst


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
    with open(os.path.join(out, "log.txt")) as f:
        check("fused CUDA kernel" in f.read(), "CLI did not take the kernel")
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


def phase_times(device, n=65536, reps=5):
    from qfa_tpu_torch.data.grid import make_grid
    from qfa_tpu_torch.ops.common import loglam_row, zq_column
    from qfa_tpu_torch.ops.infer_kernel import fused_predict, fused_predict_plain

    grid = make_grid(**SDSS)
    params, mu = seeded_params(grid, device)
    flux, error, mask, zq = draw_spectra(params, mu, grid, n, SEED + 3)
    flux, error = flux * mask, error * mask
    args = (params, mu, flux, error, zq_column(zq))
    kw = dict(loglam=loglam_row(grid.wav, device=device), derive_zabs=True)
    out = {}
    for stats_only in (False, True):
        runs = {
            "kernel": lambda: fused_predict(*args, stats_only=stats_only, **kw),
            "plain": lambda: fused_predict_plain(*args, stats_only=stats_only,
                                                 **kw),
        }
        for fn in runs.values():  # warm-up
            fn()
        torch.cuda.synchronize()
        samples = {"kernel": [], "plain": []}
        for order in (("plain", "kernel"), ("kernel", "plain")):
            for which in order:
                samples[which].append(time_cuda(runs[which], reps))
        out[stats_only] = {k: statistics.median(v) for k, v in samples.items()}
    return out, n


def train_problem(grid, params, mu, n, seed):
    """Residual planes of n drawn spectra on the params' device, with the
    zabs plane, the mask and the zq column."""
    from qfa_tpu_torch.models.qfa import absorption
    from qfa_tpu_torch.ops.common import zq_column

    flux, error, mask, zq = draw_spectra(params, mu, grid, n, seed)
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


def compare_epoch(name, got, want, mode):
    """Kernel against plain outputs of fused_train_epoch, held to
    EPOCH_LIMITS[mode]; returns the max abs error over the parameters
    and a summary."""
    lim = EPOCH_LIMITS[mode]
    lk, lp = got.loss_sums.flatten(), want.loss_sums.flatten()
    check(bool(torch.isfinite(lk).all()), f"{name}: loss sums not finite")
    rel = float(((lk - lp).abs() / lp.abs()).max())
    check(rel <= lim["loss"], f"{name}: per-batch loss sums differ by "
          f"{rel:.3g}")
    first = float((lk[0] - lp[0]).abs() / lp[0].abs())
    check(first <= FIRST_LOSS_RTOL,
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
    # (label, grid, spectra, batch, tile, epochs, layouts); the last case
    # is the training CLI's shape in phase 8: 2048 spectra padded to 5
    # batches of 500 rows (the last backward chunk of each batch holds
    # 20 of 32 rows), tile 4, 4 epochs, derived layout
    cases = (("SDSS", SDSS, 4096, 512, tb, 2, ("derived", "plane")),
             ("DESI", DESI, 512, 256, tb, 1, ("derived", "plane")),
             ("SDSS CLI shape", SDSS, 2048, 500, pick_tiling(500)[0], 4,
              ("derived",)))
    for label, grid_kw, n, batch, tile, n_epochs, layouts in cases:
        grid = make_grid(**grid_kw)
        params, mu = seeded_params(grid, device)
        data = pad_rows(train_problem(grid, params, mu, n, SEED + 21),
                        -(-n // batch) * batch - n)
        rows = data["delta"].shape[0]
        st = adam.init(params)
        g = torch.Generator().manual_seed(SEED)
        perm = torch.stack([torch.randperm(rows // tile, generator=g)
                            for _ in range(n_epochs)])
        for name in layouts:
            zabs, mask, kw = layout(grid, data, name)
            for mxu in (False, True):
                args = (params, st.m, st.v, data["delta"], data["error"],
                        zabs, perm, mask)
                kw2 = dict(kw, epoch=0, n_batches=rows // batch,
                           n_epochs=n_epochs, tile_batch=tile, mxu_bf16=mxu)
                got = fused_train_epoch(*args, **kw2)
                torch.cuda.synchronize()
                want = fused_train_epoch_plain(*args, **kw2)
                torch.cuda.synchronize()
                case = (f"{label} {name} layout, "
                        f"{'bf16' if mxu else 'f32'} operands")
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
    zero; then the same run on the plain version, and a prediction from
    the trained model."""
    from qfa_tpu_torch import cli
    from qfa_tpu_torch.models.params import load_npz
    from qfa_tpu_torch.ops import epoch_kernel, infer_kernel

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

    out_p = os.path.join(root, "train_plain")
    run_p = cli.main(base + ["--output_dir", out_p] + opts
                     + ["TRAIN.ENGINE", "xla"])
    check(epoch_kernel.LAUNCHES == launches,
          "the plain engine launched the epoch kernel")
    check(run_p["engine"] == "plain", f"plain run engine {run_p['engine']}")
    hk, hp = np.asarray(run_k["history"]), np.asarray(run_p["history"])
    rel = float(np.max(np.abs(hk - hp) / np.abs(hp)))
    check(rel <= CLI_LOSS_RTOL, f"CLI train losses of kernel and plain "
          f"engine differ by {rel:.3g}: {hk} vs {hp}")

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
    return launches, run_k, run_p, rel


def phase_train_times(device, n=65536, batch=500, plain_reps=1, reps=3):
    """One epoch of n SDSS spectra at the CLI's batch and tiling, derived
    layout; kernel and plain version, bf16 operands on and off."""
    from qfa_tpu_torch.data.grid import make_grid
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
    for mxu in (True, False):
        args = (params, st.m, st.v, data["delta"], data["error"], zq, perm)
        kw2 = dict(kw, epoch=0, n_batches=n_batches, tile_batch=tb,
                   mxu_bf16=mxu)
        runs = {"kernel": lambda: fused_train_epoch(*args, **kw2),
                "plain": lambda: fused_train_epoch_plain(*args, **kw2)}
        # the warm-up outputs, held against each other
        got, want = runs["kernel"](), runs["plain"]()
        torch.cuda.synchronize()
        err, detail = compare_epoch(
            f"one epoch of {n} spectra, {'bf16' if mxu else 'f32'} operands",
            got, want, f"bf16, {n_batches} updates" if mxu else "f32")
        samples = {"kernel": [], "plain": []}
        for order in (("plain", "kernel"), ("kernel", "plain")):
            for which in order:
                samples[which].append(time_cuda(
                    runs[which], reps if which == "kernel" else plain_reps))
        out[mxu] = {k: statistics.median(v) for k, v in samples.items()}
        out[mxu].update(max_abs_err=err, detail=detail)
    return out, n, n_batches, tb


def main():
    if not torch.cuda.is_available():
        say("chip_smoke: FAIL: torch.cuda.is_available() is False")
        return 1
    from qfa_tpu_torch.data.grid import make_grid
    from qfa_tpu_torch.ops import _build, epoch_kernel, infer_kernel

    device = torch.device("cuda")
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
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
    for line in _build.build_log().splitlines():
        if "registers" in line or ("spill" in line
                                   and " 0 bytes spill" not in line):
            say(f"  {line.strip()}")

    # 3. kernel against plain version
    say("phase 3 kernel vs plain version on the card:")
    worst = phase_kernel_vs_plain(device)

    grid = make_grid(**SDSS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        params, mu = seeded_params(grid, torch.device("cpu"))
        ckpt, data_dir, catalog, names, raw = write_survey(
            root, params.to(device), mu.to(device), grid, 2048)
        # the main path's launches are counted from here ...
        infer_kernel.LAUNCHES = epoch_kernel.LAUNCHES = 0
        cli_launches, timing, n_sample = phase_cli(
            root, ckpt, data_dir, catalog, names, grid)
        say(f"phase 4 CLI predict: {timing['n']} spectra, read "
            f"{timing['read_s']:.3f} s, device {timing['predict_s']:.3f} s, "
            f"write {timing['write_s']:.3f} s; {cli_launches} launch(es); "
            f"{n_sample} spectra match the CPU plain path")
        serve_launches, latencies, pred, responses = phase_serving(ckpt, raw)
        main_launches = infer_kernel.LAUNCHES  # ... to here
        check_responses(pred, responses, raw)
        say("phase 5 serving: /healthz engine fused; " + ", ".join(
            f"{n} spectra {dt * 1e3:.1f} ms" for n, dt in latencies)
            + f" (HTTP, host clock); {serve_launches} launch(es); "
            "responses equal the direct call")

    check(main_launches == cli_launches + serve_launches,
          "launch count moved outside the main path")
    check(epoch_kernel.LAUNCHES == 0, "the predict path launched the "
          "epoch kernel")
    times, n = phase_times(device)
    for stats_only, t in times.items():
        mode = "stats_only" if stats_only else "full output"
        say(f"phase 6 times ({smi}), SDSS width, {n} spectra, {mode}: "
            f"kernel {t['kernel']!r} ms ({n / t['kernel'] * 1e3:.0f} "
            f"spectra/s), plain {t['plain']!r} ms "
            f"({n / t['plain'] * 1e3:.0f} spectra/s)")

    # 7. epoch kernel against plain version
    say("phase 7 epoch kernel vs plain version on the card:")
    train_worst = phase_epoch_vs_plain(device)

    # 8. training main path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        t0 = time.perf_counter()
        train_launches, run_k, run_p, rel = phase_train_cli(root, grid)
        say(f"phase 8 CLI train: {run_k['n']} spectra, batch 500, "
            f"{len(run_k['history'])} epochs; read {run_k['read_s']:.3f} s, "
            f"train {run_k['train_s']:.3f} s (kernel) / "
            f"{run_p['train_s']:.3f} s (plain); {train_launches} epoch-"
            f"kernel call(s); losses {[round(x, 4) for x in run_k['history']]}"
            f" match the plain engine to {rel:.2e}; checkpoints, "
            "metrics.jsonl and model_parameters.npz written; --type predict "
            "from the trained model ran the prediction kernel; phase "
            f"{time.perf_counter() - t0:.1f} s")

    # 9. training times
    ttimes, tn, n_batches, tb = phase_train_times(device)
    for mxu, t in ttimes.items():
        say(f"phase 9 times ({smi}), one training epoch, SDSS width, {tn} "
            f"spectra, batch 500 ({n_batches} batches, tile {tb}), derived "
            f"layout, {'bf16' if mxu else 'f32'} operands: kernel "
            f"{t['kernel']!r} ms ({tn / t['kernel'] * 1e3:.0f} spectra/s), "
            f"plain {t['plain']!r} ms ({tn / t['plain'] * 1e3:.0f} "
            f"spectra/s); kernel against plain: params max_abs_err="
            f"{t['max_abs_err']!r}; {t['detail']}")
        train_worst = max(train_worst, t["max_abs_err"])
    say(json.dumps({"kernels": [{
        "name": "predict_kernel",
        "route": "cuda",
        "source": "qfa_tpu_torch/csrc/predict.cu",
        "replaces": "qfa_tpu/ops/infer_kernel.py:90",
        "launches": main_launches,
        "max_abs_err": worst,
        "ms": times[False]["kernel"],
        "plain_ms": times[False]["plain"],
    }, {
        "name": "epoch_kernel",
        "route": "cuda",
        "source": "qfa_tpu_torch/csrc/epoch.cu",
        "replaces": "qfa_tpu/ops/epoch_kernel.py:237",
        "launches": train_launches,
        "max_abs_err": train_worst,
        "ms": ttimes[True]["kernel"],
        "plain_ms": ttimes[True]["plain"],
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
