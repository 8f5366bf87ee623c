#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs the port's prediction and serving path once on the card, at the full
width of the SDSS model the repository ships (Npix 1913, Nb 720, Nh 8),
with parameters and spectra made from a seed:

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
6. times of the kernel and the plain version over 65536 spectra.

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


def main():
    if not torch.cuda.is_available():
        say("chip_smoke: FAIL: torch.cuda.is_available() is False")
        return 1
    from qfa_tpu_torch.data.grid import make_grid
    from qfa_tpu_torch.ops import _build, infer_kernel

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
        infer_kernel.LAUNCHES = 0
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
    times, n = phase_times(device)
    for stats_only, t in times.items():
        mode = "stats_only" if stats_only else "full output"
        say(f"phase 6 times ({smi}), SDSS width, {n} spectra, {mode}: "
            f"kernel {t['kernel']!r} ms ({n / t['kernel'] * 1e3:.0f} "
            f"spectra/s), plain {t['plain']!r} ms "
            f"({n / t['plain'] * 1e3:.0f} spectra/s)")
    say(json.dumps({"kernels": [{
        "name": "predict_kernel",
        "route": "cuda",
        "source": "qfa_tpu_torch/csrc/predict.cu",
        "replaces": "qfa_tpu/ops/infer_kernel.py:90",
        "launches": main_launches,
        "max_abs_err": worst,
        "ms": times[False]["kernel"],
        "plain_ms": times[False]["plain"],
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
