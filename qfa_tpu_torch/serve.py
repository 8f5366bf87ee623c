"""Online serving: a warm predictor behind a stdlib HTTP API.

* :class:`QFAPredictor` — loads a checkpoint once onto its device and
  serves the full prediction contract per spectrum: ``ll`` (OOD score),
  posterior ``hmean``/``hcov``, ``continuum``, ``continuum_std`` and
  ``n_obs``. Requests above ``max_batch`` are cut into chunks.
* :func:`make_http_server` / :func:`main` — a dependency-free
  ``ThreadingHTTPServer`` exposing ``POST /predict`` (JSON in/out) and
  ``GET /healthz``.

The JSON contract and the ``-999`` sentinel handling are those of
``qfa_tpu.serve``. Engine ``"fused"`` is the CUDA prediction kernel
(``ops.infer_kernel.fused_predict``), ``"plain"`` the batched torch path;
``"auto"`` picks ``fused`` on a CUDA device and ``plain`` elsewhere, as
the CLI does.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .data.grid import (
    DEFAULT_DLOGLAM as REFERENCE_LOGLAM_DELTA,
    DEFAULT_LAMMAX as REFERENCE_LAMMAX,
    DEFAULT_LAMMIN as REFERENCE_LAMMIN,
    make_grid,
)
from .data.loader import MISSING
from .models import load_npz
from .models.qfa import ModelOptions, predict
from .utils.device import resolve_device

__all__ = ["QFAPredictor", "make_http_server", "main"]


class QFAPredictor:
    """Warm continuum predictor for online serving.

    Parameters
    ----------
    checkpoint:
        Path to a reference-schema npz (``mu, F, Psi, omega, tau0, c0,
        beta``).
    max_batch:
        Spectra per device call; larger requests are chunked.
    engine:
        ``"plain"`` | ``"fused"`` | ``"auto"`` (fused on a CUDA device).
    device:
        Torch device of the model; ``"cuda"`` raises when no GPU is
        visible instead of serving from the CPU.
    """

    def __init__(
        self,
        checkpoint: str,
        *,
        max_batch: int = 64,
        tau_which: str = "becker",
        engine: str = "auto",
        compat_c0_bug: bool = False,
        lammin: float = REFERENCE_LAMMIN,
        lammax: float = REFERENCE_LAMMAX,
        loglam_delta: float = REFERENCE_LOGLAM_DELTA,
        device="cuda",
    ) -> None:
        if engine not in ("auto", "plain", "fused"):
            raise ValueError(f"unknown engine {engine!r}")
        if max_batch < 1:
            raise ValueError("max_batch must be positive")
        self.device = resolve_device(device)
        self.params, self.mu = load_npz(
            checkpoint, compat_c0_bug=compat_c0_bug, device=self.device
        )
        self.grid = make_grid(lammin, lammax, loglam_delta)
        npix = int(self.params.F.shape[0])
        if self.grid.npix != npix:
            raise ValueError(
                f"checkpoint has Npix={npix} but the wavelength grid "
                f"[{lammin}, {lammax}) at dloglam={loglam_delta} has "
                f"{self.grid.npix} pixels — pass the grid the model was "
                "trained on"
            )
        self.options = ModelOptions(tau_which=tau_which)
        if engine == "auto":
            engine = "fused" if self.device.type == "cuda" else "plain"
        self.engine = engine
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._requests = 0

    def _run_block(self, flux, error, zabs, mask):
        """One device call on a block of at most ``max_batch`` spectra."""
        def dev(x):
            return torch.from_numpy(x).to(self.device)

        if self.engine == "fused":
            from .ops.infer_kernel import fused_predict

            out = fused_predict(
                self.params, self.mu, dev(flux), dev(error), dev(zabs),
                dev(mask), tau_which=self.options.tau_which,
            )
            res = out[:5]
        else:
            res = predict(self.params, self.mu, dev(flux), dev(error),
                          dev(zabs), dev(mask), self.options)
        return [t.cpu().numpy() for t in res]

    def predict(
        self,
        flux: np.ndarray,
        error: np.ndarray,
        zqso: np.ndarray,
        mask: np.ndarray | None = None,
    ) -> dict:
        """Predict a batch of spectra; returns host numpy arrays.

        Accepts the ``-999.`` missing-pixel sentinel in flux or error on
        top of an optional explicit ``mask``.
        """
        flux = np.asarray(flux, np.float32)
        error = np.asarray(error, np.float32)
        zqso = np.atleast_1d(np.asarray(zqso, np.float32))
        if flux.size == 0 and zqso.size == 0:
            # an empty request (JSON `[]` arrives as shape (0,)) reaches
            # the empty-result path below
            flux = flux.reshape(0, self.grid.npix)
            error = error.reshape(0, self.grid.npix)
        flux = np.atleast_2d(flux)
        error = np.atleast_2d(error)
        n, npix = flux.shape
        if npix != self.grid.npix:
            raise ValueError(
                f"request has {npix} pixels, model grid has {self.grid.npix}"
            )
        if error.shape != flux.shape or zqso.shape != (n,):
            raise ValueError(
                f"shape mismatch: flux {flux.shape}, error {error.shape}, "
                f"zqso {zqso.shape}"
            )
        m = (flux != MISSING) & (error != MISSING) & (error > 0.0)
        if mask is not None:
            m &= np.atleast_2d(np.asarray(mask)).astype(bool)
        flux = np.where(m, flux, 0.0).astype(np.float32)
        error = np.where(m, error, 0.0).astype(np.float32)
        zabs = self.grid.zabs(zqso).astype(np.float32)
        mf = m.astype(np.float32)
        if n == 0:  # an empty request is a valid (empty) result
            nh = int(self.params.F.shape[1])
            f32 = np.float32
            return {
                "ll": np.zeros((0,), f32),
                "hmean": np.zeros((0, nh), f32),
                "hcov": np.zeros((0, nh, nh), f32),
                "continuum": np.zeros((0, npix), f32),
                "continuum_std": np.zeros((0, npix), f32),
                "n_obs": np.zeros((0,), np.int64),
            }

        mb = self.max_batch
        parts = []
        with self._lock:
            self._requests += 1
            for s in range(0, n, mb):
                e = min(s + mb, n)
                parts.append(self._run_block(
                    flux[s:e], error[s:e], zabs[s:e], mf[s:e]
                ))
        ll, hmean, hcov, cont, std = (
            np.concatenate([p[i] for p in parts]) for i in range(5)
        )
        return {
            "ll": ll, "hmean": hmean, "hcov": hcov,
            "continuum": cont, "continuum_std": std,
            "n_obs": m.sum(axis=1),
        }

    def warmup(self) -> None:
        """Run one prediction (builds the CUDA kernel) before traffic."""
        z = np.full((1,), 2.5, np.float32)
        f = np.ones((1, self.grid.npix), np.float32)
        e = np.full((1, self.grid.npix), 0.1, np.float32)
        self.predict(f, e, z)

    @property
    def info(self) -> dict:
        return {
            "status": "ok",
            "npix": int(self.grid.npix),
            "nh": int(self.params.F.shape[1]),
            "engine": self.engine,
            "device": str(self.device),
            "max_batch": int(self.max_batch),
            "tau": self.options.tau_which,
            "requests": self._requests,
        }


def make_http_server(
    predictor: QFAPredictor, host: str = "127.0.0.1", port: int = 8777
) -> ThreadingHTTPServer:
    """Bind (but do not start) the serving endpoint.

    ``POST /predict`` body: ``{"flux": [[...]], "error": [[...]],
    "zqso": [...], "mask": [[...]]?}`` -> the per-spectrum prediction
    contract as JSON lists. ``GET /healthz`` -> model/engine metadata.
    Call ``serve_forever()`` on the result (or use :func:`main`).
    """

    def jsonable(v: np.ndarray) -> list:
        # strict JSON: non-finite outputs become null, never the bare
        # NaN/Infinity tokens json.dumps emits by default
        if v.dtype.kind == "f" and not np.isfinite(v).all():
            obj = v.astype(object)
            obj[~np.isfinite(v)] = None
            return obj.tolist()
        return v.tolist()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload, allow_nan=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                self._send(200, predictor.info)
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802 (stdlib API)
            if self.path != "/predict":
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                req = json.loads(
                    self.rfile.read(int(self.headers["Content-Length"]))
                )
                out = predictor.predict(
                    np.asarray(req["flux"], np.float32),
                    np.asarray(req["error"], np.float32),
                    np.asarray(req["zqso"], np.float32),
                    np.asarray(req["mask"]) if "mask" in req else None,
                )
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, {"error": str(e)})
                return
            self._send(200, {k: jsonable(v) for k, v in out.items()})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> None:
    """``qfa-tpu-torch-serve``: load a checkpoint and serve predictions."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--ckpt", required=True, help="model npz checkpoint")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8777)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--tau", default="becker",
                    choices=["becker", "fg", "kamble", "mock"])
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "plain", "fused"])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu")
    ap.add_argument("--compat-c0-bug", action="store_true")
    ap.add_argument("--lammin", type=float, default=REFERENCE_LAMMIN)
    ap.add_argument("--lammax", type=float, default=REFERENCE_LAMMAX)
    ap.add_argument("--dloglam", type=float, default=REFERENCE_LOGLAM_DELTA)
    args = ap.parse_args(argv)

    pred = QFAPredictor(
        args.ckpt, max_batch=args.max_batch, tau_which=args.tau,
        engine=args.engine, compat_c0_bug=args.compat_c0_bug,
        lammin=args.lammin, lammax=args.lammax, loglam_delta=args.dloglam,
        device=args.device,
    )
    pred.warmup()
    srv = make_http_server(pred, args.host, args.port)
    print(
        f"qfa-tpu-torch-serve: {pred.info['engine']} engine on "
        f"{pred.info['device']}, npix={pred.info['npix']}, "
        f"nh={pred.info['nh']} — listening on "
        f"http://{args.host}:{srv.server_address[1]}",
        flush=True,
    )
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
