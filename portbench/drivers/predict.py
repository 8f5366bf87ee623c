"""Continuum prediction over a survey resident on the card: one sweep is
``ops.infer_kernel.fused_predict`` over the planes in the CLI's chunks,
in the derived layout (mask from ``error > 0``, the zq column and the
loglam row), with the full output (ll, n_obs, hmean, hcov, continuum and
its std) kept on the card. The window runs whole sweeps, one
synchronization each, and closes at the first sweep end after
``seconds``; the check holds every row of the last sweep against the
reference."""

from __future__ import annotations

import contextlib
import time

from .. import gen
from ..reference import compare
from ..reference import model as ref
from . import Base, sync

FIELDS = ("ll", "n_obs", "hmean", "hcov", "continuum", "continuum_std")


class Driver(Base):
    def setup(self) -> None:
        from qfa_tpu_torch.models.params import QFAParams
        from qfa_tpu_torch.ops.common import loglam_row, zq_column

        c, t, dev = self.config, self.traffic, self.device
        self.grid = gen.make_grid(c)
        self.flux, self.error, self.zqso, self.mu = gen.spectra(
            t["n_spectra"], self.grid, c["nh"], self.seed, dev, t)
        self.truth = gen.truth_params(self.grid, c["nh"], self.seed, dev,
                                      gen.traffic_truth(t))
        self.params = QFAParams(**self.truth).requires_grad_(False)
        self.zq = zq_column(self.zqso)
        self.loglam = loglam_row(self.grid.wav, device=dev)
        self.outs = [None] * len(self._chunks())
        for _ in range(2):  # builds the kernel; the second sweep allocates
            self._sweep(lambda name: contextlib.nullcontext())  # as the rest
        sync(self.device)

    def _chunks(self):
        n, ch = self.traffic["n_spectra"], self.traffic["chunk"]
        return [(s, min(s + ch, n)) for s in range(0, n, ch)]

    def _sweep(self, span) -> None:
        from qfa_tpu_torch.ops.infer_kernel import fused_predict

        with span("portbench.predict.sweep"):
            for i, (s, e) in enumerate(self._chunks()):
                self.outs[i] = fused_predict(
                    self.params, self.mu, self.flux[s:e], self.error[s:e],
                    self.zq[s:e], None, loglam=self.loglam, derive_zabs=True,
                    stats_only=self.traffic["stats_only"])
            sync(self.device)

    def window(self, seconds: float, span) -> dict:
        sweeps = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            self._sweep(span)
            sweeps += 1
            if time.perf_counter() >= deadline:
                break
        window_s = time.perf_counter() - t0
        n = self.traffic["n_spectra"]
        self.stats = dict(window_s=window_s, sweeps=sweeps, rows=n,
                          attempted=sweeps * n, failed=0)
        return self.stats

    def release(self) -> None:
        self.params = self.zq = self.loglam = None

    def check(self, control: str | None = None) -> dict:
        gaps = compare.PredictGaps()
        block = self.traffic["check_block"]
        p = self.truth
        for i, (s, e) in enumerate(self._chunks()):
            for a in range(s, e, block):
                b = min(a + block, e)
                r = ref.predict(p, self.mu, self.flux[a:b], self.error[a:b],
                                self.zqso[a:b], self.grid.wav, self.grid.nb)
                if control is None:
                    out = self.outs[i]
                    prog = {k: getattr(out, k)[a - s:b - s] for k in FIELDS
                            if getattr(out, k) is not None}
                else:
                    prog = ref.predict(p, self.mu, self.flux[a:b],
                                       self.error[a:b], self.zqso[a:b],
                                       self.grid.wav, self.grid.nb,
                                       precision=control)
                gaps.add(prog, r)
        return gaps.numbers()
