"""Resident training, as ``cli.py --type train`` runs it by default:
``train.fused_engine.fit_fused`` on the derived layout (mask from
``error > 0``, the zq column and the loglam row), bf16 operands on the
epoch kernel's heavy products, smoothing and a full-state checkpoint
every few epochs into a scratch directory.

Set-up draws the residual planes and the CLI's initial parameters from
the seed, then drives that state through the first epochs by the same
call (checkpointing each, so the state after every epoch can be read
back; the last set-up epoch smooths, so the window loads no kernel) and
hands the state after them to the window. The window calls ``fit_fused``
again from that state, checkpointing as the traffic says, and closes at
the first epoch end after ``seconds`` once it has written its first
checkpoint.

The check follows two stages with the reference. Set-up's first epochs
from the seed's parameters: the first epoch's loss, the first moment
after it and the parameters' change after the last. Then the window's
first stage, from the state handed to the window to the window's first
checkpoint (its epochs' losses, and the first moment and the parameters'
change at the checkpoint, a smoothing and the learning rate's first
decay included): the reference starts there from the program's own
state, read back from set-up's checkpoint, since following set-up's
later epochs would only add their drift. The reference computes in
float64 with its products in the configuration's stated precision (bf16
operands, float32 sums): against float64 products, bf16 rounding alone
moved some seeds' trajectories as far as the fp8 control's (PERF.md).
"""

from __future__ import annotations

import os
import time

import torch

from .. import gen
from ..reference import compare
from ..reference import model as ref
from . import Base, sync


class _Closed(Exception):
    """Raised from the per-epoch callback once the window is over."""


def tile_of(batch: int, limit: int = 256) -> int:
    """The trainer's documented shuffle granule: the largest power of two
    up to ``limit`` that divides the batch."""
    tb = 1
    while tb * 2 <= limit and batch % (tb * 2) == 0:
        tb *= 2
    return tb


class Driver(Base):
    def _opt(self) -> dict:
        t = self.traffic
        return dict(t["optimizer"], batch_size=t["batch_size"],
                    tile=tile_of(t["batch_size"]),
                    smooth_interval=t["smooth_interval"])

    def _train_config(self, n_epochs: int, save_interval: int):
        from qfa_tpu_torch.train import TrainConfig

        t = self.traffic
        o = t["optimizer"]
        return TrainConfig(
            n_epochs=n_epochs, batch_size=t["batch_size"],
            learning_rate=o["learning_rate"], weight_decay=o["weight_decay"],
            decay_alpha=o["decay_alpha"], decay_step=o["decay_step"],
            b1=o["b1"], b2=o["b2"], eps=o["eps"],
            smooth_interval=t["smooth_interval"],
            save_interval=save_interval, mxu_bf16=t["mxu_bf16"])

    def _fit(self, state, cfg, out_dir, metrics_cb=None):
        from qfa_tpu_torch.train.fused_engine import fit_fused

        return fit_fused(None, self.data, self.mu, cfg, seed=self.seed,
                         output_dir=out_dir, initial_state=state,
                         derive_mask=True, loglam=self.loglam,
                         metrics_cb=metrics_cb)

    def _stage(self) -> tuple[int, int]:
        """The window's first stage: from the epoch counter it starts at
        to its first checkpoint."""
        t = self.traffic
        first = t["setup_epochs"]
        return first, (first // t["save_interval"] + 1) * t["save_interval"]

    def _load(self, run: str, epoch: int):
        """The state a call of ``fit_fused`` checkpointed at ``epoch``."""
        from qfa_tpu_torch.train.checkpoint import load_state

        return load_state(os.path.join(
            self.workdir, run, "checkpoints", f"state_epoch_{epoch:02d}.npz"),
            device=self.device)[0]

    def _state(self, run: str, epoch: int) -> dict:
        """A checkpoint's parameters and moments, as dicts."""
        st = self._load(run, epoch)
        return dict(params=st.params.as_dict(), m=st.opt_state.m.as_dict(),
                    v=st.opt_state.v.as_dict())

    def setup(self) -> None:
        from qfa_tpu_torch.data.loader import ResidualDataset
        from qfa_tpu_torch.models.params import QFAParams
        from qfa_tpu_torch.ops.common import loglam_row, zq_column
        from qfa_tpu_torch.train import TrainState, adam

        c, t, dev = self.config, self.traffic, self.device
        self.grid = gen.make_grid(c)
        self.delta, self.error, self.zqso, self.mu = gen.spectra(
            t["n_spectra"], self.grid, c["nh"], self.seed, dev, t,
            residual=True)
        self.p0 = gen.model_params(self.grid, c["nh"], self.seed, dev)
        self.data = ResidualDataset(self.delta, self.error,
                                    zq_column(self.zqso), None)
        self.loglam = loglam_row(self.grid.wav, device=dev)
        params = QFAParams(**{k: v.clone() for k, v in self.p0.items()})
        n = t["setup_epochs"]
        _, losses = self._fit(
            TrainState(params, adam.init(params)),
            self._train_config(n, save_interval=1),
            os.path.join(self.workdir, "setup"))
        self.setup_losses = losses[:t["checked_epochs"]]
        self.start = self._load("setup", n)
        self._refs: dict = {}
        sync(self.device)

    def window(self, seconds: float, span) -> dict:
        t = self.traffic
        first, end = self._stage()
        epochs, epoch_s = [], []
        deadline = time.perf_counter() + seconds

        def on_epoch(epoch, loss, dt):
            epochs.append(loss)
            epoch_s.append(dt)
            # the callback of epoch ``end`` follows the checkpoint at it
            if epoch >= end and time.perf_counter() >= deadline:
                raise _Closed

        cfg = self._train_config(10**9, save_interval=t["save_interval"])
        t0 = time.perf_counter()
        try:
            with span("portbench.train.fit_fused"):
                self._fit(self.start, cfg, os.path.join(self.workdir, "run"),
                          on_epoch)
        except _Closed:
            pass
        window_s = time.perf_counter() - t0
        self.window_losses = epochs[:end - first]
        n = t["n_spectra"]
        self.stats = dict(window_s=window_s, epochs=len(epochs),
                          attempted=len(epochs), failed=sum(
                              1 for x in epochs if not x == x),
                          rows=n, epoch_s=epoch_s)
        return self.stats

    def release(self) -> None:
        self.data = self.start = None

    def _reference(self, stage: str, precision=None, keep_fraction=1.0):
        """The reference through set-up's checked epochs from the seed's
        parameters (``stage="setup"``: losses, first moment after the
        first epoch, parameters after the last) or through the window's
        first stage from the state handed to the window (``"window"``:
        losses, first moment and parameters at its checkpoint): float64,
        its products in the configuration's stated precision unless
        ``precision`` names another."""
        key = (stage, precision, keep_fraction)
        if key in self._refs:
            return self._refs[key]
        precision = precision or self.config["precision"]["train_products"]
        m1 = {}
        if stage == "setup":
            st = ref.init_state(self.p0, torch.float64)
            first, n = 0, self.traffic["checked_epochs"]

            def on_epoch(e, s):
                if not m1:
                    m1.update({k: v.clone() for k, v in s["m"].items()})
        else:
            start = self._state("setup", self._stage()[0])
            st = ref.init_state(start["params"], torch.float64, start["m"],
                                start["v"])
            first, end = self._stage()
            n = end - first
            on_epoch = None
        losses = ref.train_epochs(
            st, self.delta, self.error, self.zqso, self.grid.wav, self.grid.nb,
            self._opt(), seed=self.seed, first_epoch=first, n_epochs=n,
            precision=precision, keep_fraction=keep_fraction,
            on_epoch=on_epoch)
        out = self._refs[key] = (losses, m1 or st["m"], st["params"])
        return out

    def _gaps(self, stage, prog, origin) -> tuple[dict, dict]:
        """Loss, moment and change gaps of ``prog`` (losses, moment,
        parameters) against the reference's ``stage``; the change is
        taken from ``origin``, over the leaves the reference moves."""
        r_loss, r_m, r_p = self._reference(stage)
        p_loss, p_m, p_p = prog
        moving = compare.moving_leaves(r_m)
        change_r = {k: r_p[k] - origin[k].double() for k in moving}
        change_p = {k: p_p[k].double() - origin[k].double() for k in moving}
        moment, m_leaves = compare.leaf_gap(p_m, r_m)
        change, c_leaves = compare.leaf_gap(change_p, change_r)
        losses = [abs(p - r) / abs(r) for p, r in zip(p_loss, r_loss)]
        return (dict(losses=losses, moment=moment, change=change),
                dict(losses=p_loss, ref_losses=r_loss, moment=m_leaves,
                     change=c_leaves, moving=moving))

    def check(self, control: str | None = None) -> dict:
        first, end = self._stage()
        start = self._state("setup", first)["params"]
        if control is None:
            setup = (self.setup_losses, self._state("setup", 1)["m"],
                     self._state("setup", self.traffic["checked_epochs"]
                                 )["params"])
            got = self._state("run", end)
            window = (self.window_losses, got["m"], got["params"])
        else:
            kw = (dict(keep_fraction=0.5) if control == "half_batch"
                  else dict(precision=control))
            setup = self._reference("setup", **kw)
            window = self._reference("window", **kw)
        s, s_detail = self._gaps("setup", setup, self.p0)
        w, w_detail = self._gaps("window", window, start)
        self.detail = dict(setup=s_detail, window=w_detail)
        # set-up: the first epoch's loss (later epochs' losses swing by the
        # trajectory's sensitivity on a few seeds, PERF.md; the change
        # after the last epoch still holds them); the window: each epoch
        # of its stage, which starts from the program's own state
        return {
            "loss_gap": s["losses"][0],
            "moment_gap": s["moment"],
            "change_gap": s["change"],
            "window_loss_gap": max(w["losses"]),
            "window_moment_gap": w["moment"],
            "window_change_gap": w["change"],
        }
