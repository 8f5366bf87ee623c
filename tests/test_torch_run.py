"""The run skeleton the port's three trainers share (``train._run``) and
the package's layering.

Each trainer (``fit``, ``fit_streaming``, ``fit_fused`` at one and at
three epochs per call) is run at a tiny size with smoothing every 3
epochs and checkpoints every 2: all of them write the checkpoints, log
lines and callbacks the reference's rule gives, and with a negative loss
at epoch 5 (the last epoch of a chunk at either chunk length) each
smooths, saves and stops at checkpoint 6. The layering: no kernel module
imports a trainer or a mesh engine, the mesh engines import no trainer
module and no private name of ``train``, and ``pick_tiling`` is written
once."""

from __future__ import annotations

import ast
import logging
import os
import pathlib
import re

import numpy as np
import pytest
import torch

import qfa_tpu_torch
from qfa_tpu_torch.data.loader import ResidualDataset
from qfa_tpu_torch.data.streaming import HostResiduals
from qfa_tpu_torch.models.params import random_init
from qfa_tpu_torch.ops.epoch_kernel import fused_train_epoch_plain
from qfa_tpu_torch.train import (
    TrainConfig,
    fit,
    fit_fused,
    fit_streaming,
    fused_engine,
    loop,
    make_step_fn,
)

NPIX, NB, NH, N, BATCH = 30, 10, 2, 40, 8
MU = np.ones(NPIX, np.float32)
N_EPOCHS, SMOOTH, SAVE, NEGATIVE = 7, 3, 2, 5
PACKAGE = pathlib.Path(qfa_tpu_torch.__file__).parent


def planes():
    rng = np.random.default_rng(0)
    x = (0.1 * rng.normal(size=(N, NPIX))).astype(np.float32)
    err = rng.uniform(0.05, 0.2, (N, NPIX)).astype(np.float32)
    zabs = rng.uniform(2.0, 3.0, (N, NB)).astype(np.float32)
    return x, err, zabs, np.ones((N, NPIX), np.float32)


def params():
    return random_init(NPIX, NB, NH,
                       generator=torch.Generator().manual_seed(1))


def negative_at(epoch, loss):
    return -loss.abs() if epoch == NEGATIVE else loss


def run_trainer(trainer, monkeypatch, negative, **kw):
    """``trainer``'s run, its loss made negative at epoch ``NEGATIVE``
    when ``negative``: (history, log lines)."""
    config = TrainConfig(n_epochs=N_EPOCHS, batch_size=BATCH,
                         learning_rate=1e-2, smooth_interval=SMOOTH,
                         save_interval=SAVE)
    log = logging.getLogger(f"qfa.test_run.{trainer}.{negative}")
    records: list = []
    handler = logging.Handler()
    handler.emit = records.append
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    data = ResidualDataset(*(torch.tensor(a) for a in planes()))
    try:
        if trainer == "fit":
            if negative:
                make = loop.make_epoch_fn

                def make_epoch_fn(config):
                    fn = make(config)

                    def epoch_fn(state, *args):
                        e = int(state.opt_state.epoch)
                        state, loss = fn(state, *args)
                        return state, negative_at(e, loss)

                    return epoch_fn

                monkeypatch.setattr(loop, "make_epoch_fn", make_epoch_fn)
            _, history = fit(params(), data, MU, config, logger=log, **kw)
        elif trainer == "fit_streaming":
            step = make_step_fn(config)

            def step_fn(state, batch):
                e = int(state.opt_state.epoch)
                state, loss = step(state, batch)
                return state, negative_at(e, loss) if negative else loss

            _, history = fit_streaming(
                params(), HostResiduals(*planes()), MU, config, device="cpu",
                step_fn=step_fn, logger=log, **kw)
        else:
            def engine(*args, **kwargs):
                out = fused_train_epoch_plain(*args, **kwargs)
                e0, n = kwargs["epoch"], kwargs["n_epochs"]
                sums = out.loss_sums.reshape(n, -1)
                if negative:
                    sums = torch.stack([negative_at(e0 + k, sums[k])
                                        for k in range(n)])
                return out._replace(
                    loss_sums=sums.reshape(out.loss_sums.shape))

            monkeypatch.setattr(fused_engine, "fused_train_epoch_plain",
                                engine)
            _, history = fit_fused(
                params(), data, MU, config, plain=True, logger=log,
                epochs_per_launch=int(trainer.rsplit("_", 1)[1]), **kw)
    finally:
        log.removeHandler(handler)
    return history, [r.getMessage() for r in records]


@pytest.mark.parametrize("negative", [False, True],
                         ids=["whole_run", "negative_loss"])
@pytest.mark.parametrize("trainer", ["fit", "fit_streaming", "fit_fused_1",
                                     "fit_fused_3"])
def test_the_trainers_agree_on_every_epoch_boundary(tmp_path, monkeypatch,
                                                    trainer, negative):
    calls = []
    history, lines = run_trainer(
        trainer, monkeypatch, negative, output_dir=str(tmp_path),
        metrics_cb=lambda epoch, loss, dt: calls.append((epoch, loss)))
    last = NEGATIVE if negative else N_EPOCHS - 1
    assert len(history) == last + 1
    assert (history[-1] < 0) == negative
    assert all(x > 0 for x in history[:NEGATIVE])
    assert calls == list(enumerate(history))
    assert [re.sub(r"-?\d+\.\d+", "#", x) for x in lines] == [
        f"epoch: {e:03d}/{N_EPOCHS:03d}  ;  loss:  #  ;  time:  # s"
        for e in range(last + 1)]
    ckpts = [c for c in range(1, last + 2) if c % SAVE == 0]
    assert ckpts == [2, 4, 6]  # the stop's own save is checkpoint 6
    assert sorted(os.listdir(tmp_path / "checkpoints")) == sorted(
        f"{k}_epoch_{c:02d}.npz" for k in ("model_parameters", "state")
        for c in ckpts)


def imports(path: pathlib.Path) -> list[str]:
    """Every module ``path`` imports (at its top or inside a function),
    with each name taken from it as ``module.name``, resolved against the
    package."""
    pkg = path.relative_to(PACKAGE.parent).with_suffix("").parts[:-1]
    found = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = ".".join(pkg[:len(pkg) - node.level + 1]) \
                if node.level else ""
            mod = ".".join(x for x in (base, node.module) if x)
            found += [mod] + [f"{mod}.{a.name}" for a in node.names]
    return found


def modules(sub: str) -> list[pathlib.Path]:
    return sorted((PACKAGE / sub).glob("*.py"))


def test_no_kernel_module_imports_a_trainer_or_a_mesh_engine():
    bad = [(p.name, m) for p in modules("ops") for m in imports(p)
           if m.startswith(("qfa_tpu_torch.train", "qfa_tpu_torch.parallel"))]
    assert modules("ops") and not bad, bad


TRAINERS = ("qfa_tpu_torch.train.fused_engine", "qfa_tpu_torch.train.loop",
            "qfa_tpu_torch.train._run")


def test_the_mesh_engines_import_no_trainer_and_no_private_train_name():
    bad = [(p.name, m) for p in modules("parallel") for m in imports(p)
           if m.startswith(TRAINERS) or (m.startswith("qfa_tpu_torch.train.")
                                         and "._" in m)]
    assert modules("parallel") and not bad, bad


def test_fit_imports_no_other_trainer():
    assert not [m for m in imports(PACKAGE / "train" / "loop.py")
                if m.startswith("qfa_tpu_torch.train.fused_engine")]


def test_pick_tiling_is_written_once():
    defs = [p.relative_to(PACKAGE) for p in PACKAGE.rglob("*.py")
            for node in ast.walk(ast.parse(p.read_text()))
            if isinstance(node, ast.FunctionDef)
            and node.name == "pick_tiling"]
    assert [str(p) for p in defs] == [os.path.join("data", "shuffle.py")]
