"""A whole run at a tiny size on the CPU, the harness's look for a chip
skipped, with the timed path broken underneath: ``correct`` has to come
out false for each fault the cells can have (a step that returns its
state unchanged; half of each batch left out, the mean taken over the
rest; an answer altered where it is produced), in training also when
only the window's epochs are broken. The benchmark's cells run on one
chip each, so no cell has an exchange between chips to leave out."""

from __future__ import annotations

import pytest
import torch

import qfa_tpu_torch.ops.infer_kernel as infer_kernel
import qfa_tpu_torch.train.fused_engine as fused_engine
from portbench import run, spec as spec_mod

CPU = torch.device("cpu")
SEED = 2**33 + 17
#: the epoch counter the window starts at (the traffic's set-up epochs)
WINDOW = 5


def result(root, cell, control=None):
    spec = spec_mod.Spec(root, root / "portbench")
    return run.run_cell(spec, cell, SEED, 0.3, False, CPU, control)


def unchanged(real):
    def step(params, m, v, *args, **kw):
        out = real(params, m, v, *args, **kw)
        return out._replace(params=params, m=m, v=v)
    return step


def half(real):
    def step(params, m, v, delta, error, zabs, tile_perm, mask=None, **kw):
        tb = kw["tile_batch"]
        n_b = kw["n_batches"]
        perm = torch.as_tensor(tile_perm).reshape(-1, n_b, tile_perm.shape[-1]
                                                  // n_b)
        gone = perm[..., perm.shape[-1] // 2:].reshape(-1)
        rows = (gone[:, None] * tb + torch.arange(tb)[None, :]).reshape(-1)
        error, zabs = error.clone(), zabs.clone()
        error[rows] = 0.0  # inert rows ...
        zabs[rows, 1] = 0.0  # ... left out of each batch's mean
        return real(params, m, v, delta, error, zabs, tile_perm, mask, **kw)
    return step


def no_decay(real):
    def step(*args, **kw):
        return real(*args, **dict(kw, decay_alpha=1.0))
    return step


def in_window(fault, real):
    """``fault`` only in the epochs the window runs."""
    broken = fault(real)

    def step(*args, **kw):
        return (broken if kw["epoch"] >= WINDOW else real)(*args, **kw)
    return step


def test_state_left_unchanged(tiny_root, monkeypatch):
    monkeypatch.setattr(fused_engine, "fused_train_epoch",
                        unchanged(fused_engine.fused_train_epoch))
    line = result(tiny_root, "sdss-train")
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_each_batch_left_out(tiny_root, monkeypatch):
    monkeypatch.setattr(fused_engine, "fused_train_epoch",
                        half(fused_engine.fused_train_epoch))
    line = result(tiny_root, "sdss-train")
    assert line["correct"] is False


@pytest.mark.parametrize("fault", [unchanged, half, no_decay])
def test_a_fault_in_the_window_only(tiny_root, monkeypatch, fault):
    """Set-up's epochs sound, the window's broken: the window's own
    numbers fail (for ``no_decay``, the learning rate's decay at epoch
    counter 10 left out)."""
    monkeypatch.setattr(fused_engine, "fused_train_epoch",
                        in_window(fault, fused_engine.fused_train_epoch))
    line = result(tiny_root, "sdss-train")
    checks = line["checks"]
    assert line["correct"] is False
    assert all(v["value"] <= v["limit"] for k, v in checks.items()
               if not k.startswith("window_")), checks
    assert any(v["value"] > v["limit"] for k, v in checks.items()
               if k.startswith("window_")), checks


def test_smoothing_left_out_of_the_window(tiny_root, monkeypatch):
    """Set-up smooths at its last epoch; the window's smoothing at its
    first checkpoint is left out."""
    real, calls = fused_engine.smooth_params, []

    def once(params):
        calls.append(1)
        return real(params) if len(calls) == 1 else params

    monkeypatch.setattr(fused_engine, "smooth_params", once)
    line = result(tiny_root, "sdss-train")
    assert len(calls) >= 2
    assert line["correct"] is False
    assert line["checks"]["window_change_gap"]["value"] > line["checks"][
        "window_change_gap"]["limit"]


@pytest.mark.parametrize("cell,field", [("desi-predict", "ll"),
                                        ("desi-predict", "n_obs")])
def test_an_answer_altered_where_it_is_produced(tiny_root, monkeypatch, cell,
                                                field):
    """One spectrum's score off by one nat, or its count of observed
    pixels off by one."""
    real = infer_kernel.fused_predict

    def altered(*args, **kw):
        out = real(*args, **kw)
        x = getattr(out, field).clone()
        x[0] += 1.0
        return out._replace(**{field: x})

    monkeypatch.setattr(infer_kernel, "fused_predict", altered)
    line = result(tiny_root, cell)
    assert line["correct"] is False
    assert line["checks"][f"{field}_gap"]["value"] > line["checks"][
        f"{field}_gap"]["limit"]


@pytest.mark.parametrize("cell,control", [("sdss-train", "fp8"),
                                          ("sdss-train", "half_batch"),
                                          ("desi-predict", "tf32")])
def test_the_control_is_not_correct(tiny_root, cell, control):
    """The reference in the program's place, in the precision below the
    stated one (or with the fault planted), fails the committed limits."""
    line = result(tiny_root, cell, control)
    assert line["correct"] is False


@pytest.mark.parametrize("cell", ["sdss-train", "desi-predict"])
def test_a_sound_run_is_correct(tiny_root, cell):
    """Unbroken, the same tiny run passes the committed limits."""
    line = result(tiny_root, cell)
    assert line["correct"] is True, line["checks"]
