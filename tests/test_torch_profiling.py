"""The port's profiling and NaN debugging (``qfa_tpu_torch.utils.profiling``
and the CLI's ``RUNTIME.PROFILE_DIR`` / ``RUNTIME.DEBUG_NANS``) against the
JAX package's (``qfa_tpu.utils.profiling``, ``qfa_tpu.cli``).

Tolerances: ``tree_health``'s keys, shapes and finiteness equal JAX's,
its magnitudes rtol 1e-6 (float32 sums in numpy on both sides of the same
arrays: equal but for summation order). A run with tracing or NaN
debugging on gives bitwise the outputs of the run without. A NaN put into
the initial parameters raises ``FloatingPointError`` in both packages'
CLIs with ``RUNTIME.DEBUG_NANS``, and trains on (every step rejected, the
loss NaN) without it.
"""

import glob
import json
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qfa_tpu.cli import main as jax_main
from qfa_tpu.models import random_init as jax_random_init
from qfa_tpu.models import save_npz as jax_save_npz
from qfa_tpu.train import TrainState as JaxTrainState
from qfa_tpu.train import adam as jax_adam
from qfa_tpu.utils.profiling import tree_health as jax_tree_health
from qfa_tpu_torch.models.params import QFAParams, load_npz
from qfa_tpu_torch.train import TrainConfig, TrainState, adam, fit_fused
from qfa_tpu_torch.train import fit, fit_streaming
from qfa_tpu_torch.data.loader import ResidualDataset
from qfa_tpu_torch.data.streaming import HostResiduals
from qfa_tpu_torch.utils import profiling
from qfa_tpu_torch.utils.profiling import (
    enable_nan_debugging,
    first_nonfinite,
    nan_debugging,
    timed,
    trace,
    tree_health,
)
from test_torch_guards import GRID_OPTS, cli_train, write_training_set


class Pair(NamedTuple):
    a: object
    b: object


def jax_params():
    p = jax_random_init(jax.random.key(0), 6, 3, 2)
    return p._replace(Psi=p.Psi.at[2].set(jnp.nan),
                      beta=jnp.asarray(jnp.inf))


def assert_health_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k]["shape"] == want[k]["shape"], k
        assert got[k]["finite"] is want[k]["finite"], k
        for m in ("absmax", "absmean"):
            np.testing.assert_allclose(got[k][m], want[k][m], rtol=1e-6,
                                       err_msg=f"{k} {m}")


@pytest.mark.parametrize("kind", ["params", "state", "nested", "tensor"])
def test_tree_health_equals_jax(kind):
    """The same keys (``jax.tree_util.keystr``) and values for QFAParams,
    the train state (a dataclass of NamedTuples), dicts / lists /
    NamedTuples with None, and a lone tensor."""
    jp = jax_params()
    np_p = {k: np.asarray(v) for k, v in jp.as_dict().items()}
    pp = QFAParams.from_numpy(np_p)
    if kind == "params":
        got, want = tree_health(pp), jax_tree_health(jp)
    elif kind == "state":
        got = tree_health(TrainState(pp, adam.init(pp)))
        want = jax_tree_health(JaxTrainState(jp, jax_adam.init(jp)))
    elif kind == "nested":
        x = np.arange(6, dtype=np.float32).reshape(2, 3) - 2.5
        got = tree_health({"z": [torch.tensor(x), (torch.zeros(0), None)],
                           "a": Pair(torch.tensor(1.5), {"k": torch.tensor(x)}),
                           "n": 3})
        want = jax_tree_health({"z": [jnp.asarray(x), (jnp.zeros(0), None)],
                                "a": Pair(jnp.asarray(1.5),
                                          {"k": jnp.asarray(x)}), "n": 3})
    else:
        got = tree_health(torch.tensor([1.0, -np.inf]))
        want = jax_tree_health(jnp.asarray([1.0, -np.inf]))
    assert_health_equal(got, want)
    assert any(not v["finite"] for v in got.values()) == (kind != "nested")


def test_first_nonfinite_names_the_leaf():
    pp = QFAParams.from_numpy({k: np.asarray(v) for k, v in
                               jax_params().as_dict().items()})
    assert first_nonfinite(pp) == ".Psi"
    assert profiling.nonfinite_leaf(m={"ok": torch.ones(2)}, p=pp) == "p.Psi"
    assert first_nonfinite([1.0, float("nan")]) == "[1]"
    assert first_nonfinite({"x": torch.ones(3)}) is None


def test_timed_records_seconds():
    calls = []
    with timed("block", sink=calls.append) as rec:
        torch.ones(100).sum()
    assert rec["seconds"] > 0 and rec["label"] == "block"
    assert calls and "block" in calls[0]
    with timed("quiet", sink=None) as rec:
        pass
    assert rec["seconds"] >= 0


def test_cpu_trace_writes_a_readable_chrome_trace(tmp_path):
    """A CPU trace writes one Chrome trace JSON holding the block's ops
    and not the dropped warm-up's."""
    x = torch.randn(64, 64)
    with trace(str(tmp_path), device="cpu"):
        for _ in range(3):
            torch.mm(x, x)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    assert names.count("aten::mm") == 3
    assert "aten::add_" not in names  # the warm-up step was dropped


def test_cpu_trace_of_a_training_holds_fit_fused_spans(tmp_path):
    """A ``trace`` of a short ``fit_fused`` run (the operator's
    ``RUNTIME.PROFILE_DIR`` path) writes the trainer's host phases into
    the Chrome trace JSON as ``cpu_op`` events: one ``qfa.fit_fused``,
    each epoch's four phases, the smoothing and the checkpoint once."""
    from qfa_tpu_torch.models.params import random_init

    planes = tiny()
    cfg = TrainConfig(n_epochs=2, batch_size=8, learning_rate=1e-2,
                      smooth_interval=2, save_interval=2)
    p = random_init(30, 10, 2, generator=torch.Generator().manual_seed(1))
    data = ResidualDataset(*(torch.tensor(x) for x in planes))
    with trace(str(tmp_path / "prof"), device="cpu"):
        fit_fused(p, data, np.ones(30, np.float32), cfg,
                  output_dir=str(tmp_path / "run"))
    files = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("name", "").startswith("qfa.")]
    names = [e["name"] for e in spans]
    assert names.count("qfa.fit_fused") == 1
    for phase in ("shuffle", "readback", "check", "report"):
        assert names.count(f"qfa.fit_fused.{phase}") == 2, phase
    for phase in ("smooth", "save"):
        assert names.count(f"qfa.fit_fused.{phase}") == 1, phase
    assert {e["cat"] for e in spans} == {"cpu_op"}


def write_nan_init(root, grid_npix=54, nb=25, nh=3):
    """A JAX checkpoint with a NaN in F (its mu ones) for --resume."""
    p = jax_random_init(jax.random.key(0), grid_npix, nb, nh)
    p = p._replace(F=p.F.at[0, 0].set(jnp.nan))
    path = str(root / "nan_init.npz")
    jax_save_npz(path, p, np.ones(grid_npix, np.float32))
    return path


def test_cli_profile_and_debug_nans_leave_outputs_unchanged(tmp_path):
    """``--type train --device cpu`` with ``RUNTIME.PROFILE_DIR`` and
    ``RUNTIME.DEBUG_NANS`` on finite data: the same losses and bitwise the
    same model as the run without, a trace written, and NaN debugging off
    again after the run."""
    catalog, data_dir = write_training_set(tmp_path)
    plain = cli_train(catalog, data_dir, tmp_path / "plain", 2)
    prof = tmp_path / "prof"
    run = cli_train(catalog, data_dir, tmp_path / "traced", 2,
                    "RUNTIME.PROFILE_DIR", str(prof), "RUNTIME.DEBUG_NANS",
                    "True")
    assert run["history"] == plain["history"]
    assert run["read_engine"] == plain["read_engine"] == "native"
    a, _ = load_npz(str(tmp_path / "plain" / "model_parameters.npz"))
    b, _ = load_npz(str(tmp_path / "traced" / "model_parameters.npz"))
    for k, v in a.as_dict().items():
        assert torch.equal(v, b.as_dict()[k]), k
    files = glob.glob(str(prof / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert any(e.get("name") == "aten::mm"
                   for e in json.load(f)["traceEvents"])
    assert "profiler trace written to" in \
        (tmp_path / "traced" / "log.txt").read_text()
    assert not nan_debugging()


def test_cli_nan_init_raises_as_jax_does(tmp_path):
    """A NaN in the initial parameters (``--resume``): with DEBUG_NANS
    both CLIs raise ``FloatingPointError``; without it the port trains on
    with a NaN loss, as the JAX CLI does."""
    catalog, data_dir = write_training_set(tmp_path)
    init = write_nan_init(tmp_path)
    jax_args = ["--type", "train", "--catalog", catalog, "--data_dir",
                data_dir, "--data_num", "32", "--batch_size", "12",
                "--n_epochs", "2", "--nh", "3", "--resume", init,
                "--opts", *GRID_OPTS]
    before = jax.config.jax_debug_nans
    try:
        with pytest.raises(FloatingPointError):
            jax_main(jax_args[:2] + ["--output_dir", str(tmp_path / "jax")]
                     + jax_args[2:] + ["RUNTIME.DEBUG_NANS", "True"])
    finally:  # the JAX CLI leaves jax_debug_nans on for the process
        jax.config.update("jax_debug_nans", before)
    with pytest.raises(FloatingPointError, match="params.F"):
        cli_train(catalog, data_dir, tmp_path / "port", 2,
                  "MODEL.RESUME", init, "RUNTIME.DEBUG_NANS", "True")
    assert not nan_debugging()
    run = cli_train(catalog, data_dir, tmp_path / "port2", 2,
                    "MODEL.RESUME", init)
    assert len(run["history"]) == 2 and np.isnan(run["history"]).all()


def tiny(seed=0, n=24, npix=30, nb=10):
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.normal(size=(n, npix))).astype(np.float32)
    err = rng.uniform(0.05, 0.2, (n, npix)).astype(np.float32)
    zabs = rng.uniform(2.0, 3.0, (n, nb)).astype(np.float32)
    return x, err, zabs, np.ones((n, npix), np.float32)


@pytest.mark.parametrize("trainer", ["fit", "fit_fused", "fit_streaming"])
def test_trainers_raise_on_nan_only_when_debugging(trainer):
    """Each trainer: a NaN init raises FloatingPointError naming
    params.F with NaN debugging on, and rejects the updates (loss NaN,
    no raise) with it off; finite data trains the same either way."""
    from qfa_tpu_torch.models.params import random_init

    planes = tiny()
    cfg = TrainConfig(n_epochs=2, batch_size=8, learning_rate=1e-2,
                      smooth_interval=100, save_interval=100)

    def run(nan):
        p = random_init(30, 10, 2, generator=torch.Generator().manual_seed(1))
        if nan:
            p.F.data[3, 1] = float("nan")
        mu = np.ones(30, np.float32)
        if trainer == "fit_streaming":
            return fit_streaming(p, HostResiduals(*planes), mu, cfg,
                                 device="cpu")
        data = ResidualDataset(*(torch.tensor(x) for x in planes))
        return (fit if trainer == "fit" else fit_fused)(p, data, mu, cfg)

    ref_p, ref_h = run(False)
    _, nan_h = run(True)
    assert np.isnan(nan_h).all()
    enable_nan_debugging(True)
    try:
        with pytest.raises(FloatingPointError, match="params.F"):
            run(True)
        p, h = run(False)
    finally:
        enable_nan_debugging(False)
    assert h == ref_h
    for k, v in p.as_dict().items():
        assert torch.equal(v, ref_p.as_dict()[k]), k


def test_nan_debugging_adds_nothing_when_off(monkeypatch):
    """Off, the trainers never look at their state's finiteness (no host
    sync added), and the flag toggles."""
    calls = []
    monkeypatch.setattr(profiling, "first_nonfinite",
                        lambda tree: calls.append(tree))
    profiling.raise_if_nonfinite("x", [float("nan")], params=None)
    assert calls == []
    enable_nan_debugging(True)
    assert nan_debugging()
    enable_nan_debugging(False)
    assert not nan_debugging()
    assert profiling.is_cuda("cpu") is False
