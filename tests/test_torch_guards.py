"""Guards of the port that hold on any machine: it never imports JAX or
the JAX package; a request for the GPU on a machine without one raises
instead of running on the CPU; the kernel build fails loudly; the tau-law
table still refuses callables; CPU calls never count as kernel launches;
the modes that are not ported yet raise naming their ROADMAP item. And
the CLI's training run on the CPU, end to end."""

import ast
import os
import re
import stat
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from qfa_tpu.models import load_npz as jax_load_npz
from qfa_tpu.ops.fused_step import TAU_LAW_ABC as JAX_TAU_LAW_ABC
from qfa_tpu_torch.cli import main as port_main
from qfa_tpu_torch.data.loader import ResidualDataset
from qfa_tpu_torch.models.params import random_init
from qfa_tpu_torch.data.batch import SpectraBatch
from qfa_tpu_torch.data.streaming import HostResiduals, stream_batches
from qfa_tpu_torch.ops import _build, common, epoch_kernel, fused_step
from qfa_tpu_torch.ops import infer_kernel
from qfa_tpu_torch.parallel import DataMesh, tp
from qfa_tpu_torch.serve import QFAPredictor
from qfa_tpu_torch.train import (
    TrainConfig,
    TrainState,
    adam,
    fit,
    fit_fused,
    fit_streaming,
    make_fused_step_fn,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_qfa_tpu():
    """Import every module of the package in a fresh interpreter."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import qfa_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            qfa_tpu_torch.__path__, "qfa_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = [k for k in sys.modules
               if k.split(".")[0] in ("jax", "jaxlib", "qfa_tpu")]
        print(len(names), bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    assert bad.strip() == "[]"
    # every module of the slices was imported (42 since the calibration
    # and probe modules of the measurement path)
    assert int(count) >= 42


def test_chip_smoke_imports_no_jax():
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "qfa_tpu_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "qfa_tpu"}


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-GPU guard cannot show")


def test_cli_device_cuda_raises_without_gpu(no_gpu, tmp_path):
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["--type", "predict", "--catalog", "none.csv",
                   "--output_dir", str(out), "--device", "cuda"])
    assert not out.exists()  # failed before touching the run directory


def test_cli_device_defaults_to_cuda(no_gpu, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["--type", "predict", "--output_dir", str(tmp_path / "o")])


def test_predictor_device_cuda_raises_without_gpu(no_gpu, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QFAPredictor(str(tmp_path / "missing.npz"), device="cuda")


def write_training_set(root, n=40, seed=0):
    """n spectra on the 54-pixel grid of ``GRID_OPTS`` (a few -999
    sentinels each) and a ``file,snr,z,num_mask`` catalog; returns the
    catalog path and the data directory."""
    rng = np.random.default_rng(seed)
    data_dir = root / "spectra"
    data_dir.mkdir()
    lines = ["file,snr,z,num_mask"]
    for i in range(n):
        flux = (1.0 + 0.1 * rng.normal(size=54)).astype(np.float32)
        error = rng.uniform(0.05, 0.15, 54).astype(np.float32)
        flux[rng.integers(0, 54, 3)] = -999.0
        z = rng.uniform(2.0, 3.5)
        np.savez(data_dir / f"s{i:03d}.npz", flux=flux, error=error, z=z)
        lines.append(f"s{i:03d}.npz,10.0,{z:.4f},0")
    (root / "train.csv").write_text("\n".join(lines) + "\n")
    return str(root / "train.csv"), str(data_dir)


GRID_OPTS = ["DATA.LAMMIN", "1150.0", "DATA.LAMMAX", "1300.0",
             "DATA.LOGLAM_DELTA", "0.001"]


def cli_train(catalog, data_dir, out, epochs, *opts):
    return port_main([
        "--type", "train", "--catalog", catalog, "--data_dir", data_dir,
        "--output_dir", str(out), "--data_num", "32", "--batch_size", "12",
        "--n_epochs", str(epochs), "--nh", "3", "--device", "cpu", "--opts",
        "TRAIN.SMOOTH_INTERVAL", "2", "TRAIN.SAVE_INTERVAL", "2", *GRID_OPTS,
        *opts])


def test_cli_train_writes_run_and_resumes(tmp_path):
    """--type train --device cpu runs train.fit, as the JAX CLI does
    without an accelerator, and writes the run directory; the model npz
    loads in the JAX package; a second run with more epochs auto-resumes
    from the newest full state."""
    catalog, data_dir = write_training_set(tmp_path)
    out = tmp_path / "run"

    def train(epochs):
        return cli_train(catalog, data_dir, out, epochs)

    first = train(4)
    assert first["engine"] == "fit" and first["n"] == 32
    assert len(first["history"]) == 4 and np.isfinite(first["history"]).all()
    names = set(os.listdir(out))
    assert {"config.yaml", "log.txt", "metrics.jsonl", "model_parameters.npz",
            "train-catalog.csv", "checkpoints"} <= names
    assert sorted(os.listdir(out / "checkpoints")) == [
        "model_parameters_epoch_02.npz", "model_parameters_epoch_04.npz",
        "state_epoch_02.npz", "state_epoch_04.npz"]
    metrics = (out / "metrics.jsonl").read_text().splitlines()
    assert len(metrics) == 4 and '"loss"' in metrics[0]
    params, mu = jax_load_npz(str(out / "model_parameters.npz"))
    assert params.F.shape == (54, 3) and params.omega.shape == (25,)
    assert mu.shape == (54,) and np.isfinite(np.asarray(params.F)).all()
    log = (out / "log.txt").read_text()
    assert "trainer engine: XLA trainer (train.fit" in log
    # the derived layout belongs to the fused engine only
    assert "derived mask + zq-column redshifts" not in log

    second = train(6)
    assert len(second["history"]) == 2
    log = (out / "log.txt").read_text()
    assert "auto-resumed full training state" in log and "(epoch 4)" in log


@pytest.mark.parametrize("engine", ["auto", "pallas", "xla"])
def test_cli_train_off_the_card_runs_fit_not_fit_fused(tmp_path, monkeypatch,
                                                       engine):
    """Every engine on --device cpu goes to train.fit with the JAX CLI's
    arguments; fit_fused is never called."""
    import qfa_tpu_torch.train as train_pkg

    calls = []
    real_fit = train_pkg.fit

    def spy(*args, **kw):
        calls.append(kw)
        return real_fit(*args, **kw)

    def no_fused(*args, **kw):
        raise AssertionError("fit_fused called")

    monkeypatch.setattr(train_pkg, "fit", spy)
    monkeypatch.setattr(train_pkg, "fit_fused", no_fused)
    catalog, data_dir = write_training_set(tmp_path)
    out = tmp_path / "run"
    run = cli_train(catalog, data_dir, out, 2, "TRAIN.ENGINE", engine,
                    "SEED", "5")
    assert run["engine"] == "fit" and len(run["history"]) == 2
    assert len(calls) == 1
    kw = calls[0]
    assert kw["seed"] == 5 and kw["output_dir"] == str(out)
    assert kw["initial_state"] is None and callable(kw["metrics_cb"])
    assert {"val_data", "logger"} <= set(kw)
    log = (out / "log.txt").read_text()
    assert ("requested but cpu is no CUDA device" in log) == \
        (engine == "pallas")


def test_cli_train_device_cuda_raises_without_gpu(no_gpu, tmp_path):
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["--type", "train", "--catalog", "none.csv",
                   "--output_dir", str(out), "--device", "cuda"])
    assert not out.exists()  # failed before touching the run directory


def test_modes_not_ported_raise_naming_roadmap(tmp_path):
    """The sharded streaming trainer and the 2-D data x pixel mesh raise
    naming A10; the window mode of the epoch kernel is ported, and its own
    argument checks raise ValueError; the profiler option is ported: the
    CLI's training run with it runs and writes its trace."""
    params = random_init(30, 10, 2, generator=torch.Generator().manual_seed(0))
    st = adam.init(params)
    x = torch.full((8, 30), 0.1)
    _, host = _tiny_stream()
    with pytest.raises(NotImplementedError, match="A10"):
        fit_streaming(params, host, np.ones(30), TrainConfig(n_epochs=1),
                      sharding=object(), device="cpu")
    for fn in (tp.make_mesh_2d, tp.shard_params_2d, tp.shard_batch_2d,
               tp.make_tp_step_fn):
        with pytest.raises(NotImplementedError, match="A10"):
            fn()
    args = (params, st.m, st.v, x, x, x[:, :10], torch.arange(2))
    with pytest.raises(ValueError, match="single-epoch"):
        epoch_kernel.fused_train_epoch(*args, epoch=0, n_batches=1,
                                       n_epochs=2, tile_batch=4,
                                       sync_grads=True)
    pend = torch.zeros(epoch_kernel.pending_len(30, 2))
    with pytest.raises(ValueError, match="apply_pending"):
        epoch_kernel.fused_train_epoch(*args, epoch=0, n_batches=1,
                                       tile_batch=4, sync_grads=True,
                                       pending=pend)
    catalog, data_dir = write_training_set(tmp_path)
    run = cli_train(catalog, data_dir, tmp_path / "o", 1,
                    "RUNTIME.PROFILE_DIR", str(tmp_path / "prof"))
    assert run["engine"] == "fit" and len(run["history"]) == 1
    assert len(os.listdir(tmp_path / "prof")) == 1
    assert epoch_kernel.LAUNCHES == 0


def test_tau_law_abc_rejects_callables_and_matches_jax():
    assert common.TAU_LAW_ABC == JAX_TAU_LAW_ABC
    with pytest.raises(ValueError, match="named"):
        common.tau_law_abc(lambda z: z)
    with pytest.raises(NotImplementedError, match="unknown"):
        common.tau_law_abc("nope")


def test_cpu_calls_are_not_launches_and_other_devices_raise():
    params = random_init(30, 10, 2, generator=torch.Generator().manual_seed(0))
    mu = torch.ones(30)
    x = torch.full((3, 30), 0.1)
    before = infer_kernel.LAUNCHES
    out = infer_kernel.fused_predict(params, mu, x, x, x[:, :10], None)
    assert out.ll.shape == (3,) and infer_kernel.LAUNCHES == before
    meta = torch.empty((3, 30), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        infer_kernel.fused_predict(params, mu, meta, meta, meta[:, :10], None)


def _fake_nvcc(tmp_path, body):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n{body}\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return home


@pytest.fixture
def build_env(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "_build")
    return tmp_path


def test_build_failure_raises_with_compiler_output(build_env, monkeypatch):
    home = _fake_nvcc(build_env, "print('k.cu(1): error: boom'); sys.exit(2)")
    monkeypatch.setenv("CUDA_HOME", str(home))
    with pytest.raises(RuntimeError, match="boom"):
        _build.build_library()
    leftovers = list((build_env / "_build").rglob("*.so"))
    assert leftovers == []  # no half library left behind


def test_build_writes_library_once_per_source_hash(build_env, monkeypatch):
    body = textwrap.dedent("""
        out = sys.argv[sys.argv.index("-o") + 1]
        open(out, "w").write(" ".join(sys.argv[1:]))
        print("ptxas info    : Used 40 registers")
    """)
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(build_env, body)))
    lib = _build.build_library()
    args = lib.read_text()
    assert "arch=compute_90a,code=sm_90a" in args
    assert "fast_math" not in args and "k.cu" in args
    assert "registers" in _build.build_log()
    assert _build.build_library() == lib  # cached by content
    (build_env / "csrc" / "k.cu").write_text("// changed\n")
    assert _build.build_library() != lib  # a new source, a new build


def _tiny_stream():
    params = random_init(30, 10, 2, generator=torch.Generator().manual_seed(0))
    x = np.full((8, 30), 0.1, np.float32)
    host = HostResiduals(delta=x, error=x, zabs=x[:, :10].copy(),
                         mask=np.ones_like(x))
    return params, host


def test_streaming_defaults_to_cuda(no_gpu):
    """fit_streaming and stream_batches ask for the GPU by default and
    raise at the call where there is none."""
    params, host = _tiny_stream()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_batches(host, 4, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_streaming(params, host, np.ones(30), TrainConfig(n_epochs=1,
                                                             batch_size=4))


def test_step_kernel_cpu_calls_are_not_launches():
    """The step kernel's wrapper and the fused step function on CPU
    tensors take the plain version and count no launch; other devices
    raise; the streaming trainer's sharding raises naming A10."""
    params, host = _tiny_stream()
    x = torch.full((3, 30), 0.1)
    batch = SpectraBatch(delta=x, error=x, zabs=x[:, :10],
                         mask=torch.ones_like(x), weight=torch.ones(3))
    out = fused_step.fused_loss_grads(params, batch)
    assert out.grads.F.shape == (30, 2) and fused_step.LAUNCHES == 0
    st, loss = make_fused_step_fn(TrainConfig())(
        TrainState(params, adam.init(params)), batch)
    assert torch.isfinite(loss) and fused_step.LAUNCHES == 0
    meta = torch.empty((3, 30), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_step.fused_loss_grads(params, batch._replace(delta=meta))
    with pytest.raises(NotImplementedError, match="A10"):
        fit_streaming(params, host, np.ones(30), TrainConfig(n_epochs=1),
                      sharding=object(), device="cpu")
    # fit(mesh=) is ported: a batch that does not split over the ranks
    # raises before any collective
    data = ResidualDataset(delta=x, error=x, zabs=x[:, :10], mask=None)
    mesh = DataMesh(rank=0, size=3, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        fit(params, data, np.ones(30), TrainConfig(n_epochs=1, batch_size=4),
            mesh=mesh)


def test_step_kernel_source_and_signature():
    assert (_build.CSRC / "step.cu").is_file()
    argtypes, restype = _build.SIGNATURES["qfa_step_f32"]
    assert len(argtypes) == 27 and restype is not None
    src = (_build.CSRC / "step.cu").read_text()
    assert "int qfa_step_f32(" in src and '#include "smallchol.cuh"' in src
    assert "atomicAdd" not in src  # deterministic: fixed-order sums only
    # the one atomic of the shared header: the integer arrival counter
    # that finds a launch's last block (no float atomics)
    assert '#include "train_core.cuh"' in src
    core = (_build.CSRC / "train_core.cuh").read_text()
    assert re.findall(r"atomicAdd\((\w+)", core) == ["counter"]
    assert "bool last_to_arrive(int* counter," in core


def test_no_source_cites_b1b_for_the_epoch_kernel():
    """B1b is the prediction kernel's bf16 mode; the epoch kernel's is
    B2b. Only the prediction kernel's wrapper may cite B1b."""
    pkg = os.path.join(REPO, "qfa_tpu_torch")
    citing = set()
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, name)
                if "B1b" in open(path).read():
                    citing.add(os.path.relpath(path, pkg))
    assert citing <= {os.path.join("ops", "infer_kernel.py")}, citing


def test_epoch_kernel_has_no_float_atomics():
    """Every sum of csrc/epoch.cu has a fixed order; its only atomics
    count arrivals on int counters (in the header it shares with
    step.cu)."""
    src = (_build.CSRC / "epoch.cu").read_text()
    assert '#include "train_core.cuh"' in src
    src += (_build.CSRC / "train_core.cuh").read_text()
    assert "int* counters;" in src
    calls = re.findall(r"atomic\w+\(([^,]+),", src)
    assert calls and all("counter" in arg for arg in calls), calls
    assert "atomicAdd(a." not in src and "float* counter" not in src


def test_predict_kernel_has_no_float_atomics():
    """Every sum of csrc/predict.cu has a fixed order (per-lane pixel
    sums, then one xor butterfly), so a row's outputs never depend on
    its neighbours or the run."""
    src = (_build.CSRC / "predict.cu").read_text()
    assert "__shfl_xor_sync" in src
    assert not re.findall(r"atomic\w*\(", src)


def test_epoch_kernel_wrapper_takes_bf16_planes():
    """The CUDA wrapper's checks (device-independent): delta and error
    both float32 or both bfloat16; everything else float32."""
    x = torch.zeros((4, 6))
    f32 = {"delta": x, "error": x, "zabs": x, "mask": None, "F": x}
    bf = dict(f32, delta=x.bfloat16(), error=x.bfloat16())
    cpu = torch.device("cpu")
    assert epoch_kernel._check_kernel_tensors(f32, cpu) is False
    assert epoch_kernel._check_kernel_tensors(bf, cpu) is True
    with pytest.raises(TypeError, match="share a dtype"):
        epoch_kernel._check_kernel_tensors(dict(f32, delta=x.bfloat16()),
                                           cpu)
    with pytest.raises(TypeError, match="F must be"):
        epoch_kernel._check_kernel_tensors(dict(bf, F=x.bfloat16()), cpu)
    with pytest.raises(TypeError, match="delta must be"):
        epoch_kernel._check_kernel_tensors(
            dict(f32, delta=x.half(), error=x.half()), cpu)


@pytest.mark.parametrize("fn", ["qfa_train_epoch", "qfa_step_f32",
                                "qfa_predict_f32", "qfa_predict_occupancy",
                                "qfa_kdepth_f32", "qfa_kdepth_chunks"])
def test_ctypes_signature_matches_the_c_entry_point(fn):
    """Each C entry point takes as many parameters as its ctypes
    signature lists (a missing one shifts every later pointer)."""
    src = "".join((_build.CSRC / s).read_text()
                  for s in ("epoch.cu", "step.cu", "predict.cu",
                            "kdepth.cu"))
    params = re.search(rf"\bint {fn}\(([^)]*)\)", src)[1]
    argtypes, _ = _build.SIGNATURES[fn]
    assert len(argtypes) == len(params.split(","))
