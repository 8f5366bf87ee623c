"""Guards of the port that hold on any machine: it never imports JAX or
the JAX package; a request for the GPU on a machine without one raises
instead of running on the CPU; the kernel build fails loudly; the tau-law
table still refuses callables; CPU calls never count as kernel launches."""

import ast
import os
import stat
import subprocess
import sys
import textwrap

import pytest
import torch

from qfa_tpu.ops.fused_step import TAU_LAW_ABC as JAX_TAU_LAW_ABC
from qfa_tpu_torch.cli import main as port_main
from qfa_tpu_torch.models.params import random_init
from qfa_tpu_torch.ops import _build, common
from qfa_tpu_torch.ops import infer_kernel
from qfa_tpu_torch.serve import QFAPredictor

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
    assert int(count) >= 20  # every module of the slice was imported


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


def test_cli_train_is_not_ported():
    with pytest.raises(NotImplementedError, match="A6"):
        port_main(["--type", "train"])


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
