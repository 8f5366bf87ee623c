"""What the card runs imports no JAX and no JAX package; the reference
imports nothing of the program either. Top-level names are compared
whole: ``qfa_tpu_torch`` begins with ``qfa_tpu`` and is allowed."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import spec as spec_mod
from portbench.tests.conftest import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(imports: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT), imports=imports)],
        capture_output=True, text=True, timeout=300, check=True,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_forbidden_names_compare_whole():
    assert spec_mod.forbidden_modules(["qfa_tpu_torch.ops", "torch"]) == []
    assert spec_mod.forbidden_modules(["qfa_tpu.models", "jax._src.x",
                                       "flaxx"]) == ["jax", "qfa_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    mods = loaded("import portbench.reference.model, "
                  "portbench.reference.compare")
    assert not mods & (spec_mod.FORBIDDEN | {"qfa_tpu_torch"})


@pytest.mark.parametrize("kind", ["train", "predict"])
def test_the_harness_and_the_port_import_no_jax(kind):
    mods = loaded(
        "import portbench.run, portbench.drivers." + kind + "\n"
        "import qfa_tpu_torch.cli, qfa_tpu_torch.serve, "
        "qfa_tpu_torch.train.fused_engine, qfa_tpu_torch.ops.infer_kernel")
    assert "qfa_tpu_torch" in mods
    assert not mods & spec_mod.FORBIDDEN


def test_a_tiny_run_loads_no_jax(tiny_root):
    code = (
        "import torch\n"
        "from portbench import run, spec\n"
        "from pathlib import Path\n"
        f"root = Path({str(tiny_root)!r})\n"
        "line = run.run_cell(spec.Spec(root, root / 'portbench'), "
        "'desi-predict', 3, 0.2, False, torch.device('cpu'))\n"
        "assert line is not None\n")
    mods = loaded(code)
    assert not mods & spec_mod.FORBIDDEN


def test_no_harness_source_names_jax():
    for p in (ROOT / "portbench").rglob("*.py"):
        if p.parent.name == "tests":
            continue
        text = p.read_text()
        assert "import jax" not in text and "from jax" not in text, p
        assert "import qfa_tpu\n" not in text and "from qfa_tpu " not in text
        assert "from qfa_tpu." not in text and "import qfa_tpu." not in text
