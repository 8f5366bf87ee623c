"""The last line of a run has exactly the contract's keys, with the
numbers compared last; the run exits non-zero, printing nothing, without
a card or without the program."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import torch

from portbench import run, spec as spec_mod
from portbench.tests.conftest import ROOT


def test_line_keys(tiny_root):
    spec = spec_mod.Spec(tiny_root, tiny_root / "portbench")
    line = run.run_cell(spec, "desi-predict", 5, 0.3, False,
                        torch.device("cpu"))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"predict_spectra_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    assert line["attempted"] % 1000 == 0 and line["failed"] == 0
    json.dumps(line)


def test_no_card_no_result():
    if torch.cuda.is_available():
        return  # the card's machine: the refusal is for machines without
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench/run.py"), "--workload",
         "sdss-train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ gives no
    result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "sdss-train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
