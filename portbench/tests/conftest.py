"""Fixtures of the benchmark's own tests (run on the CPU with
``python -m pytest portbench/tests -q``; the tests marked ``card`` run
the harness on a CUDA device and skip without one)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: tiny sizes of each traffic kind, so a whole run takes seconds here
TINY = {
    "train": dict(n_spectra=1100, batch_size=100),
    "predict": dict(n_spectra=1000, chunk=256, check_block=128),
}



def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the harness measures only on the card")
    return torch.device("cuda", 0)


def tiny_grid(cfg: dict) -> dict:
    wav = 10.0 ** np.arange(np.log10(1150.0), np.log10(1300.0), 1e-3)
    return dict(cfg, lam_min=1150.0, lam_max=1300.0, dloglam=1e-3,
                npix=len(wav), nb=int((wav < 1215.6701).sum()), nh=4)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark's files with every configuration on a
    71-pixel grid at nh 4 and every traffic mix cut to the CPU; returns
    the root (holding BENCHMARK.json and portbench/)."""
    here = tmp_path / "portbench"
    here.mkdir()
    for d in ("metrics", "traffic", "configs", "limits"):
        shutil.copytree(ROOT / "portbench" / d, here / d)
    for p in (here / "configs").glob("*.json"):
        p.write_text(json.dumps(tiny_grid(json.loads(p.read_text()))))
    for p in (here / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        p.write_text(json.dumps(dict(t, **TINY[t["kind"]])))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    return tmp_path
