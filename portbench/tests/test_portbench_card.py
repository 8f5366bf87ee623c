"""On the card: each cell at its own size, a short window, the numbers
compared against the committed limits (``python -m pytest portbench/tests
-m card`` on a machine with an H100; skipped without a CUDA device)."""

from __future__ import annotations

import json

import pytest

from portbench import run, spec as spec_mod
from portbench.tests.conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    line = run.run_cell(spec_mod.Spec(), cell, 2**31 + 5, 2.0, False, card)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
