"""The readings tool at a tiny size on the CPU: one line per reading,
the program's numbers within the committed limits and the control's
beyond one of them."""

from __future__ import annotations

import json

from portbench import spec as spec_mod
from portbench.tools import readings


def test_readings_of_the_program_and_a_control(tiny_root, tmp_path,
                                               monkeypatch):
    real = spec_mod.Spec
    monkeypatch.setattr(spec_mod, "Spec",
                        lambda: real(tiny_root, tiny_root / "portbench"))
    out = tmp_path / "readings.jsonl"
    assert readings.main(["--workload", "sdss-train", "--seeds", "7,8",
                          "--controls", "fp8", "--control-seeds", "1",
                          "--seconds", "0.2", "--out", str(out)]) == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [(x["seed"], x["control"]) for x in lines] == [
        (7, None), (7, "fp8"), (8, None)]
    limits = real(tiny_root, tiny_root / "portbench").cell(
        "sdss-train").limits
    for x in lines:
        over = [k for k, v in x["numbers"].items() if v > limits[k]]
        assert bool(over) == (x["control"] is not None), x["numbers"]
