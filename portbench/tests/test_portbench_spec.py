"""BENCHMARK.json and every file it names parse and keep the contract's
shape; a cell made of new files only is found by name."""

from __future__ import annotations

import json
import re

import pytest

from portbench import spec as spec_mod
from portbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(BENCH) == KEYS["top"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_entries_have_the_contract_keys(group):
    for e in BENCH[group]:
        extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    """Its configuration, traffic, limits and a reader for each metric it
    reports; at least one other end-to-end metric and one per-layer."""
    spec = spec_mod.Spec()
    c = spec.cell(cell)
    assert c.workload["chips"] in (1, 4)
    assert c.config["name"] == c.workload["config"]
    assert c.traffic["kind"] in ("train", "predict")
    assert c.limits, f"{cell} has no limits file"
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    for m in c.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_state_their_widths(cfg):
    from portbench import gen

    f = json.loads((ROOT / cfg["file"]).read_text())
    assert f["name"] == cfg["name"] and f["reduced"] == cfg["reduced"]
    grid = gen.make_grid(f)
    assert (grid.npix, grid.nb) == (f["npix"], f["nb"])
    assert set(f["precision"]) >= {"train_products", "predict_products"}


def test_a_cell_of_new_files_only_is_found(tiny_root):
    """A later PR adds a mix, a limits file, a metric reader and the
    entries; no file of the harness changes."""
    here = tiny_root / "portbench"
    mix = json.loads((here / "traffic" / "predict_sweep.json").read_text())
    (here / "traffic" / "predict_stats_only.json").write_text(
        json.dumps(dict(mix, stats_only=True)))
    (here / "limits" / "sdss-ood.json").write_text(
        (here / "limits" / "desi-predict.json").read_text())
    (here / "metrics" / "ood.sweeps.py").write_text(
        "def read(ctx):\n    return ctx.stats.get('sweeps')\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "sdss-ood", "config": "qfa-sdss",
                               "traffic": "predict_stats_only", "chips": 1,
                               "why": "a test cell"})
    next(m for m in bench["end_to_end"] if m["name"] ==
         "predict_spectra_per_s")["workloads"].append("sdss-ood")
    bench["per_layer"].append({"name": "ood.sweeps", "unit": "sweeps",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves":
                               "predict_spectra_per_s",
                               "workloads": ["sdss-ood"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = spec_mod.Spec(tiny_root, here)
    c = spec.cell("sdss-ood")
    assert c.traffic["stats_only"] is True
    assert [m["name"] for m in c.per_layer] == ["ood.sweeps"]
    assert spec.reader("ood.sweeps")(type("C", (), {"stats": {"sweeps": 3}})) \
        == 3
    from portbench import run

    import torch

    line = run.run_cell(spec, "sdss-ood", 7, 0.2, False, torch.device("cpu"))
    assert line["metrics"]["predict_spectra_per_s"]["value"] > 0
