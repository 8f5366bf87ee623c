"""Everything the harness finds by name: the cell in ``BENCHMARK.json``,
its configuration file, its traffic file, its limits file and the reader
of each metric. A later cell, mix or metric is new files and entries;
nothing here changes for it.

    configs: the entry's ``file``
    traffic: portbench/traffic/<traffic>.json ("kind" picks the driver)
    limits:  portbench/limits/<workload>.json
    metrics: portbench/metrics/<metric>.py, ``read(ctx) -> float | None``
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names the measured process may never hold
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "qfa_tpu"})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    def __init__(self, root: Path = ROOT, here: Path = HERE):
        self.root, self.here = Path(root), Path(here)
        self.bench = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> SimpleNamespace:
        """The workload ``name`` with its configuration, traffic, limits
        and the metrics it reports in each kind of run."""
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
        w = cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        entry = configs[w["config"]]
        limits = self.here / "limits" / f"{name}.json"
        return SimpleNamespace(
            workload=w, entry=entry,
            config=load_json(self.root / entry["file"]),
            traffic=load_json(self.here / "traffic" / f"{w['traffic']}.json"),
            limits=load_json(limits) if limits.exists() else {},
            end_to_end=self._metrics("end_to_end", name),
            per_layer=self._metrics("per_layer", name))

    def _metrics(self, group: str, cell: str) -> list:
        return [m for m in self.bench[group]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.here / "metrics" / f"{metric}.py"
        mod_spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.read


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in modules} & FORBIDDEN)


def read_metrics(spec: Spec, metrics: list, ctx) -> dict:
    """Each metric a reader finds something for, with its unit; a reader
    that finds nothing returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(correct: bool, stats: dict, metrics: dict, device: dict,
                checks: dict, breakdown: dict | None = None) -> dict:
    """The last line of a run: the contract's keys, the numbers compared
    last."""
    out = {"correct": bool(correct), "attempted": int(stats["attempted"]),
           "failed": int(stats["failed"]), "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
