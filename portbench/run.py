"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Builds the cell named in ``BENCHMARK.json`` from its files, warms it up
(counted as set-up), measures for ``--seconds``, then judges what the
window produced against the plain reference, and prints one JSON line:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics read
from a ``torch.profiler`` trace of the window and the benchmark's own
spans), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit (also the last lines
of standard error). Exits non-zero, printing no result, without enough
CUDA devices, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# caches at fixed paths inside the checkout; no library may load JAX
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".portbench_cache" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

import torch  # noqa: E402

from portbench import spec as spec_mod  # noqa: E402
from portbench.drivers import driver  # noqa: E402
from portbench.reference.compare import judge  # noqa: E402
from portbench.trace import Tracer, span  # noqa: E402


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def describe(stats: dict) -> str:
    """The window's own timings in a line: per-epoch seconds."""
    import numpy as np

    out = {}
    if "epoch_s" in stats:
        e = np.asarray(stats["epoch_s"])
        out.update(epochs=len(e), epoch_ms_median=1e3 * float(np.median(e)),
                   epoch_ms_p90=1e3 * float(np.percentile(e, 90)),
                   epoch_ms_max=1e3 * float(e.max()),
                   outside_epochs_s=stats["window_s"] - float(e.sum()))
    return repr(out)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(spec, workload: str, seed: int, seconds: float, trace: bool,
             device, control: str | None = None, t_start: float = T_START
             ) -> dict | None:
    """Set up, measure and judge one run of a cell on ``device``; returns
    the result line, or None when a forbidden module was loaded."""
    cell = spec.cell(workload)
    chips = int(cell.workload["chips"])
    seed = seed % 2**63
    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        drv = driver(cell.traffic["kind"])(cell.workload, cell.config,
                                           cell.traffic, seed, work, device)
        drv.setup()
        setup_s = time.perf_counter() - t_start
        summary = None
        # the collector is off in the window: its full passes stalled a
        # loop of small calls for up to 40 ms (idle gaps of a traced
        # window)
        gc.collect()
        gc.disable()
        try:
            if trace:
                with Tracer() as tracer:
                    stats = drv.window(seconds, span)
                summary = tracer.summary
            else:
                stats = drv.window(seconds,
                                   lambda name: contextlib.nullcontext())
        finally:
            gc.enable()
        gpu = device.type == "cuda"
        if gpu:
            torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) if gpu else 0
        drv.release()
        t_check = time.perf_counter()
        numbers = drv.check(control)
        say(f"portbench: set-up {setup_s:.3f} s, window {stats['window_s']:.3f}"
            f" s, check {time.perf_counter() - t_check:.3f} s")
        if getattr(drv, "detail", None):
            say(f"portbench: check detail {drv.detail!r}")
        say(f"portbench: window {describe(stats)}")

    found = spec_mod.forbidden_modules(sys.modules)
    if found:
        say(f"portbench: the process loaded {found}; no result")
        return None
    card = power_limit() if gpu else "cpu"
    ctx = SimpleNamespace(cell=cell, stats=stats, trace=summary, chips=chips,
                          setup_s=setup_s, card=card, say=say)
    metrics = spec_mod.read_metrics(
        spec, cell.per_layer if trace else cell.end_to_end, ctx)
    dev = {"platform": "gpu" if gpu else "cpu",
           "kind": torch.cuda.get_device_name(device) if gpu else "cpu",
           "count": chips, "memory_peak_bytes": int(peak), "card": card}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    correct, checks = judge(numbers, cell.limits)
    if control:
        say(f"portbench: control {control}: the reference computed so, in "
            "the program's place")
    for k, v in checks.items():
        say(f"check {k} = {v['value']!r} limit {v['limit']!r}")
    return spec_mod.result_line(
        correct, stats, metrics, dev, checks,
        summary.breakdown() if summary is not None else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # readings for the limits: the reference in a lower precision, or a
    # planted fault, compared in the program's place
    ap.add_argument("--control", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    spec = spec_mod.Spec()
    chips = int(spec.cell(args.workload).workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"portbench: {args.workload} needs {chips} CUDA device(s); "
            f"torch sees {torch.cuda.device_count()}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(2)  # one process with few threads: steadier host
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = run_cell(spec, args.workload, args.seed, args.seconds,
                    bool(args.trace), device, args.control)
    if line is None:
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
