"""Readings for a cell's limits, in one process: the numbers compared on
each seed (the program's own run, with a short window), then each control
on the first few seeds, computed in the program's place. One JSON line
per reading goes to ``--out``.

    python3 portbench/tools/readings.py --workload sdss-train \\
        --seeds 11,12,13 --controls fp8,half_batch --control-seeds 3 \\
        --seconds 1 --out chiprun_out/readings.jsonl
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import run  # noqa: E402  (sets the caches' directories)
from portbench import spec as spec_mod  # noqa: E402
from portbench.drivers import driver  # noqa: E402

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    cell = spec_mod.Spec().cell(args.workload)
    device = torch.device("cuda", 0)
    if torch.cuda.is_available():
        torch.cuda.set_device(device)
    else:  # a rehearsal at a tiny size
        device = torch.device("cpu")
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    controls = [c for c in args.controls.split(",") if c]
    with open(args.out, "a") as out:
        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            with tempfile.TemporaryDirectory(prefix="portbench-") as work:
                drv = driver(cell.traffic["kind"])(
                    cell.workload, cell.config, cell.traffic, seed, work,
                    device)
                drv.setup()
                drv.window(args.seconds, lambda name: contextlib.nullcontext())
                drv.release()
                for control in [None] + (controls
                                         if i < args.control_seeds else []):
                    t0 = time.perf_counter()
                    numbers = drv.check(control)
                    line = dict(workload=args.workload, seed=seed,
                                control=control, numbers=numbers,
                                check_s=time.perf_counter() - t0,
                                detail=getattr(drv, "detail", None))
                    out.write(json.dumps(line, default=repr) + "\n")
                    out.flush()
                    run.say(f"readings: {seed} {control} {numbers}")
            del drv
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
