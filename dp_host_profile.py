#!/usr/bin/env python3
"""Where the host time of an exact-DP epoch goes, on one NVIDIA GPU.

    python3 dp_host_profile.py [--k 1] [--n 65536] [--eager]

Beside ``chip_smoke.py``: one epoch of ``parallel.sync_dp`` at world size
1 over NCCL (SDSS width, batch 500, bf16 operands, derived layout, the
phase 17 problem) issued under ``cProfile``: on its CUDA graph, one replay
after the eager epoch and the capture (``--eager``: the windows issued one
by one from Python); prints the host seconds, the functions by own and by
cumulative time, and, alone
(100 calls each, host clock, no sync inside), the host time of an
``all_reduce`` of the window's vector, of the ``cat`` that builds it and
of one ``QFAParams`` module built both ways, and, on the graph, of each
step of its epoch (the permutation's check and copy, the schedule row,
the state's load, the replay, the state's copy, the loss rows' gather).
Imports nothing of JAX.
"""

import argparse
import cProfile
import io
import pstats
import sys
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=1, help="batches per window")
    ap.add_argument("--n", type=int, default=65536, help="spectra")
    ap.add_argument("--eager", action="store_true",
                    help="the eager window loop instead of the CUDA graph")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dp_host_profile: needs a CUDA device", file=sys.stderr)
        return 1
    import torch.distributed as dist

    import chip_smoke as cs
    from qfa_tpu_torch.calibrate import card_info
    from qfa_tpu_torch.data.loader import ResidualDataset
    from qfa_tpu_torch.models.params import QFAParams
    from qfa_tpu_torch.ops.epoch_kernel import pending_len
    from qfa_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        make_sync_dp_epoch_fn,
    )
    from qfa_tpu_torch.train import TrainConfig, TrainState, pick_tiling

    dev = torch.device("cuda")
    initialize_distributed(
        backend="nccl", init_method=f"tcp://127.0.0.1:{cs.free_port()}",
        rank=0, world_size=1)
    mesh = make_mesh(1, device=dev, backend="nccl")
    batch = 500
    n_batches = -(-args.n // batch)
    tb = pick_tiling(batch)[0]
    grid, params, st, data = cs.window_problem(cs.SDSS, args.n, dev,
                                               cs.SEED + 71)
    data = cs.pad_rows(data, n_batches * batch - args.n)
    zq, _, kw = cs.layout(grid, data, "derived")
    perm = torch.randperm(n_batches * batch // tb)
    shard = ResidualDataset(delta=data["delta"], error=data["error"],
                            zabs=zq, mask=None)
    fn = make_sync_dp_epoch_fn(
        TrainConfig(batch_size=batch, mxu_bf16=True), mesh,
        batches_per_launch=args.k, tile_batch=tb, batch_rows=batch,
        loglam=kw["loglam"], n_real=args.n,
        engine="eager" if args.eager else None)
    state = TrainState(params, st)
    for _ in range(2):  # the graph: an eager epoch, then the capture
        fn(state, shard, perm)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn(state, shard, perm)
    prof.disable()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    calls = -(-n_batches // args.k) + 1
    print(card_info()["nvidia_smi"])
    how = "one graph replay of" if fn.engine == "graph" else "issued"
    print(f"sync_dp K={args.k} ({fn.engine} engine), {args.n} spectra: host "
          f"{host * 1e3:.3f} ms to issue the epoch under cProfile ({how} "
          f"{calls} window calls), {host * 1e3 / calls:.4f} ms per call")
    for key in ("tottime", "cumtime"):
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats(key).print_stats(25)
        print(out.getvalue())

    def host_us(f, reps=100):
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return us

    vec = torch.zeros(pending_len(grid.npix, cs.NH) + 2 * args.k, device=dev)
    part = torch.zeros(pending_len(grid.npix, cs.NH), device=dev)
    leaves = [getattr(params, k).detach() for k in
              ("F", "Psi", "omega", "tau0", "c0", "beta")]
    alone = {
        "all_reduce": lambda: dist.all_reduce(vec),
        "cat": lambda: torch.cat([part, vec[:1], vec[:1]]),
        "QFAParams(...)": lambda: QFAParams(*leaves),
        "QFAParams.wrap(...)": lambda: QFAParams.wrap(*leaves),
    }
    if fn.engine == "graph":
        from qfa_tpu_torch.parallel._common import tile_perm

        w = fn.windows
        run = w.run
        n_tiles = perm.numel()
        alone.update({
            "tile_perm": lambda: tile_perm(perm, (n_tiles,), n_tiles),
            "set_perm": lambda: run.set_perm(perm),
            "set_epoch": lambda: run.set_epoch(0),
            "load": lambda: run.load(params, st.m, st.v),
            "replay": run.replay,
            "snapshot": run.snapshot,
            "take": lambda: torch.take(w.buf, w.books),
        })
    print("alone, host us per call: " + ", ".join(
        f"{k} {host_us(f):.2f}" for k, f in alone.items()))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
