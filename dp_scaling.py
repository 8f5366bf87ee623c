#!/usr/bin/env python3
"""The data-parallel trainers across the cards of one host.

    python3 dp_scaling.py [--ranks N] [--n 65536] [--batch 500]
                          [--reps 3] [--device cuda|cpu]

Beside ``chip_smoke.py``. Starts N processes (default: one per visible
card) as ``torchrun`` would (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``); each rank trains on ``cuda:LOCAL_RANK``
over NCCL (``--device cpu``: the plain versions over gloo, for a
rehearsal). On the seeded SDSS problem of ``chip_smoke.py`` (n spectra,
the given global batch, bf16 operands, derived layout) every rank times
one epoch of ``sync_dp`` at K 1 and 16 (on NCCL its CUDA graph, one replay
per epoch; K 1 also on its eager window loop) and of ``epoch_dp`` on its
rows (host clock around the epoch and a synchronize, median of reps after
two warm-ups: an eager epoch and the graph's capture), and rank 0 times
the single-card ``fit_fused`` epoch of the
whole set beside them. It then holds the exact-DP (K = 1) parameters of
all ranks equal and against the single-card epoch on the composed tile
permutation (each global batch the union of the ranks' local batches),
profiles one more K = 1 epoch on every rank (on NCCL one replay of its
graph: rank 0's epoch.cu launches and NCCL device events),
norm-wise to ``chip_smoke.py``'s bf16 limit, and prints one JSON line
with the card's name and power limit. Imports nothing of JAX.
"""

import argparse
import gc
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=0,
                    help="processes (default: every visible card)")
    ap.add_argument("--n", type=int, default=65536, help="spectra")
    ap.add_argument("--batch", type=int, default=500, help="global batch")
    ap.add_argument("--reps", type=int, default=3, help="timed epochs")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=1500.0,
                    help="seconds before every rank is stopped (a hung "
                    "rank first prints its Python stack)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dp_scaling: needs a CUDA device (or --device cpu)",
              file=sys.stderr)
        return 1
    ranks = args.ranks or torch.cuda.device_count()
    if args.device == "cuda":  # built once, before the ranks load it
        from qfa_tpu_torch.ops import _build

        _build.load_library()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE=str(ranks), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    argv = [a for a in (argv if argv is not None else sys.argv[1:])]
    logs = [tempfile.TemporaryFile("w+") for _ in range(ranks)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", *argv],
        env=dict(env, RANK=str(r),
                 LOCAL_RANK=str(r if args.device == "cuda" else 0)),
        stdout=log, stderr=subprocess.STDOUT, text=True)
        for r, log in enumerate(logs)]
    # every rank ends, or one fails (the others would wait for it in a
    # collective) or the time is up: then all are stopped
    deadline = time.monotonic() + args.timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    rc = 0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or r == 0:
            print(f"--- rank {r} (exit {p.returncode}) ---\n{out}")
        rc = rc or p.returncode
    return rc


def worker(args):
    import faulthandler
    from datetime import timedelta

    # a rank still running near the deadline prints its stack and ends
    faulthandler.dump_traceback_later(max(args.timeout - 30.0, 10.0),
                                      exit=True)
    import torch.distributed as dist

    import chip_smoke as cs
    from qfa_tpu_torch.data.loader import ResidualDataset
    from qfa_tpu_torch.ops.epoch_kernel import fused_train_epoch
    from qfa_tpu_torch.parallel import (
        make_epoch_dp_fn,
        make_mesh,
        make_sync_dp_epoch_fn,
        shard_dataset,
    )
    from qfa_tpu_torch.parallel.mesh import pack
    from qfa_tpu_torch.train import (
        SeededShuffler,
        TrainConfig,
        TrainState,
        pick_tiling,
    )

    rank = int(os.environ["RANK"])
    cuda = args.device == "cuda"
    if cuda:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        device = torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo",
                            timeout=timedelta(seconds=300))
    mesh = make_mesh(device=device)
    ndev = mesh.size

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # the problem, the same on every rank (drawn from a seed)
    grid, params, st, data = cs.window_problem(cs.SDSS, args.n, device,
                                               cs.SEED + 81)
    b_shard = args.batch // ndev
    tb, shard_rows = pick_tiling(b_shard)
    batch_rows = shard_rows * ndev
    n_batches = -(-args.n // args.batch)
    data = cs.pad_rows(data, n_batches * batch_rows - args.n)
    zq, _, kw = cs.layout(grid, data, "derived")
    whole = ResidualDataset(delta=data["delta"], error=data["error"],
                            zabs=zq, mask=None)
    shard = shard_dataset(whole, mesh)
    n_tiles = shard.size // tb
    perm = SeededShuffler(cs.SEED, rank).tiles(0, n_tiles)
    cfg = TrainConfig(batch_size=args.batch, mxu_bf16=True)
    dp_kw = dict(tile_batch=tb, batch_rows=batch_rows, loglam=kw["loglam"],
                 n_real=args.n, plain=not cuda)
    state = TrainState(params, st)
    engines = {
        "sync_dp K=1": (make_sync_dp_epoch_fn(
            cfg, mesh, batches_per_launch=1, **dp_kw), perm),
        "sync_dp K=16": (make_sync_dp_epoch_fn(
            cfg, mesh, batches_per_launch=16, **dp_kw), perm),
        "sync_dp K=1 eager": (make_sync_dp_epoch_fn(
            cfg, mesh, batches_per_launch=1, engine="eager", **dp_kw), perm),
        "epoch_dp": (make_epoch_dp_fn(cfg, mesh, **dp_kw), perm[None]),
    }
    times, out = {}, {}
    for label, (fn, p) in engines.items():
        samples = []
        for rep in range(args.reps + 2):  # the first two warm up
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            new, loss = fn(state, shard, p)
            float(loss)
            sync()
            if rep > 1:
                samples.append((time.perf_counter() - t0) * 1e3)
        times[label] = {"ms": statistics.median(samples), "samples": samples,
                        "engine": getattr(fn, "engine", None)}
        print(f"rank {rank}: {label} timed", file=sys.stderr, flush=True)
        out[label] = new
    # one more exact-DP epoch under torch.profiler on every rank
    prof = None
    if cuda:
        fn, p = engines["sync_dp K=1"]
        dist.barrier()
        _, _, _, busy, counts = cs.profile_run(lambda: fn(state, shard, p))
        if counts is not None:
            prof = {"engine": fn.engine, "busy": busy,
                    "nccl_events": sum(c for k, c in counts.items()
                                       if "nccl" in k.lower()),
                    "epoch_launches": {x: sum(c for k, c in counts.items()
                                              if x in k)
                                       for x in cs.EPOCH_STAGES}}
    # the single-card epoch of the whole set, on rank 0
    if rank == 0:
        # fit_fused's tile on one card, unless the ranks padded the batch
        tb1 = pick_tiling(args.batch)[0] if batch_rows == args.batch else tb
        g_perm = SeededShuffler(cs.SEED, 0).tiles(0, whole.size // tb1)
        run = (lambda: fused_train_epoch(
            params, st.m, st.v, whole.delta, whole.error, whole.zabs,
            g_perm, None, epoch=0, n_batches=n_batches, tile_batch=tb1,
            mxu_bf16=True, learning_rate=cfg.learning_rate,
            weight_decay=cfg.weight_decay, **kw))
        samples = []
        for rep in range(args.reps + 1):
            sync()
            t0 = time.perf_counter()
            run()
            sync()
            if rep:
                samples.append((time.perf_counter() - t0) * 1e3)
        times["fit_fused one card"] = {"ms": statistics.median(samples),
                                       "samples": samples}
    dist.barrier()
    # exact DP: every rank's parameters, and the single-card composition
    vec = pack([out["sync_dp K=1"].params])
    parts = [torch.empty_like(vec) for _ in range(ndev)]
    dist.all_gather(parts, vec)
    perms = [torch.empty_like(perm) for _ in range(ndev)]
    dist.all_gather_object(perms, perm)
    record = None
    if rank == 0:
        equal = all(torch.equal(x, parts[0]) for x in parts)
        tpb = shard_rows // tb
        composed = torch.cat([q.reshape(-1, tpb) + d * n_tiles
                              for d, q in enumerate(perms)],
                             dim=1).reshape(-1)
        ref = fused_train_epoch(
            params, st.m, st.v, whole.delta, whole.error, whole.zabs,
            composed, None, epoch=0, n_batches=n_batches, tile_batch=tb,
            mxu_bf16=True, learning_rate=cfg.learning_rate,
            weight_decay=cfg.weight_decay, **kw)
        want = pack([ref.params])
        rel = float((parts[0] - want).norm() / want.norm())
        limit = cs.EPOCH_LIMITS["bf16"]["params"]
        smi = "cpu"
        if cuda:
            from qfa_tpu_torch.calibrate import card_info

            smi = card_info()["nvidia_smi"]
        record = {
            "card": smi, "ranks": ndev, "backend": dist.get_backend(),
            "n": args.n, "batch": args.batch, "local_tile": tb,
            "batches": n_batches, "times": times,
            "sync_dp_k1_profile": prof,
            "exact_dp_ranks_equal": equal,
            "exact_dp_params_rel_to_one_card_composition": rel,
            "limit": limit,
        }
        print(json.dumps(record), flush=True)
    dist.barrier()
    # sync_dp's graphs hold NCCL's captured collectives: they go first
    # (destroying the process group waits for them otherwise)
    engines.clear()
    fn = None
    gc.collect()
    dist.destroy_process_group()
    if record is not None and not (record["exact_dp_ranks_equal"]
                                   and record["exact_dp_params_rel_to_one_card_composition"]
                                   <= record["limit"]):
        print("dp_scaling: FAIL: exact DP differs from the composition",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
