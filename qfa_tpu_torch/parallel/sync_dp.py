"""Exact data-parallel training at kernel-call cadence.

The counterpart of ``qfa_tpu.parallel.sync_dp``, on the epoch kernel's
window mode (``ops.epoch_kernel``, ``sync_grads``): each call covers a
WINDOW of ``batches_per_launch`` (K) batches of this rank's shard. It
first applies the previous window's last-batch buffer, already summed
across the ranks, through the same update a batch ends with, then runs
its own batches, and exports its last batch's buffer for the next sum
instead of applying it. Each window is one call and one ``all_reduce``,
on the current stream, with no host sync; the epoch ends with a call that
only applies the last buffer (the flush), so the state after an epoch is
fully updated.

* K = 1: exact DP. No update ever uses a local gradient, the replicas
  stay equal, and the cost is one kernel call and one collective per
  batch.
* K > 1: the K - 1 inner batches of a window update locally, and the
  window's collective also averages parameters and Adam moments (the
  state scaled by 1 / size rides the same vector): local SGD re-synced
  every K batches. At one rank any K gives the K = 1 trajectory.

The reduced vector is ``[pending | loss sums | n_real | (state / size)]``
(``ops.epoch_kernel.pending_len`` floats of pending). Loss bookkeeping:
per-batch sums and real rows summed across ranks, the batch means summed
over ``floor(n_real / batch_size)``. The epoch counter stays at the
epoch's for every window and the flush, and advances by one after.

How the windows run (:func:`window_engine`, from the mesh's backend and
the data's device):

* ``"graph"``, on an NCCL mesh with CUDA planes: the windows go through
  ``ops.epoch_kernel.WindowCalls``, which keeps the state, scratch,
  permutation, schedule row and the windows' vectors across epochs. The
  first epoch on a dataset runs them eagerly (so NCCL's communicator and
  every kernel exist); the second captures the whole epoch into one
  ``torch.cuda.CUDAGraph``: each window call, its ``all_reduce`` (and for
  K > 1 the state's 1/size scaling and reload), the flush. From then on
  an epoch is three small copies (permutation, schedule row, state), one
  replay and copies of the results; the host issues no window call and no
  collective. JAX's counterpart is the ``lax.scan`` over the windows
  inside one jit, one dispatch per epoch. A new dataset (``fit_fused``'s
  reshuffle makes new tensors), batch count, K or tiling captures anew.
* ``"eager"``, on CUDA planes over any other backend (gloo, whose
  collectives cannot be captured): the same calls on the same kept
  buffers, issued from Python window by window.
* ``"calls"``, on CPU tensors or with ``plain=True``: one
  ``fused_train_epoch`` call per window (its plain version on the CPU).

All three give the same bits.
"""

from __future__ import annotations

import weakref

import torch

from ..data.loader import ResidualDataset
from ..ops.epoch_kernel import (
    WindowCalls,
    fused_train_epoch,
    fused_train_epoch_plain,
)
from ..train import adam
from ..train.state import TrainConfig, TrainState
from ._common import (
    epoch_loss,
    kernel_kwargs,
    local_window,
    resolve_tile,
    tile_perm,
)
from .mesh import DataMesh, pack, unpack

__all__ = ["make_sync_dp_epoch_fn", "sync_dp_train_epoch",
           "window_engine"]


def window_engine(backend: str, device_type: str, plain: bool) -> str:
    """How an epoch's windows run: ``"graph"``, ``"eager"`` or
    ``"calls"`` (module docstring), from the mesh's backend, the data's
    device type and ``plain``."""
    if plain or device_type != "cuda":
        return "calls"
    return "graph" if backend == "nccl" else "eager"


class _KernelWindows:
    """The windows of every epoch on one dataset, on the CUDA kernel:
    ``WindowCalls``, the windows' vectors (one buffer, each window's
    vector 16-byte aligned in it, so no loss row is copied apart) and,
    with ``graph``, the epoch's CUDA graph."""

    def __init__(self, state, data, kw, mesh, K, tpb, tb, n_batches,
                 sync_state, graph):
        self.run = run = WindowCalls(
            state.params, state.opt_state.m, state.opt_state.v, data.delta,
            data.error, data.zabs, data.mask, epoch=int(state.opt_state.epoch),
            tiles_per_batch=tpb, tile_batch=tb, **kw)
        self.mesh, self.tpb, self.sync_state, self.graph = \
            mesh, tpb, sync_state, graph
        self.epochs = 0
        n_p = run.pending_len
        extra = run.state_len if sync_state else 0
        self.windows = [(lo, min(K, n_batches - lo))
                        for lo in range(0, n_batches, K)]
        stride = -(-(n_p + 2 * K + extra) // 4) * 4
        dev = data.delta.device
        self.buf = torch.empty((len(self.windows) * stride,),
                               dtype=torch.float32, device=dev)
        self.vecs, losses, reals = [], [], []
        for w, (_, k) in enumerate(self.windows):
            at = w * stride
            self.vecs.append(self.buf[at:at + n_p + 2 * k + extra])
            losses += range(at + n_p, at + n_p + k)
            reals += range(at + n_p + k, at + n_p + 2 * k)
        # where the loss rows and n_real lie in the buffer
        self.books = torch.tensor(losses + reals, dtype=torch.int64,
                                  device=dev)

    def issue(self) -> None:
        """The windows, their collectives and the flush, from the loaded
        state."""
        run, tpb, n_p = self.run, self.tpb, self.run.pending_len
        pend = None
        for (lo, k), vec in zip(self.windows, self.vecs):
            run.window(run.perm[lo * tpb:(lo + k) * tpb], k, pend, out=vec)
            if self.sync_state:
                torch.mul(run.state(), 1.0 / self.mesh.size,
                          out=vec[n_p + 2 * k:])
            self.mesh.all_reduce(vec)  # the window's one collective
            if self.sync_state:
                run.load_state(vec[n_p + 2 * k:])
            pend = vec[:n_p]
        run.flush(pend)

    def epoch(self, state, perm, ep0):
        """One epoch: (params, m, v, loss sums, n_real), none of them
        views of a buffer that the next epoch overwrites."""
        run = self.run
        run.set_perm(perm)
        run.set_epoch(ep0)
        run.load(state.params, state.opt_state.m, state.opt_state.v)
        if self.graph and self.epochs and run.graph is None:
            run.capture(self.issue)
        if run.graph is not None:
            run.replay()
        else:
            self.issue()
        self.epochs += 1
        p, m, v = run.snapshot()
        books = torch.take(self.buf, self.books)
        n = books.numel() // 2
        return p, m, v, books[:n], books[n:]


def make_sync_dp_epoch_fn(
    config: TrainConfig,
    mesh: DataMesh,
    *,
    batches_per_launch: int = 1,
    tile_batch: int | None = None,
    batch_rows: int | None = None,
    loglam=None,
    n_real: int | None = None,
    plain: bool = False,
    engine: str | None = None,
):
    """Exact-DP epoch ``(state, data, perm) -> (state, loss)``.

    ``data`` is this rank's shard (``parallel.dp.shard_dataset``), a whole
    number of local batch windows of ``(batch_rows or batch_size) /
    size`` rows; ``state`` is replicated; ``perm`` is this rank's tile
    permutation (``n_local / tile`` indices) or a ``torch.Generator`` to
    draw it from. ``loss`` is a 0-d tensor on the data's device; the
    returned state is the caller's own (no buffer of a later epoch).
    ``plain=True`` runs the epoch kernel's plain version. The engine is
    :func:`window_engine`'s, or ``"eager"`` where that would be
    ``"graph"`` if ``engine="eager"`` is passed (to time or check the graph
    against the calls it holds). The function's ``engine`` attribute
    names the last epoch's engine, and ``windows`` holds the kernel
    windows of the last dataset (its ``run.graph`` the captured epoch).
    That graph holds NCCL's captured collectives: drop the function
    before ``destroy_process_group``, which waits for them otherwise.
    """
    ndev = mesh.size
    b_local, b_local_rows = local_window(config, mesh, batch_rows)
    K = int(batches_per_launch)
    if K < 1:
        raise ValueError(f"batches_per_launch must be >= 1, got {K}")
    if engine not in (None, "eager"):
        raise ValueError(f"engine must be None or 'eager', got {engine!r}")
    call = fused_train_epoch_plain if plain else fused_train_epoch
    kw = kernel_kwargs(config, loglam)
    sync_state = K > 1 and ndev > 1

    def reduce_window(out, k: int):
        """The window's one collective: the pending buffer and the loss
        books, plus the 1/size-scaled state when the inner batches
        updated locally."""
        parts = [out.pending, out.loss_sums, out.n_real]
        if sync_state:
            parts.append(pack((out.params, out.m, out.v), 1.0 / ndev))
        vec = mesh.all_reduce(torch.cat(parts))
        n_p = out.pending.numel()
        pend = vec[:n_p]
        losses, reals = vec[n_p:n_p + k], vec[n_p + k:n_p + 2 * k]
        state = (out.params, out.m, out.v)
        if sync_state:
            state = unpack(vec[n_p + 2 * k:], state)
        return state, pend, losses, reals

    def kernel_windows(fn, state, data, perm, ep0, tpb, tb, n_batches,
                       graph):
        """The windows on the card: (params, m, v, loss sums, n_real)."""
        key = (tuple(None if t is None else t.data_ptr() for t in data),
               tuple(state.params.F.shape), n_batches, tpb, tb, graph)
        if fn.windows is None or fn.windows.key != key:
            fn.windows = None  # let the last dataset's buffers go
            fn.windows = _KernelWindows(state, data, kw, mesh, K, tpb, tb,
                                        n_batches, sync_state, graph)
            fn.windows.key = key
        return fn.windows.epoch(state, perm, ep0)

    def epoch_fn(state: TrainState, data: ResidualDataset, perm):
        fn = me()
        n_local = data.size
        tb = resolve_tile(tile_batch, b_local_rows)
        tpb = b_local_rows // tb
        if n_local % b_local_rows or n_local < b_local_rows:
            raise ValueError(
                f"local shard of {n_local} rows is not a whole, nonzero "
                f"number of {b_local_rows}-row batch windows (global batch "
                f"{config.batch_size} over {ndev} devices): pad the "
                f"dataset to a multiple of {b_local_rows * ndev} rows")
        n_batches = n_local // b_local_rows
        perm = tile_perm(perm, (n_batches * tpb,), n_local // tb)
        ep0 = int(state.opt_state.epoch)
        n_total = n_local * ndev if n_real is None else n_real
        chosen = window_engine(mesh.backend, data.delta.device.type, plain)
        fn.engine = engine if chosen == "graph" and engine else chosen
        if fn.engine != "calls":
            p, m, v, losses, reals = kernel_windows(
                fn, state, data, perm, ep0, tpb, tb, n_batches,
                fn.engine == "graph")
            return (TrainState(p, adam.AdamState(m=m, v=v, epoch=ep0 + 1)),
                    epoch_loss(losses, reals, n_total, config.batch_size))
        p, m, v = state.params, state.opt_state.m, state.opt_state.v
        pend, losses, reals = None, [], []
        common = dict(epoch=ep0, tiles_per_batch=tpb, tile_batch=tb,
                      sync_grads=True, **kw)
        for lo in range(0, n_batches, K):
            k = min(K, n_batches - lo)
            out = call(p, m, v, data.delta, data.error, data.zabs,
                       perm[lo * tpb:(lo + k) * tpb], data.mask,
                       n_batches=k, pending=pend,
                       apply_pending=int(pend is not None), **common)
            (p, m, v), pend, ls, nr = reduce_window(out, k)
            losses.append(ls)
            reals.append(nr)
        # the flush: apply the last window's summed buffer, no batch
        out = call(p, m, v, data.delta, data.error, data.zabs, perm[:0],
                   data.mask, n_batches=0, pending=pend, apply_pending=1,
                   **common)
        new_state = TrainState(out.params, adam.AdamState(
            m=out.m, v=out.v, epoch=ep0 + 1))
        return new_state, epoch_loss(torch.cat(losses), torch.cat(reals),
                                     n_total, config.batch_size)

    epoch_fn.engine = epoch_fn.windows = None
    # held weakly, so that the function and its graph go as soon as the
    # caller drops it (a closure over itself would keep both alive)
    me = weakref.ref(epoch_fn)
    return epoch_fn


def sync_dp_train_epoch(state: TrainState, data: ResidualDataset, perm,
                        config: TrainConfig, mesh: DataMesh, epoch_fn=None,
                        **kwargs) -> tuple[TrainState, float]:
    """Run one exact-DP epoch; returns (state, loss)."""
    if epoch_fn is None:
        epoch_fn = make_sync_dp_epoch_fn(config, mesh, **kwargs)
    state, loss = epoch_fn(state, data, perm)
    return state, float(loss)
