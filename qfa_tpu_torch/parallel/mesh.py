"""The data-parallel process layout on ``torch.distributed``.

The counterpart of ``qfa_tpu.parallel.mesh``. JAX runs one controller
over a ``jax.sharding.Mesh`` of devices; the port runs one process per
device, as ``torchrun`` starts them (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), and a :class:`DataMesh`
names this process's place in it: its rank, the world size, its device
(``cuda:LOCAL_RANK`` unless the caller names another) and the process
group. The backend is NCCL for CUDA devices and gloo for the CPU; the
caller may name it. Collectives are called on the tensor where it lives.

* Rank ``d`` owns rows ``[d n / size, (d + 1) n / size)`` of the padded
  dataset (:func:`data_sharding`, :func:`shard_leaves`): the rows JAX's
  ``data_sharding`` gives device ``d`` of a 1-D mesh, so rank ``d`` here
  matches device ``d`` there.
* The trainers take each rank's own rows only: :func:`rank_rows` says
  which rows of the whole set those are (contiguous shards of
  :func:`shard_size` rows, the inert pad rows at the global tail, so on
  the last ranks), and :func:`count_rows` learns the whole set's size
  from the ranks' counts by one ``all_reduce``.
* State is replicated by one broadcast from rank 0 (:func:`replicated`),
  packed into one flat float32 vector (:func:`pack`, :func:`unpack`),
  as every engine packs what it reduces into one ``all_reduce``.

``jit_with_placed_inputs`` has no counterpart: it placed a jit's inputs
on the TPU mesh before tracing; a torch process's tensors already lie on
its own device, and nothing is traced.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from ..data.shuffle import batch_window
from ..models.params import PARAM_NAMES, QFAParams
from ..train import adam
from ..train.state import TrainState

Tensor = torch.Tensor

__all__ = [
    "DataMesh",
    "count_rows",
    "data_sharding",
    "initialize_distributed",
    "local_shard_size",
    "make_mesh",
    "pack",
    "rank_rows",
    "replicated",
    "shard_size",
    "shard_leaves",
    "unpack",
]


class DataMesh(NamedTuple):
    """This process's place in a 1-D data-parallel layout."""

    rank: int
    size: int  #: world size: one rank per device
    device: torch.device
    group: Any = None  #: the process group (None: the default group)

    @property
    def backend(self) -> str:
        """The process group's backend: ``"nccl"``, ``"gloo"``, ..."""
        return str(dist.get_backend(self.group))

    def all_reduce(self, vec: Tensor) -> Tensor:
        """Sum ``vec`` across the ranks in place, on the tensor's device
        (on the current stream: nothing waits on the host for NCCL)."""
        dist.all_reduce(vec, group=self.group)
        return vec


def initialize_distributed(backend: str | None = None, **kwargs) -> None:
    """Join the process group: a thin wrapper over
    ``torch.distributed.init_process_group`` (``env://`` by default, as
    ``torchrun`` sets it up; ``init_method``, ``rank`` and ``world_size``
    may be passed). ``backend`` defaults to NCCL when CUDA is available,
    else gloo. Safe to call when already initialized; every other failure
    (an unreachable address, a timeout, ...) is raised: a run that
    silently trained alone would train on a fraction of the data."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    try:
        dist.init_process_group(backend=backend, **kwargs)
    except (RuntimeError, ValueError) as e:
        if "already initialized" in str(e).lower():
            return
        raise


def make_mesh(n_devices: int | None = None, *, device=None, group=None,
              backend: str | None = None) -> DataMesh:
    """The 1-D data mesh of this process: joins the process group from
    the environment if it has not been joined (:func:`initialize_distributed`
    with ``backend``, by default NCCL for a CUDA device and gloo for the
    CPU). ``n_devices`` must equal the world size (one process per device:
    start as many with ``torchrun --nproc_per_node``). ``device`` defaults
    to ``cuda:LOCAL_RANK``; pass ``"cpu"`` for the plain path."""
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))) \
        if device is None else torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    initialize_distributed(backend=backend)
    rank = dist.get_rank(group)
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"requested {n_devices} devices, but {size} processes joined: "
            "the port runs one process per device (torchrun "
            f"--nproc_per_node {n_devices})")
    return DataMesh(rank=rank, size=size, device=device, group=group)


def local_shard_size(n: int, mesh: DataMesh | int) -> int:
    """Rows of each rank's equal share of an ``n``-row array split over
    the mesh (or over ``mesh`` ranks, given as a count)."""
    size = mesh if isinstance(mesh, int) else mesh.size
    if n % size:
        raise ValueError(f"dataset size {n} not divisible by {size} "
                         "devices")
    return n // size


def data_sharding(mesh: DataMesh, n: int) -> slice:
    """This rank's rows of an ``n``-row array split over the mesh."""
    k = local_shard_size(n, mesh)
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_size(n_real: int, batch_size: int | None, size: int, *,
               tile_batch: int | None = None) -> int:
    """Rows of every rank's shard of an ``n_real``-row set, inert pad rows
    included. For the whole-epoch engines (``fit_fused(mesh=...)``;
    ``batch_size`` given): one local batch window per global batch, i.e.
    ``ceil(n_real / batch_size)`` windows of ``batch_size / size`` rows,
    rounded up to whole tiles of ``tile_batch`` (None: the batch's own
    tile, which divides it). For the per-step engine (``fit(mesh=...)``;
    ``batch_size`` None): the share :func:`data_sharding` gives each rank
    of the set padded to a multiple of ``size``, ``ceil(n_real / size)``."""
    if batch_size is None:  # data_sharding's split of the padded set
        return local_shard_size(-(-n_real // size) * size, size)
    local = batch_size // size
    if tile_batch is not None:
        local = batch_window(local, tile_batch)[1]
    return max(-(-n_real // batch_size), 1) * local


def rank_rows(n_real: int, batch_size: int | None, mesh: DataMesh, *,
              tile_batch: int | None = None, rank: int | None = None
              ) -> slice:
    """The rows of an ``n_real``-row set that rank ``rank`` (default: this
    process's) holds, as the trainers lay a set out over the mesh: rank
    ``r`` owns rows ``[r S, (r + 1) S)`` of the set padded to ``size S``
    rows (``S`` = :func:`shard_size`), so it holds the real ones among
    them; the pad rows lie at the global tail, on the last ranks, and a
    rank may hold fewer rows than ``S``, or none. Read, draw or slice
    each rank's rows with this, and hand ``fit_fused(mesh=...)`` (or
    ``fit(mesh=...)``, with ``batch_size`` None) those rows alone."""
    r = mesh.rank if rank is None else int(rank)
    s = shard_size(n_real, batch_size, mesh.size, tile_batch=tile_batch)
    return slice(min(r * s, n_real), min((r + 1) * s, n_real))


def count_rows(n_local: int, batch_size: int | None, mesh: DataMesh, *,
               tile_batch: int | None = None) -> int:
    """The whole set's size, from every rank's count of the rows it holds
    (``n_local``; one ``all_reduce``, on the mesh's device). Raises on
    every rank alike when a rank holds another count than
    :func:`rank_rows` gives it."""
    counts = torch.zeros(mesh.size, dtype=torch.int64, device=mesh.device)
    counts[mesh.rank] = int(n_local)
    counts = mesh.all_reduce(counts).tolist()
    n_real = sum(counts)
    want = [len(range(n_real)[rank_rows(n_real, batch_size, mesh,
                                        tile_batch=tile_batch, rank=r)])
            for r in range(mesh.size)]
    if counts != want:
        raise ValueError(
            f"the ranks hold {counts} rows, but a set of {n_real} is laid "
            f"out as {want}: give each rank its rows, "
            "parallel.rank_rows(n_real, batch_size, mesh)")
    return n_real


def shard_leaves(tree: Any, mesh: DataMesh, axis: int = 0) -> Any:
    """Every array leaf of ``tree`` (tensors or numpy arrays, in tuples,
    lists, NamedTuples or dicts; None passes) cut to this rank's slice
    along ``axis`` and moved to the mesh's device."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: shard_leaves(x, mesh, axis) for k, x in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(shard_leaves(x, mesh, axis) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_leaves(x, mesh, axis) for x in tree)
    x = torch.as_tensor(tree)
    sl = [slice(None)] * x.ndim
    sl[axis] = data_sharding(mesh, x.shape[axis])
    return x[tuple(sl)].to(mesh.device).contiguous()


def pack(trees, scale: float | None = None) -> Tensor:
    """The leaves of one or several :class:`QFAParams`, flattened into one
    float32 vector (each scaled by ``scale`` if given)."""
    parts = [getattr(t, k).detach().reshape(-1).to(torch.float32)
             for t in trees for k in PARAM_NAMES]
    vec = torch.cat(parts)
    return vec if scale is None else vec * scale


def unpack(vec: Tensor, like) -> list[QFAParams]:
    """:func:`pack` undone: one :class:`QFAParams` per tree of ``like``,
    views of ``vec`` (moments without ``requires_grad``)."""
    out, off = [], 0
    for t in like:
        leaves = {}
        for k in PARAM_NAMES:
            ref = getattr(t, k)
            leaves[k] = vec[off:off + ref.numel()].view(ref.shape)
            off += ref.numel()
        out.append(QFAParams(**leaves).requires_grad_(False))
    return out


def replicated(tree, mesh: DataMesh):
    """``tree`` (a ``TrainState``, a :class:`QFAParams`, or a list of
    them) as rank 0 holds it, on every rank: one broadcast of the packed
    leaves, on the mesh's device."""
    if isinstance(tree, TrainState):
        p, m, v = replicated([tree.params, tree.opt_state.m,
                              tree.opt_state.v], mesh)
        return TrainState(p, adam.AdamState(
            m=m.requires_grad_(False), v=v.requires_grad_(False),
            epoch=tree.opt_state.epoch))
    trees = [tree] if isinstance(tree, QFAParams) else list(tree)
    vec = pack(trees).to(mesh.device)
    dist.broadcast(vec, src=dist.get_global_rank(mesh.group, 0)
                   if mesh.group is not None else 0, group=mesh.group)
    out = [QFAParams(**{k: getattr(t, k).detach().clone() for k in
                        PARAM_NAMES}) for t in unpack(vec, trees)]
    return out[0] if isinstance(tree, QFAParams) else out
