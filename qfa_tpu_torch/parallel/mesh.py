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

from ..models.params import PARAM_NAMES, QFAParams

Tensor = torch.Tensor

__all__ = [
    "DataMesh",
    "data_sharding",
    "initialize_distributed",
    "local_shard_size",
    "make_mesh",
    "pack",
    "replicated",
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


def local_shard_size(n: int, mesh: DataMesh) -> int:
    if n % mesh.size:
        raise ValueError(f"dataset size {n} not divisible by {mesh.size} "
                         "devices")
    return n // mesh.size


def data_sharding(mesh: DataMesh, n: int) -> slice:
    """This rank's rows of an ``n``-row array split over the mesh."""
    k = local_shard_size(n, mesh)
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


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
    from ..train import adam
    from ..train.loop import TrainState

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
