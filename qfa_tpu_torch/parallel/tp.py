"""2-D mesh parallelism: batch x wavelength (data x pix) sharding.

The counterpart of ``qfa_tpu.parallel.tp``. For DESI-scale grids (Npix
~ 9k+) or very large batches the wavelength axis itself is sharded:
every per-spectrum contraction (``K = F^T diag(w) F``, ``w = F^T u``, the
quad, logdet and observed-pixel sums) contracts over pixels, so a
pixel-sharded layout turns each into partial contractions plus one sum
over the ``pix`` axis. JAX lets GSPMD insert those sums; here they are
written out. The layout is JAX's:

    batch planes (B, Npix)   -> rows over 'data', pixels over 'pix'
    zabs (B, Nb), weight (B) -> rows over 'data' only
    F (Npix, Nh), Psi (Npix) -> pixels over 'pix'
    omega (Nb), scalars      -> replicated (the blue/red split does not
                                align with pixel shards)

One process per device, as everywhere in :mod:`qfa_tpu_torch.parallel`:
world rank ``r = d * n_pix + p`` sits at ``(d, p)`` of the mesh, as
JAX's ``reshape(n_data, n_pix)`` of the device list places device ``r``.
A step (:func:`make_tp_step_fn`) runs the plain model on this rank's
block by ``torch.autograd`` (JAX's step reaches no Pallas kernel
either), sums the partial contractions over the ``pix`` group once per
forward, and reduces the gradients and counts in two packed collectives:
the replicated leaves' partial gradients and the blue-pixel counts over
``pix``, then everything over ``data``.
"""

from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

from ..data.batch import SpectraBatch
from ..linalg import lowrank
from ..models.params import PARAM_NAMES, QFAParams
from ..models.qfa import (
    GradCounts,
    absorption,
    noise_diagonal,
    normalize_with_counts,
)
from ..train.state import TrainConfig, TrainState, apply_step
from .mesh import initialize_distributed

Tensor = torch.Tensor

__all__ = ["make_mesh_2d", "shard_params_2d", "shard_batch_2d",
           "make_tp_step_fn", "Mesh2D", "PixShard", "gather_params_2d"]


class Mesh2D(NamedTuple):
    """This process's place in a (data, pix) layout of ``n_data * n_pix``
    ranks, and the two process groups through it."""

    rank: int
    size: int  #: world size: one rank per device
    d: int  #: the row of the mesh (the data shard)
    p: int  #: the column of the mesh (the pixel shard)
    n_data: int
    n_pix: int
    device: torch.device
    data_group: Any = None  #: the ranks sharing ``p``
    pix_group: Any = None  #: the ranks sharing ``d``

    def all_reduce_data(self, vec: Tensor) -> Tensor:
        """Sum ``vec`` in place over the ranks of this pixel shard."""
        if self.n_data > 1:
            dist.all_reduce(vec, group=self.data_group)
        return vec

    def all_reduce_pix(self, vec: Tensor) -> Tensor:
        """Sum ``vec`` in place over the ranks of this data shard."""
        if self.n_pix > 1:
            dist.all_reduce(vec, group=self.pix_group)
        return vec

    def pix_slice(self, npix: int) -> slice:
        """This rank's pixel columns of an ``npix``-pixel grid."""
        k = npix // self.n_pix
        return slice(self.p * k, (self.p + 1) * k)


def make_mesh_2d(n_data: int, n_pix: int, *, device=None,
                 backend: str | None = None) -> Mesh2D:
    """A (data, pix) mesh over ``n_data * n_pix`` ranks: joins the process
    group from the environment if it has not been joined (NCCL for a CUDA
    device, gloo for the CPU or for several ranks on one card: pass
    ``backend``), then makes every row group and every column group, in
    the same order on every rank (``dist.new_group`` is collective).
    ``device`` defaults to ``cuda:LOCAL_RANK``."""
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))) \
        if device is None else torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    initialize_distributed(backend=backend)
    need, size = n_data * n_pix, dist.get_world_size()
    if need > size:
        raise ValueError(f"need {need} devices, have {size}")
    if need < size:
        raise ValueError(
            f"a {n_data} x {n_pix} mesh needs {need} processes, but {size} "
            "joined: the port runs one process per device (torchrun "
            f"--nproc_per_node {need})")
    rank = dist.get_rank()
    d, p = divmod(rank, n_pix)
    pix_groups = [dist.new_group([e * n_pix + q for q in range(n_pix)])
                  for e in range(n_data)]
    data_groups = [dist.new_group([e * n_pix + q for e in range(n_data)])
                   for q in range(n_pix)]
    return Mesh2D(rank=rank, size=size, d=d, p=p, n_data=n_data,
                  n_pix=n_pix, device=device, data_group=data_groups[p],
                  pix_group=pix_groups[d])


def _check_pix_divisible(npix: int, mesh: Mesh2D) -> None:
    if npix % mesh.n_pix:
        raise ValueError(
            f"Npix={npix} must be divisible by the 'pix' mesh axis "
            f"({mesh.n_pix}); pad the wavelength grid (masked pixels are "
            "free) or pick a compatible mesh shape")


def shard_params_2d(params: QFAParams, mesh: Mesh2D) -> QFAParams:
    """This rank's parameters: its pixel rows of ``F`` and ``Psi``, the
    rest whole, on the mesh's device."""
    _check_pix_divisible(params.F.shape[0], mesh)
    cols = mesh.pix_slice(params.F.shape[0])
    return QFAParams(**{
        k: (getattr(params, k).detach()[cols] if k in ("F", "Psi")
            else getattr(params, k).detach()).to(mesh.device)
        for k in PARAM_NAMES})


class PixShard(NamedTuple):
    """One rank's block of a :class:`SpectraBatch`: its rows of every
    plane, of ``delta``, ``error`` and ``mask`` only its pixel columns
    ``[p0, p0 + Npix / n_pix)``, and all Nb columns of ``zabs``."""

    delta: Tensor  #: (B / n_data, Npix / n_pix)
    error: Tensor  #: (B / n_data, Npix / n_pix)
    zabs: Tensor  #: (B / n_data, Nb)
    mask: Tensor  #: (B / n_data, Npix / n_pix)
    weight: Tensor  #: (B / n_data,)
    p0: int  #: the grid index of this block's first pixel

    @property
    def nb(self) -> int:
        """Blue pixels of the whole grid."""
        return self.zabs.shape[-1]

    def blue(self) -> slice:
        """The grid's blue pixels inside this block, ``[p0, min(p1,
        Nb))`` (empty when ``p0 >= Nb``), as grid indices."""
        return slice(self.p0, max(self.p0, min(self.p0 + self.delta.shape[-1],
                                               self.nb)))


def shard_batch_2d(batch: SpectraBatch, mesh: Mesh2D) -> PixShard:
    """This rank's block of ``batch`` (JAX's placement: spectra over
    'data', pixels over 'pix'; ``zabs`` and ``weight`` over 'data'
    only), on the mesh's device."""
    b, npix = batch.delta.shape
    if b % mesh.n_data:
        raise ValueError(f"batch of {b} rows not divisible by the 'data' "
                         f"mesh axis ({mesh.n_data})")
    _check_pix_divisible(npix, mesh)
    k = b // mesh.n_data
    rows = slice(mesh.d * k, (mesh.d + 1) * k)
    cols = mesh.pix_slice(npix)

    def put(x, *idx):
        return x[idx].to(mesh.device).contiguous()

    return PixShard(delta=put(batch.delta, rows, cols),
                    error=put(batch.error, rows, cols),
                    zabs=put(batch.zabs, rows),
                    mask=put(batch.mask, rows, cols),
                    weight=put(batch.weight, rows), p0=cols.start)


def gather_params_2d(params: QFAParams, mesh: Mesh2D) -> QFAParams:
    """Whole parameters from this rank's shard (:func:`shard_params_2d`'s
    layout): ``F`` and ``Psi`` gathered over the ``pix`` group; for
    checkpoints and tests."""
    def whole(x: Tensor) -> Tensor:
        if mesh.n_pix == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(mesh.n_pix)]
        dist.all_gather(parts, x.contiguous(), group=mesh.pix_group)
        return torch.cat(parts)

    return QFAParams(**{k: whole(getattr(params, k).detach())
                        if k in ("F", "Psi") else getattr(params, k).detach()
                        for k in PARAM_NAMES})


class _PixSum(torch.autograd.Function):
    """The sum of every pixel shard's partial contractions, on each rank
    of this rank's ``pix`` group.

    Its backward is the identity, not the all-reduce that
    ``torch.distributed.nn.functional.all_reduce`` applies. Every rank of
    the group goes on to compute the same loss from the summed
    contractions, and the derivative of the total with respect to one
    rank's partial is the identity: so the gradient arriving here is
    already this rank's. Summing it over the group would scale every
    gradient by ``n_pix``.
    """

    @staticmethod
    def forward(ctx, partial: Tensor, mesh) -> Tensor:
        return mesh.all_reduce_pix(partial.clone())

    @staticmethod
    def backward(ctx, grad: Tensor):
        return grad, None


class _BlueLeaves(NamedTuple):
    """What ``models.qfa.noise_diagonal`` reads of the parameters, cut to
    one pixel block."""

    Psi: Tensor
    omega: Tensor
    tau0: Tensor
    c0: Tensor
    beta: Tensor


def make_tp_step_fn(config: TrainConfig, mesh: Mesh2D) -> Callable:
    """Training step ``(state, shard) -> (state, loss)`` on the 2-D mesh:
    ``state`` holds :func:`shard_params_2d`'s parameters (the Adam moments
    in the same layout: ``adam.init`` of them), ``shard`` comes from
    :func:`shard_batch_2d`. The loss (a 0-d tensor) and the replicated
    leaves come out equal on every rank; each rank's ``F`` and ``Psi``
    rows are those of the single-device step."""
    adam_cfg = config.adam_config()
    tau = config.options.tau_which

    def local_sums(params: QFAParams, s: PixShard):
        blue = s.blue()
        nbl, npix_l = blue.stop - blue.start, s.delta.shape[-1]
        local = SpectraBatch(delta=s.delta, error=s.error,
                             zabs=s.zabs[:, blue], mask=s.mask,
                             weight=s.weight)
        leaf = QFAParams(**{k: getattr(params, k).detach().clone()
                            for k in PARAM_NAMES})
        with torch.enable_grad():
            amp = absorption(local.zabs, npix_l - nbl, tau)
            view = _BlueLeaves(Psi=leaf.Psi, omega=leaf.omega[blue],
                               tau0=leaf.tau0, c0=leaf.c0, beta=leaf.beta)
            dinv, log_d, _ = noise_diagonal(view, local, amp)
            mask = local.mask.to(amp.dtype)
            partial = lowrank.contractions(leaf.F, local.delta * mask, amp,
                                           dinv, log_d, mask)
            factors = lowrank.from_contractions(_PixSum.apply(partial, mesh),
                                                leaf.F.shape[1])
            w = local.weight.to(amp.dtype)
            total = torch.sum(lowrank.nll(factors) * w)
            grads = torch.autograd.grad(
                total, [getattr(leaf, k) for k in PARAM_NAMES])
        seen = mask * w[:, None]
        pix = torch.sum(seen, dim=0)
        blue_counts = torch.zeros_like(leaf.omega.detach())
        blue_counts[blue] = pix[:nbl]
        row_blue = torch.sum(seen[:, :nbl], dim=1)
        return (total.detach(), torch.sum(w), dict(zip(PARAM_NAMES, grads)),
                pix, blue_counts, row_blue)

    def all_shards_ok(ok: Tensor) -> Tensor:
        # rows of one pixel shard hold the same F and Psi rows: the pix
        # group sees every shard
        bad = mesh.all_reduce_pix((~ok).to(torch.float32).reshape(1))
        return bad[0] == 0

    def step(state: TrainState, shard: PixShard):
        total, n_real, g, pix, blue_counts, row_blue = local_sums(
            state.params, shard)
        nb = blue_counts.numel()
        rep = ("omega", "tau0", "c0", "beta")
        # over pix: the replicated leaves' partial gradients, the blue
        # pixels' counts and each row's count of observed blue pixels
        vp = mesh.all_reduce_pix(torch.cat(
            [g[k].reshape(-1) for k in rep] + [blue_counts, row_blue]))
        any_blue = torch.sum((vp[nb + 3 + nb:] > 0).to(torch.float32))
        # over data: everything
        vd = mesh.all_reduce_data(torch.cat(
            [total.reshape(1), n_real.reshape(1), g["F"].reshape(-1),
             g["Psi"], vp[:nb + 3 + nb], pix, any_blue.reshape(1)]))
        total, n_real = vd[0], torch.clamp(vd[1], min=1.0)
        off, out = 2, {}
        for k in PARAM_NAMES:
            ref = getattr(state.params, k)
            out[k] = vd[off:off + ref.numel()].view(ref.shape)
            off += ref.numel()
        blue_counts = vd[off:off + nb]
        counts = GradCounts(pix=vd[off + nb:-1], scalar=vd[-1])
        grads = QFAParams(**out).requires_grad_(False)
        if config.reference_norm:
            grads = normalize_with_counts(grads, counts, blue=blue_counts)
        else:
            grads = QFAParams(*(getattr(grads, k) / n_real
                                for k in PARAM_NAMES)).requires_grad_(False)
        return apply_step(config, adam_cfg, state, total / n_real, grads,
                          all_shards_ok)

    return step
