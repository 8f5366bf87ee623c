"""Multi-device fused prediction: the spectrum axis split over the ranks.

The counterpart of ``qfa_tpu.parallel.infer_dp``. Each rank runs the
prediction kernel (``ops.infer_kernel.fused_predict``) on its own rows of
the batch (:func:`~qfa_tpu_torch.parallel.mesh.data_sharding`: rank ``d``
takes the rows JAX's mesh gives device ``d``), with no collective in the
compute: prediction couples no spectra. The outputs are gathered to rank
0, packed into one flat float32 vector per rank (one ``gather``), and
rank 0 returns the whole batch's, as JAX's call returns the global
arrays; the other ranks return None. A spectrum's outputs are computed
exactly as in a single-device call of its rank's rows: on CUDA, float32
planes take the body that call's size picks
(``ops.infer_kernel.TC_MIN_ROWS``), so a batch that a single device
would send to ``csrc/predict_tc.cu`` may run ``csrc/predict.cu`` on each
rank, and its outputs then differ in the last bits (within the kernel's
tolerances of the plain version).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.infer_kernel import FusedPredictOutputs, fused_predict
from .mesh import DataMesh, data_sharding

__all__ = ["DEFAULT_TILE", "fused_predict_dp", "make_dp_predict_fn"]

#: the padding unit per rank when the caller names none: the prediction
#: kernel's spectra per block
DEFAULT_TILE = 8


def _local(x, rows: slice, device):
    """This rank's rows of a tensor or an array, on ``device``."""
    if x is None:
        return None
    x = x[rows] if isinstance(x, torch.Tensor) else torch.tensor(x[rows])
    return x.to(device).contiguous()


def fused_predict_dp(params, mu, flux, error, zabs, mask=None, *,
                     mesh: DataMesh, tau_which: str = "becker",
                     tile_batch: int | None = None, stats_only: bool = False,
                     loglam=None, derive_zabs: bool = False,
                     out_dtype: torch.dtype = torch.float32
                     ) -> FusedPredictOutputs | None:
    """:func:`~qfa_tpu_torch.ops.infer_kernel.fused_predict` over the
    mesh: ``flux``, ``error``, ``zabs`` and ``mask`` are the whole batch
    (tensors or arrays, on any device) and ``N`` must divide over the
    ranks; with ``tile_batch``, each rank's rows must divide by it too.
    ``params``, ``mu`` and ``loglam`` lie on this rank's device. Returns
    the whole batch's outputs on rank 0 (on its device), None elsewhere.
    """
    if not isinstance(mesh, DataMesh):
        raise ValueError(
            "fused_predict_dp shards over a 1-D data mesh; got "
            f"{type(mesh).__name__} — for 2-D data x pix meshes use the "
            "training-side parallel.tp layout")
    ndev = mesh.size
    n = flux.shape[0]
    if n % ndev:
        raise ValueError(f"N={n} not divisible over the {ndev}-device mesh")
    n_local = n // ndev
    if tile_batch is not None and (tile_batch < 1 or n_local % tile_batch):
        raise ValueError(
            f"local shard of {n_local} spectra (N={n} over {ndev} devices) "
            f"not divisible by tile_batch={tile_batch}; pad N or pass "
            "another tile_batch")
    rows = data_sharding(mesh, n)
    dev = mesh.device
    res = fused_predict(
        params, mu, _local(flux, rows, dev), _local(error, rows, dev),
        _local(zabs, rows, dev), _local(mask, rows, dev),
        tau_which=tau_which, stats_only=stats_only, loglam=loglam,
        derive_zabs=derive_zabs, out_dtype=out_dtype)
    fields = [f for f in FusedPredictOutputs._fields
              if getattr(res, f) is not None]
    vec = torch.cat([getattr(res, f).to(torch.float32).reshape(-1)
                     for f in fields])
    root = mesh.rank == 0
    parts = [torch.empty_like(vec) for _ in range(ndev)] if root else None
    dist.gather(vec, parts, dst=0, group=mesh.group)
    if not root:
        return None
    whole = torch.stack(parts)  # (ndev, per-rank floats)
    out, off = {}, 0
    for f in fields:
        x = getattr(res, f)
        k = x.numel()
        out[f] = whole[:, off:off + k].reshape((n,) + x.shape[1:]).to(
            x.dtype)
        off += k
    return FusedPredictOutputs(**{f: out.get(f) for f in
                                  FusedPredictOutputs._fields})


def make_dp_predict_fn(mesh: DataMesh, *, has_mask: bool,
                       tau_which: str = "becker",
                       tile_batch: int | None = None,
                       stats_only: bool = False, derive_zabs: bool = False,
                       out_dtype: torch.dtype = torch.float32):
    """``fn(params, mu, flux, error, zabs, [mask], [loglam])``: the
    counterpart of JAX's factory of the sharded call, here
    :func:`fused_predict_dp` with these settings bound (nothing is
    compiled or cached)."""

    def fn(params, mu, flux, error, zabs, *rest):
        rest = list(rest)
        mask = rest.pop(0) if has_mask else None
        loglam = rest.pop(0) if derive_zabs else None
        return fused_predict_dp(
            params, mu, flux, error, zabs, mask, mesh=mesh,
            tau_which=tau_which, tile_batch=tile_batch,
            stats_only=stats_only, loglam=loglam, derive_zabs=derive_zabs,
            out_dtype=out_dtype)

    return fn
