"""Batch inference pipeline: continuum prediction and OOD scoring at scale.

Prediction runs over a host dataset in fixed-size chunks on a torch
device; outputs come back to the host and are written per spectrum in the
reference npz schema (``ll, hmean, hcov, cont, uncertainty``), or into one
consolidated file. Two engines, as in ``qfa_tpu.infer.predict``:

* :func:`predict_dataset` — the plain batched path (``models.qfa.predict``);
* :func:`predict_dataset_fused` — the fused prediction kernel
  (``ops.infer_kernel.fused_predict``): on a CUDA device the hand-written
  kernel, one launch per chunk.

Over a dataset already on the device, :func:`predict_resident` and
:func:`score_resident` run the plain path in contiguous batches (JAX
scans them), and :func:`sample_posterior_continua` draws continua from
the latent posterior of selected spectra.
"""

from __future__ import annotations

import os
from typing import Iterator, Sequence

import numpy as np
import torch

from ..data.batch import SpectraBatch
from ..data.grid import WavelengthGrid
from ..data.loader import SpectraDataset
from ..models.params import QFAParams
from ..models.qfa import (
    ModelOptions,
    PredictResult,
    absorption,
    batch_nll,
    make_delta,
    predict,
)

Tensor = torch.Tensor

__all__ = [
    "predict_dataset",
    "predict_dataset_fused",
    "predict_resident",
    "score_resident",
    "sample_posterior_continua",
    "write_npz_outputs",
    "write_consolidated_npz",
    "ood_scores",
    "select_ood",
]


def _batched(n: int, batch: int) -> Iterator[tuple[int, int]]:
    for start in range(0, n, batch):
        yield start, min(start + batch, n)


def _host(result) -> PredictResult:
    return PredictResult(*(t.cpu().numpy() for t in result))


def predict_dataset(
    params: QFAParams,
    mu: Tensor,
    dataset: SpectraDataset,
    grid: WavelengthGrid,
    *,
    batch_size: int = 1024,
    options: ModelOptions = ModelOptions(),
) -> PredictResult:
    """Predict continua for a whole dataset in batches of ``batch_size`` on
    the parameters' device through the plain path. Returns stacked
    host-side (numpy) results for all ``N`` spectra."""
    dev = params.F.device
    n = dataset.size
    zabs_all = grid.zabs(dataset.zqso).astype(np.float32)
    flux_all = np.ascontiguousarray(dataset.flux, np.float32)
    error_all = np.ascontiguousarray(dataset.error, np.float32)
    mask_all = np.ascontiguousarray(dataset.mask, np.float32)
    outs: list[PredictResult] = []
    from ..utils.progress import progress

    for start, end in progress(
        list(_batched(n, batch_size)), desc="predict", min_items=64
    ):
        def prep(x: np.ndarray) -> Tensor:
            return torch.from_numpy(x[start:end]).to(dev)

        res = predict(
            params, mu, prep(flux_all), prep(error_all), prep(zabs_all),
            prep(mask_all), options,
        )
        outs.append(_host(res))
    return PredictResult(
        *(np.concatenate([getattr(o, f) for o in outs])
          for f in PredictResult._fields)
    )


def predict_dataset_fused(
    params: QFAParams,
    mu: Tensor,
    dataset: SpectraDataset,
    grid: WavelengthGrid,
    *,
    chunk: int = 8192,
    options: ModelOptions = ModelOptions(),
    mesh=None,
    tile_batch: int | None = None,
) -> PredictResult | None:
    """Predict a host dataset through the fused prediction kernel, one
    launch per ``chunk`` spectra on the parameters' device (the tail chunk
    is just shorter: the kernel needs no divisibility). On CUDA a float32
    chunk of at least ``ops.infer_kernel.TC_MIN_ROWS`` spectra runs
    ``csrc/predict_tc.cu``; a shorter tail chunk, or a rank's share of a
    chunk on a mesh, runs ``csrc/predict.cu``, whose outputs differ from
    the other body's in the last bits.

    The absorber redshifts ship as the (N, 2) zq column (rebuilt
    in-kernel), and the mask plane is left out when the dataset is
    error-sanitized (masked pixels carry ``error == 0``; the loader
    guarantees this). Returns host-side stacked results for all ``N``
    spectra.

    ``mesh`` (a ``parallel.DataMesh``) splits every chunk over the ranks,
    one launch per rank and chunk, no collective but the gather of the
    results to rank 0 (``parallel.fused_predict_dp``): chunks are padded
    with zero rows to a multiple of ``tile_batch * size`` (``tile_batch``
    default ``parallel.infer_dp.DEFAULT_TILE``), ``params`` and ``mu``
    lie on the mesh's device, and rank 0 returns the results, the other
    ranks None.
    """
    from ..ops.common import loglam_row, zq_column
    from ..ops.infer_kernel import fused_predict

    if mesh is not None:
        from ..parallel.infer_dp import DEFAULT_TILE, fused_predict_dp

        unit = (tile_batch or DEFAULT_TILE) * mesh.size
        chunk = max(unit, chunk - chunk % unit)
    dev = params.F.device
    n = dataset.size
    flux_all = np.ascontiguousarray(dataset.flux, np.float32)
    error_all = np.ascontiguousarray(dataset.error, np.float32)
    derive_m = bool(np.all((dataset.error > 0.0) == dataset.mask))
    # the (N, Npix) mask plane only materializes when it must ship
    mask_all = (
        None if derive_m else np.ascontiguousarray(dataset.mask, np.float32)
    )
    zq_all = zq_column(torch.from_numpy(np.asarray(dataset.zqso,
                                                   np.float32))).numpy()
    loglam = loglam_row(grid.wav, device=dev)
    outs = []
    from ..utils.progress import progress

    for start, end in progress(
        list(_batched(n, chunk)), desc="predict (fused)", min_items=64
    ):
        if mesh is not None:
            b = end - start
            pad = -b % unit

            def rows(x):  # the chunk, zero rows up to the unit
                x = x[start:end]
                return np.concatenate(
                    [x, np.zeros((pad,) + x.shape[1:], x.dtype)]) \
                    if pad else x

            res = fused_predict_dp(
                params, mu, rows(flux_all), rows(error_all), rows(zq_all),
                None if mask_all is None else rows(mask_all), mesh=mesh,
                tau_which=options.tau_which, tile_batch=tile_batch,
                loglam=loglam, derive_zabs=True)
            if res is not None:
                outs.append(_host(tuple(x[:b] for x in res[:5])))
            continue

        def prep(x):
            return None if x is None else torch.from_numpy(x[start:end]).to(dev)

        res = fused_predict(
            params, mu, prep(flux_all), prep(error_all), prep(zq_all),
            prep(mask_all), tau_which=options.tau_which, loglam=loglam,
            derive_zabs=True,
        )
        outs.append(_host(res[:5]))
    if not outs and mesh is not None and n:
        return None  # not rank 0
    return PredictResult(
        *(np.concatenate([getattr(o, f) for o in outs])
          for f in PredictResult._fields)
    )


def _check_batches(n: int, batch_size: int) -> None:
    if n % batch_size:
        raise ValueError(f"N={n} must be a multiple of batch_size={batch_size}")


@torch.no_grad()
def predict_resident(
    params: QFAParams,
    mu: Tensor,
    flux: Tensor,
    error: Tensor,
    zabs: Tensor,
    mask: Tensor,
    *,
    batch_size: int = 4096,
    options: ModelOptions = ModelOptions(),
) -> PredictResult:
    """Prediction over a device-resident dataset: the plain
    :func:`~qfa_tpu_torch.models.qfa.predict` over contiguous batches of
    ``batch_size`` rows, every result on the tensors' device (use
    :func:`predict_dataset` for host datasets and per-file output). ``N``
    must be a multiple of ``batch_size`` (pad with masked rows
    otherwise). ``zabs`` is the (N, Nb) plane."""
    n, npix = flux.shape
    _check_batches(n, batch_size)
    nh = params.F.shape[1]
    f32 = dict(dtype=torch.float32, device=flux.device)
    out = PredictResult(
        ll=torch.empty((n,), **f32), hmean=torch.empty((n, nh), **f32),
        hcov=torch.empty((n, nh, nh), **f32),
        continuum=torch.empty((n, npix), **f32),
        continuum_std=torch.empty((n, npix), **f32))
    for start in range(0, n, batch_size):
        rows = slice(start, start + batch_size)
        res = predict(params, mu, flux[rows], error[rows], zabs[rows],
                      mask[rows], options)
        for dst, src in zip(out, res):
            dst[rows] = src
    return out


@torch.no_grad()
def score_resident(
    params: QFAParams,
    mu: Tensor,
    flux: Tensor,
    error: Tensor,
    zabs: Tensor,
    mask: Tensor,
    *,
    batch_size: int = 8192,
    options: ModelOptions = ModelOptions(),
) -> Tensor:
    """OOD scores only (per-spectrum NLL, (N,)) over a resident dataset:
    the likelihood of each contiguous batch of ``batch_size`` rows, and
    none of :func:`predict_resident`'s continuum and uncertainty planes.
    ``N`` must be a multiple of ``batch_size``."""
    n = flux.shape[0]
    _check_batches(n, batch_size)
    nr = flux.shape[-1] - zabs.shape[-1]
    ll = torch.empty((n,), dtype=torch.float32, device=flux.device)
    for start in range(0, n, batch_size):
        rows = slice(start, start + batch_size)
        amp = absorption(zabs[rows], nr, options.tau_which)
        batch = SpectraBatch(
            delta=make_delta(flux[rows], mu, amp, mask[rows]),
            error=error[rows],
            zabs=zabs[rows],
            mask=mask[rows],
            weight=flux.new_ones(flux[rows].shape[:-1]),
        )
        ll[rows] = batch_nll(params, batch, options)
    return ll


@torch.no_grad()
def _continua_from_draws(params: QFAParams, mu: Tensor, hmean: Tensor,
                         hcov: Tensor, eps: Tensor) -> Tensor:
    """``F (hmean + L eps) + mu`` with ``L L^T = hcov``: eps (S, B, Nh)
    standard normal draws give (S, B, Npix) continua."""
    chol = torch.linalg.cholesky_ex(hcov).L  # (B, Nh, Nh)
    h = hmean + torch.einsum("bij,sbj->sbi", chol, eps)
    return torch.einsum("sbh,ph->sbp", h, params.F) + mu


def sample_posterior_continua(
    params: QFAParams,
    mu: Tensor,
    result: PredictResult,
    generator: torch.Generator,
    n_samples: int,
) -> Tensor:
    """Draw continuum realizations from the latent posterior:
    ``h ~ N(hmean, hcov)`` per spectrum, mapped through ``F h + mu``.
    ``result`` holds tensors or arrays (:func:`predict_dataset`'s); the
    draws come from ``generator``, on the parameters' device. Returns
    shape ``(n_samples, B, Npix)``."""
    dev = params.F.device
    hmean = torch.as_tensor(result.hmean, device=dev)
    hcov = torch.as_tensor(result.hcov, device=dev)
    eps = torch.randn((n_samples,) + tuple(hmean.shape), generator=generator,
                      dtype=hmean.dtype, device=dev)
    return _continua_from_draws(params, mu, hmean, hcov, eps)


def write_npz_outputs(
    result: PredictResult,
    paths: Sequence[str],
    output_dir: str,
) -> None:
    """Write one npz per spectrum in the reference output schema
    (keys ``ll, hmean, hcov, cont, uncertainty``)."""
    from ..utils.progress import progress

    os.makedirs(output_dir, exist_ok=True)
    for i, p in progress(
        list(enumerate(paths)), desc="writing predictions", total=len(paths)
    ):
        name = os.path.basename(str(p))
        np.savez(
            os.path.join(output_dir, name),
            ll=np.float32(result.ll[i]),
            hmean=np.asarray(result.hmean[i], np.float32)[:, None],
            hcov=np.asarray(result.hcov[i], np.float32),
            cont=np.asarray(result.continuum[i], np.float32),
            uncertainty=np.asarray(result.continuum_std[i], np.float32),
        )


def write_consolidated_npz(
    result: PredictResult,
    paths: Sequence[str],
    out_path: str,
) -> None:
    """Write ALL predictions into one npz: the per-spectrum keys stacked
    along axis 0 (``hmean`` keeps the reference's ``(nh, 1)`` column shape
    per spectrum) plus the source ``paths``."""
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(
        out_path,
        ll=np.asarray(result.ll, np.float32),
        hmean=np.asarray(result.hmean, np.float32)[..., None],
        hcov=np.asarray(result.hcov, np.float32),
        cont=np.asarray(result.continuum, np.float32),
        uncertainty=np.asarray(result.continuum_std, np.float32),
        paths=np.asarray([os.path.basename(str(p)) for p in paths]),
    )


def ood_scores(result: PredictResult, n_obs: np.ndarray | None = None
               ) -> np.ndarray:
    """Out-of-distribution score per spectrum: the marginal NLL, optionally
    normalized per observed pixel so spectra with different masking are
    comparable."""
    ll = np.asarray(result.ll)
    if n_obs is None:
        return ll
    return ll / np.maximum(np.asarray(n_obs), 1.0)


def select_ood(
    result: PredictResult,
    *,
    top_k: int | None = None,
    quantile: float | None = None,
    n_obs: np.ndarray | None = None,
) -> np.ndarray:
    """Indices of the most anomalous spectra: ranked by (per-pixel
    normalized) NLL, descending; the ``top_k`` first, or everything at or
    above the score ``quantile``."""
    scores = ood_scores(result, n_obs)
    order = np.argsort(-scores)
    if top_k is not None:
        return order[:top_k]
    if quantile is not None:
        cut = np.quantile(scores, quantile)
        return order[: int(np.sum(scores >= cut))]
    return order
