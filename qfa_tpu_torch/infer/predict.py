"""Batch inference pipeline: continuum prediction and OOD scoring at scale.

Prediction runs over a host dataset in fixed-size chunks on a torch
device; outputs come back to the host and are written per spectrum in the
reference npz schema (``ll, hmean, hcov, cont, uncertainty``), or into one
consolidated file. Two engines, as in ``qfa_tpu.infer.predict``:

* :func:`predict_dataset` — the plain batched path (``models.qfa.predict``);
* :func:`predict_dataset_fused` — the fused prediction kernel
  (``ops.infer_kernel.fused_predict``): on a CUDA device the hand-written
  kernel, one launch per chunk.
"""

from __future__ import annotations

import os
from typing import Iterator, Sequence

import numpy as np
import torch

from ..data.grid import WavelengthGrid
from ..data.loader import SpectraDataset
from ..models.params import QFAParams
from ..models.qfa import ModelOptions, PredictResult, predict

Tensor = torch.Tensor

__all__ = [
    "predict_dataset",
    "predict_dataset_fused",
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
) -> PredictResult:
    """Predict a host dataset through the fused prediction kernel, one
    launch per ``chunk`` spectra on the parameters' device (the tail chunk
    is just shorter: the kernel needs no divisibility).

    The absorber redshifts ship as the (N, 2) zq column (rebuilt
    in-kernel), and the mask plane is left out when the dataset is
    error-sanitized (masked pixels carry ``error == 0``; the loader
    guarantees this). Returns host-side stacked results for all ``N``
    spectra.
    """
    from ..ops.common import loglam_row, zq_column
    from ..ops.infer_kernel import fused_predict

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
        def prep(x):
            return None if x is None else torch.from_numpy(x[start:end]).to(dev)

        res = fused_predict(
            params, mu, prep(flux_all), prep(error_all), prep(zq_all),
            prep(mask_all), tau_which=options.tau_which, loglam=loglam,
            derive_zabs=True,
        )
        outs.append(_host(res[:5]))
    return PredictResult(
        *(np.concatenate([getattr(o, f) for o in outs])
          for f in PredictResult._fields)
    )


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
