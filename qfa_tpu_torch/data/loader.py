"""Data layer: spectrum files -> host arrays with masks -> training tensors.

npz spectra (keys ``flux, error, z``) are read concurrently by a thread
pool (``np.load`` is I/O-bound) into fixed (N, Npix) buffers; missing
pixels (sentinel ``-999.``) become ``mask = 0`` with flux and error
sanitized to 0, so the kernels can derive the mask as ``error > 0``.

The training half selects spectra from a catalog (snr / z / num_mask
cuts, sampling with replacement when too few survive), estimates the mean
continuum mu and computes the residual field ``delta = flux - mu A`` once
for the whole dataset, on the training device, with the epoch's batch
indices (:func:`batch_indices`, :func:`epoch_indices`, drawn from a
``torch.Generator`` or given as a permutation) and
:meth:`ResidualDataset.gather`. Same semantics as
``qfa_tpu.data.loader``; catalogs are read with the ``csv`` module (no
pandas). :func:`read_spectra` reads through the C++ thread-pool reader
(``qfa_tpu_torch.native``) when it builds, else through the Python pool.
"""

from __future__ import annotations

import csv
import logging
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..physics.smoothing import smooth_curve
from ..physics.tau import tau_total
from .batch import SpectraBatch
from .grid import WavelengthGrid

Tensor = torch.Tensor

__all__ = [
    "MISSING",
    "SpectraDataset",
    "read_spectrum",
    "read_spectra",
    "read_predict_catalog",
    "select_from_catalog",
    "validation_concat_paths",
    "compute_taus",
    "estimate_mu",
    "ResidualDataset",
    "as_f32",
    "bf16_planes",
    "make_residuals",
    "batch_indices",
    "EpochIndices",
    "epoch_indices",
]

MISSING = -999.0

_FALLBACK_LOGGED = False  #: the auto engine's fallback warned once


def read_spectrum(
    path: str,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, float, np.ndarray]:
    """Load one spectrum npz (keys ``flux, error, z``) and derive its mask.

    Missing pixels carry the ``-999.`` sentinel in flux or error; they are
    masked and sanitized to 0. The raw ``flux != -999`` indicator
    (``flux_ok``) is kept for the reference's mu-estimate denominator.
    """
    with np.load(path) as f:
        flux = np.asarray(f["flux"], np.float32)
        error = np.asarray(f["error"], np.float32)
        z = float(f["z"])
    flux_ok = flux != MISSING
    mask = flux_ok & (error != MISSING)
    flux = np.where(mask, flux, 0.0).astype(np.float32)
    error = np.where(mask, error, 0.0).astype(np.float32)
    return flux, error, mask, z, flux_ok


def read_spectra(
    paths: Sequence[str], max_workers: int = 16, engine: str = "auto"
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Read many spectra concurrently into stacked arrays.

    Returns (flux, error, mask, zqso, flux_ok) with shapes (N, Npix) x3,
    (N,), (N, Npix).

    ``engine``: ``"native"`` reads through the C++ thread-pool reader
    (``qfa_tpu_torch.native``, built at first use; raises if it cannot be
    built), ``"python"`` through a ``ThreadPoolExecutor`` of ``np.load``,
    and ``"auto"`` through the native reader when it builds, else through
    the Python pool, logging the compiler's message once. Both give
    bitwise equal arrays. Npix is the first file's flux length; the
    native reader refuses files of another length, as the Python pool
    fails to stack them.
    """
    if engine not in ("auto", "native", "python"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine in ("auto", "native") and len(paths):
        from .. import native

        if native.native_available():
            with np.load(paths[0]) as probe:
                npix = int(probe["flux"].shape[0])
            return native.read_spectra_native(paths, npix, max_workers)
        if engine == "native":
            raise RuntimeError(
                f"native reader requested but unavailable: "
                f"{native.build_error()}")
        global _FALLBACK_LOGGED
        if not _FALLBACK_LOGGED:
            _FALLBACK_LOGGED = True
            logging.getLogger(__name__).warning(
                "native npz reader unavailable, reading with the Python "
                "pool: %s", native.build_error())
    from ..utils.progress import progress

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        rows = list(
            progress(
                pool.map(read_spectrum, paths),
                desc="reading spectra",
                total=len(paths),
            )
        )
    flux = np.stack([r[0] for r in rows])
    error = np.stack([r[1] for r in rows])
    mask = np.stack([r[2] for r in rows])
    z = np.array([r[3] for r in rows], np.float32)
    flux_ok = np.stack([r[4] for r in rows])
    return flux, error, mask, z, flux_ok


def _catalog_rows(catalog: str) -> list[str]:
    """The single column of a headerless csv file list, blank lines
    skipped (what ``pd.read_csv(catalog, header=None)`` keeps)."""
    with open(catalog, newline="") as fh:
        rows = [r for r in csv.reader(fh) if r and any(r)]
    if not rows:
        raise ValueError(f"predict catalog {catalog!r} is empty")
    if any(len(r) != 1 for r in rows):
        raise ValueError(
            f"predict catalog {catalog!r} must hold one column (a file per "
            "line)"
        )
    return [r[0] for r in rows]


def read_predict_catalog(catalog: str, data_dir: str) -> list[str]:
    """Read a predict-mode catalog (plain file list) into spectrum paths,
    sniffing an accidental header row.

    Every row is kept; but if the first row's resolved path does not exist
    while some later row's does, AND the row does not look like a filename
    (no dot-suffix in its basename and no path separator — header tokens
    are words like ``file`` or ``spec_path``), it is a header, dropped with
    a warning. A missing but path-like first row raises instead: silently
    dropping a real spectrum would misalign every output against the
    catalog. The same rule as ``qfa_tpu.data.loader.read_predict_catalog``.
    """
    files = _catalog_rows(catalog)
    paths = [os.path.join(data_dir, f) for f in files]
    if (
        len(paths) > 1
        and not os.path.exists(paths[0])
        and any(os.path.exists(p) for p in paths[1:])
    ):
        first = files[0]
        if "." in os.path.basename(first) or "/" in first or os.sep in first:
            raise FileNotFoundError(
                f"predict catalog {catalog!r}: first row {first!r} "
                "looks like a spectrum file but does not exist (later "
                "rows do) — refusing to sniff it away as a header line; "
                "fix the path or remove the row"
            )
        warnings.warn(
            f"predict catalog {catalog!r}: first row {first!r} is not "
            "an existing spectrum file but later rows are — treating it "
            "as a header line and skipping it",
            stacklevel=2,
        )
        paths = paths[1:]
    return paths


class SpectraDataset(NamedTuple):
    """Host-side dataset of observed spectra on the common grid."""

    flux: np.ndarray  #: (N, Npix) float32, 0 where masked.
    error: np.ndarray  #: (N, Npix) float32, 0 where masked.
    mask: np.ndarray  #: (N, Npix) bool.
    zqso: np.ndarray  #: (N,) float32.
    paths: tuple  #: file names (may be empty for synthetic data).
    flux_ok: np.ndarray | None = None  #: (N, Npix) bool, raw flux != -999.

    @property
    def size(self) -> int:
        return self.flux.shape[0]

    @property
    def npix(self) -> int:
        return self.flux.shape[1]

    @classmethod
    def from_paths(cls, paths: Sequence[str], max_workers: int = 16
                   ) -> "SpectraDataset":
        flux, error, mask, z, flux_ok = read_spectra(paths, max_workers)
        return cls(flux=flux, error=error, mask=mask, zqso=z,
                   paths=tuple(paths), flux_ok=flux_ok)


def _read_catalog_table(catalog_csv: str) -> dict[str, list[str]]:
    """Columns of a catalog csv with a header row, as lists of strings."""
    with open(catalog_csv, newline="") as fh:
        reader = csv.DictReader(fh)
        cols: dict[str, list[str]] = {k: [] for k in reader.fieldnames or ()}
        for row in reader:
            for k in cols:
                cols[k].append(row[k])
    missing = {"file", "snr", "z", "num_mask"} - set(cols)
    if missing:
        raise ValueError(
            f"catalog {catalog_csv!r} lacks the columns {sorted(missing)} "
            "(it needs file, snr, z, num_mask)"
        )
    return cols


def select_from_catalog(
    catalog_csv: str,
    data_dir: str,
    num: int,
    *,
    snr_min: float = 2.0,
    snr_max: float = 100.0,
    z_min: float = 2.0,
    z_max: float = 3.5,
    num_mask: int = 0,
    seed: int | None = None,
    output_dir: str | None = None,
    prefix: str = "train",
) -> list[str]:
    """Filter a catalog CSV and sample ``num`` file paths.

    The catalog provides columns ``file, snr, z, num_mask``. Sampling is
    with replacement when fewer than ``num`` rows survive the cut, by
    ``np.random.default_rng(seed).choice`` as in the JAX package, so both
    pick the same files. With ``output_dir`` the chosen file list is
    written to ``{prefix}-catalog.csv`` (one name per line, no header).
    """
    cols = _read_catalog_table(catalog_csv)
    snr = np.array(cols["snr"], np.float64)
    z = np.array(cols["z"], np.float64)
    nmask = np.array(cols["num_mask"], np.float64)
    sel = ((snr >= snr_min) & (snr <= snr_max) & (z >= z_min) & (z <= z_max)
           & (nmask <= num_mask))
    pool = np.array(cols["file"], dtype=object)[sel]
    if len(pool) == 0:
        raise ValueError("catalog selection is empty — relax the cuts")
    rng = np.random.default_rng(seed)
    files = rng.choice(pool, size=num, replace=len(pool) < num)
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        out = os.path.join(output_dir, f"{prefix}-catalog.csv")
        with open(out, "w", newline="") as fh:
            writer = csv.writer(fh, lineterminator="\n")
            for f in files:
                writer.writerow([f])
    return [os.path.join(data_dir, str(f)) for f in files]


def validation_concat_paths(
    data_cfg, seed: int, *, output_dir: str | None = None
) -> list[str] | None:
    """Training-set composition under ``DATA.VALIDATION_CONCAT_COMPAT``:
    the validation paths to concatenate into the training list, or
    ``None`` when the flag is off.

    The reference loader concatenates the validation spectra into the
    training arrays before mu estimation. A missing validation catalog or
    directory under the flag raises instead of silently falling back to
    the held-out composition; the flag without ``DATA.VALIDATION`` is a
    contradictory config and raises too (the JAX package's rules).
    """
    if not getattr(data_cfg, "VALIDATION_CONCAT_COMPAT", False):
        return None
    if not getattr(data_cfg, "VALIDATION", False):
        raise ValueError(
            "DATA.VALIDATION_CONCAT_COMPAT requires DATA.VALIDATION: the "
            "reference gates the concat on DATA.VALIDATION; enable both, "
            "or drop the compat flag for the held-out composition"
        )
    for what, path in (("catalog", data_cfg.VALIDATION_CATALOG),
                       ("directory", data_cfg.VALIDATION_DIR)):
        if not path or not os.path.exists(path):
            raise FileNotFoundError(
                "DATA.VALIDATION_CONCAT_COMPAT is on but the validation "
                f"{what} {path!r} does not exist — refusing to silently "
                "fall back to the held-out composition"
            )
    return list(select_from_catalog(
        data_cfg.VALIDATION_CATALOG,
        data_cfg.VALIDATION_DIR,
        data_cfg.VALIDATION_NUM,
        snr_min=data_cfg.SNR_MIN,
        snr_max=data_cfg.SNR_MAX,
        z_min=data_cfg.Z_MIN,
        z_max=data_cfg.Z_MAX,
        num_mask=data_cfg.NUM_MASK,
        seed=seed + 1,
        output_dir=output_dir,
        prefix="validation",
    ))


def compute_taus(
    grid: WavelengthGrid,
    zqso: np.ndarray,
    *,
    tau_which: str = "becker",
    chunk: int = 32768,
    device=None,
) -> np.ndarray:
    """``tau_total`` over the blue grid for every spectrum, (N, Nb)
    float32 on the host, computed in float32 on ``device`` in ``chunk``-row
    pieces (the device never holds more than one chunk of temporaries)."""
    n = len(zqso)
    out = np.empty((n, grid.nb), np.float32)
    for s in range(0, n, chunk):
        z = torch.as_tensor(np.asarray(zqso[s : s + chunk], np.float32),
                            device=device)
        out[s : s + len(z)] = tau_total(grid.wav, z,
                                        which=tau_which).cpu().numpy()
    return out


def estimate_mu(
    dataset: SpectraDataset,
    grid: WavelengthGrid,
    *,
    tau_which: str = "becker",
    window: int = 16,
    compat_denominator: bool = True,
    taus: np.ndarray | None = None,
) -> np.ndarray:
    """Data-driven mean continuum (host numpy, float32 result).

    Each spectrum is de-absorbed on the blue side (``flux exp(+tau)``) and
    the per-pixel masked average is smoothed (:func:`smooth_curve`).
    ``compat_denominator=True`` divides by the reference's count of raw
    non-sentinel *flux* values (``flux_ok``), which includes pixels masked
    only through ``error``; ``False`` by the mask count. Pixels observed
    nowhere give 0.
    """
    if taus is None:
        taus = compute_taus(grid, dataset.zqso, tau_which=tau_which)
    deabsorb = np.concatenate(
        [np.exp(taus), np.ones((dataset.size, grid.nr), np.float32)], axis=1
    )
    num = np.sum(dataset.flux * deabsorb * dataset.mask, axis=0)
    if compat_denominator:
        if dataset.flux_ok is not None:
            den = np.sum(dataset.flux_ok, axis=0).astype(np.float64)
        else:
            # without the raw indicator (synthetic data) flux == 0 means
            # masked in the sanitized buffers
            den = np.sum(dataset.flux != 0.0, axis=0).astype(np.float64)
    else:
        den = np.sum(dataset.mask, axis=0).astype(np.float64)
    mu = np.where(den > 0, num / np.maximum(den, 1.0), 0.0)
    return smooth_curve(mu, window_len=window).astype(np.float32)


class ResidualDataset(NamedTuple):
    """Training tensors on the device: everything the likelihood needs.

    ``zabs`` is the (N, Nb) absorber-redshift plane, or the (N, 2) zq
    column of the derived layout; ``mask`` may be None when the kernels
    derive it from ``error > 0``.
    """

    delta: Tensor  #: (N, Npix)
    error: Tensor  #: (N, Npix)
    zabs: Tensor  #: (N, Nb) plane or (N, 2) zq column
    mask: Tensor | None  #: (N, Npix) float32, or None

    @property
    def size(self) -> int:
        return self.delta.shape[0]

    def gather(self, idx, weight=None) -> SpectraBatch:
        """Assemble a batch by index gather on the dataset's device.

        ``weight`` (optional, (B,)) marks padding rows with 0: the tail
        batch of an epoch duplicates row 0 on its pad entries, which must
        contribute nothing. bfloat16-stored planes are cast to float32
        (:func:`as_f32`). Needs the mask plane.
        """
        dev = self.delta.device
        idx = torch.as_tensor(idx, dtype=torch.long, device=dev)
        return SpectraBatch(
            delta=as_f32(self.delta[idx]),
            error=as_f32(self.error[idx]),
            zabs=as_f32(self.zabs[idx]),
            mask=self.mask[idx],
            weight=torch.ones(idx.shape, dtype=torch.float32, device=dev)
            if weight is None
            else torch.as_tensor(weight, dtype=torch.float32, device=dev),
        )


def as_f32(x: Tensor | None) -> Tensor | None:
    """Promote bfloat16-stored planes back to float32 (no-op otherwise)."""
    if x is None or x.dtype != torch.bfloat16:
        return x
    return x.to(torch.float32)


def bf16_planes(data: ResidualDataset) -> ResidualDataset:
    """Store the delta and error planes in bfloat16 (half their bytes);
    arithmetic stays float32. The epoch kernel and its plain version both
    take them and convert them at load."""
    cast = lambda x: None if x is None else x.to(torch.bfloat16)  # noqa: E731
    return data._replace(delta=cast(data.delta), error=cast(data.error))


def make_residuals(
    dataset: SpectraDataset,
    grid: WavelengthGrid,
    mu: np.ndarray,
    *,
    tau_which: str = "becker",
    device=None,
    taus: np.ndarray | None = None,
) -> ResidualDataset:
    """The training residual field for the whole dataset at once, on
    ``device``: ``delta = flux - mu exp(-tau_total)`` on the blue side,
    ``flux - mu`` on the red side, masked pixels zeroed; plus the error
    plane, the zabs plane and the float mask. ``taus`` reuses a
    :func:`compute_taus` result."""
    if taus is None:
        taus = compute_taus(grid, dataset.zqso, tau_which=tau_which)
    absorb = np.concatenate(
        [np.exp(-taus), np.ones((dataset.size, grid.nr), np.float32)], axis=1
    ).astype(np.float32)
    mask = dataset.mask.astype(np.float32)
    delta = (dataset.flux - np.asarray(mu, np.float32) * absorb) * mask
    zabs = grid.zabs(dataset.zqso).astype(np.float32)

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    return ResidualDataset(delta=put(delta), error=put(dataset.error),
                           zabs=put(zabs), mask=put(mask))


def _permutation(generator: torch.Generator | None, n: int, perm) -> Tensor:
    """``perm`` as an int64 CPU tensor (checked to be a permutation of
    ``range(n)``), or a draw from ``generator``."""
    if perm is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or a permutation")
        return torch.randperm(n, generator=generator)
    perm = torch.tensor(np.asarray(perm), dtype=torch.long).reshape(-1)
    if perm.numel() != n or not torch.equal(torch.sort(perm).values,
                                            torch.arange(n)):
        raise ValueError(f"perm is not a permutation of range({n})")
    return perm


def batch_indices(
    generator: torch.Generator | None,
    n: int,
    batch_size: int,
    *,
    drop_remainder: bool = True,
    perm=None,
) -> Tensor:
    """Shuffled epoch index matrix of shape (n_batches, batch_size).

    The rows come from ``torch.randperm(n, generator=generator)``, or from
    ``perm`` (a permutation of ``range(n)`` drawn elsewhere, e.g. the JAX
    package's). The tail that does not fill a batch is dropped; use
    :func:`epoch_indices` to train it too.
    """
    p = _permutation(generator, n, perm)
    n_batches = n // batch_size
    if not drop_remainder and n % batch_size:
        raise NotImplementedError("use epoch_indices for tail-batch epochs")
    return p[: n_batches * batch_size].reshape(n_batches, batch_size)


class EpochIndices(NamedTuple):
    """Shuffled epoch indices covering every spectrum: the tail batch is
    padded to the batch size with weight-0 entries that duplicate row 0."""

    idx: Tensor  #: (n_batches, batch_size) int64 row indices.
    weight: Tensor  #: (n_batches, batch_size) float32, 0 on pad entries.


def epoch_indices(
    generator: torch.Generator | None, n: int, batch_size: int, *, perm=None
) -> EpochIndices:
    """Shuffled full-coverage epoch indices (see :class:`EpochIndices`);
    the permutation as in :func:`batch_indices`."""
    p = _permutation(generator, n, perm)
    n_batches = -(-n // batch_size)
    pad = n_batches * batch_size - n
    idx = torch.cat([p, torch.zeros((pad,), dtype=p.dtype)])
    wt = torch.cat([torch.ones((n,), dtype=torch.float32),
                    torch.zeros((pad,), dtype=torch.float32)])
    return EpochIndices(idx=idx.reshape(n_batches, batch_size),
                        weight=wt.reshape(n_batches, batch_size))
