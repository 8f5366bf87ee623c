"""Data layer, prediction half: spectrum files -> host arrays with masks.

npz spectra (keys ``flux, error, z``) are read concurrently by a thread
pool (``np.load`` is I/O-bound) into fixed (N, Npix) buffers; missing
pixels (sentinel ``-999.``) become ``mask = 0`` with flux and error
sanitized to 0, so the prediction kernel can derive the mask as
``error > 0``. Same semantics as ``qfa_tpu.data.loader``; its C++ reader
and the training half (catalog cuts, mu estimate, residuals) come later.
"""

from __future__ import annotations

import csv
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Sequence

import numpy as np

__all__ = [
    "MISSING",
    "SpectraDataset",
    "read_spectrum",
    "read_spectra",
    "read_predict_catalog",
]

MISSING = -999.0


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
    paths: Sequence[str], max_workers: int = 16
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Read many spectra concurrently into stacked arrays.

    Returns (flux, error, mask, zqso, flux_ok) with shapes (N, Npix) x3,
    (N,), (N, Npix).
    """
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
