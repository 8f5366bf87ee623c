"""Build the CUDA sources under ``csrc/`` with nvcc and bind them with ctypes.

The kernels have a plain C interface (no PyTorch headers), so one nvcc
call builds them in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o libqfa_kernels.so csrc/*.cu

The library is built at first use into ``_build/<hash of the sources and
flags>/`` inside the package (listed in ``.gitignore``), written under a
temporary name and moved into place with ``os.replace``, so concurrent
first uses never load half a library. Nothing is fetched and no other
package's kernels are used. ``-use_fast_math`` is deliberately absent.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_library", "build_log", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libqfa_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # register / shared-memory / spill report, kept in build.log
    "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: ctypes signatures of the library's C entry points: (argtypes, restype).
#: Every pointer and the stream are c_void_p, so ctypes never truncates
#: a 64-bit address to a C int.
SIGNATURES = {
    "qfa_predict_f32": (
        [
            _P, _P, _P, _I, _P,  # flux, error, zabs, zabs_ld, mask
            _P, _P, _P, _P, _P,  # mu, F, psi, omega, loglam
            _P, _P, _P,  # tau0, c0, beta (device scalars)
            _F, _F, _F,  # law_a, law_b, law_c
            _I, _I, _I, _I,  # n, npix, nb, nh
            _I, _I,  # derive_mask, derive_zabs
            _P, _P, _P, _P, _P, _P,  # ll, n_obs, hmean, hcov, cont, std
            _I, _P,  # device, stream
        ],
        ctypes.c_int,
    ),
    "qfa_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates.append(shutil.which("nvcc") or "")
    # the CUDA toolkit's default install prefix
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and the CUDA "
        "toolkit's default prefix); the CUDA kernels are built from "
        "qfa_tpu_torch/csrc at first use and need the toolkit"
    )


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless the build for
    these exact sources exists; return its path. Raises with nvcc's output
    if the build fails."""
    out_dir = _build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".tmp-", suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(str(s) for s in sorted(CSRC.glob("*.cu")))]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build_log() -> str:
    """nvcc's output (ptxas register and spill report) of the current
    build, or '' when the library has not been built."""
    path = _build_dir() / "build.log"
    return path.read_text() if path.exists() else ""


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, with every entry
    point's ``argtypes`` and ``restype`` set."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIB = lib
        return _LIB
