"""Build the CUDA sources under ``csrc/`` with nvcc and bind them with ctypes.

The kernels have a plain C interface (no PyTorch headers). Each source is
compiled by its own nvcc process, all started together, and the objects
are linked into one shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.cu.o csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o libqfa_kernels.so *.cu.o

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

__all__ = ["NVCC_FLAGS", "build_library", "build_log", "device_and_stream",
           "load_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libqfa_kernels.so"

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
#: flags of each source's compile step
NVCC_FLAGS = (
    *_ARCH,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # register / shared-memory / spill report, kept in build.log
    "-Xptxas", "-v",
)
_LINK_FLAGS = (*_ARCH, "-shared")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong

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
    "qfa_predict_occupancy": (
        [_I, _I, _I, _I, _P, _P],  # nh, derive_mask, derive_zabs, device,
        # smem bytes, blocks per SM (int outputs)
        ctypes.c_int,
    ),
    "qfa_train_epoch": (
        [
            _P, _P, _I,  # delta, error, planes_bf16
            _P, _I,  # zabs, zabs_ld
            _P, _P, _P,  # mask, loglam, perm
            _I, _I, _I, _I, _I,  # n_tiles, tile_batch, tiles_per_batch,
            # n_batches, n_epochs
            _I, _I, _I,  # npix, nb, nh
            _I, _I, _I,  # derive_mask, derive_zabs, mxu_bf16
            _P, _P, _P, _P, _P,  # F, psi, omega, mF, vF (in place)
            _P, _P, _P, _P, _P,  # mpsi, vpsi, momega, vomega, scal
            _P, _P,  # hp, sched (host float32 arrays)
            _P, _P, _P,  # S, alpha, rowstat (scratch)
            _P, _L,  # fpart, its length (scratch)
            _P, _P, _P, _I,  # partials, srows, counters, their count
            # (scratch)
            _P, _P,  # loss_out, nreal_out
            _I, _I,  # n_chunks, early
            _I, _P,  # device, stream
        ],
        ctypes.c_int,
    ),
    "qfa_train_epoch_fpart_len": ([_I, _I, _I], ctypes.c_longlong),
    "qfa_train_epoch_n_counters": ([_I, _I], ctypes.c_int),
    "qfa_step_f32": (
        [
            _P, _P, _P, _I,  # delta, error, zabs, zabs_ld
            _P, _P,  # mask, weight
            _P, _P, _P,  # F, psi, omega
            _P, _P, _P,  # tau0, c0, beta (device scalars)
            _F, _F, _F,  # law_a, law_b, law_c
            _I, _I, _I, _I,  # batch_rows, npix, nb, nh
            _P, _L, _P, _I,  # scratch, its length, counters, their count
            _P,  # out: gF, gpsi, counts, gomega, the five scalars
            _I, _I, _P,  # early, device, stream
        ],
        ctypes.c_int,
    ),
    "qfa_step_scratch_len": ([_I, _I, _I], ctypes.c_longlong),
    "qfa_step_n_counters": ([_I], ctypes.c_int),
    "qfa_alu_chain_f32": (
        [_P, _P, _I, _I, _I,  # x, out, n, n_iters, op
         _I, _P],  # device, stream
        ctypes.c_int,
    ),
    "qfa_kdepth_f32": (
        [
            _P, _P, _P, _P, _P,  # l, lt, r, r2, out
            _P, _L,  # partials, their length (scratch)
            _I, _I, _I,  # kmax, tb, p
            _I, _I, _I, _I, _I,  # k1, k2, mode, grid, chunks
            _I, _P,  # device, stream
        ],
        ctypes.c_int,
    ),
    "qfa_kdepth_chunks": (
        [_I, _I, _I, _I, _I, _I,  # tb, p, k1, k2, mode, grid
         _I, _P],  # device, chunks (int output)
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


def _run_together(cmds: list[list[str]]) -> str:
    """Run the commands at once; return their joined output, or raise
    with the first failure's command and output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}"
                               f":\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build_library() -> Path:
    """Compile ``csrc/*.cu`` (one nvcc per source, all at once) and link
    the shared library, unless the build for these exact sources exists;
    return its path. Raises with nvcc's output if a step fails."""
    out_dir = _build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(prefix=".tmp-", dir=out_dir) as tmp:
        objs = [os.path.join(tmp, f"{s.name}.o") for s in srcs]
        tmp_lib = os.path.join(tmp, LIB_NAME)
        log = _run_together([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
                             for s, o in zip(srcs, objs)])
        log += _run_together([[nvcc, *_LINK_FLAGS, "-o", tmp_lib, *objs]])
        (out_dir / "build.log").write_text(log)
        os.replace(tmp_lib, lib)
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
    if _LIB is not None:  # bound already: no lock after the first call
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIB = lib
        return _LIB


def device_and_stream(dev) -> tuple[int, int]:
    """(device index, raw handle of its current stream) of a CUDA device,
    as the entry points take them. The handle comes straight from torch's
    C binding: ``torch.cuda.current_stream(dev)`` builds a ``Stream``
    object, ~3.3 us of host time per call against ~0.4 on an H100's host
    (``step_variants.py``)."""
    import torch

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch._C._cuda_getCurrentRawStream(index)
