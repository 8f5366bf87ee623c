"""The native spectra reader (C++, bound with ctypes).

``npz_reader.cpp`` parses each npz container itself (STORED and DEFLATE
entries, ``<f4``/``<f8`` payloads, npy headers 1.0 and 2.0) on a thread
pool and writes straight into the caller's (N, Npix) buffers; the
contract of ``qfa_tpu.native``, with its own build:

    g++ -O3 -std=c++17 -shared -fPIC -o libqfa_native.so npz_reader.cpp
        <libz> -lpthread

It is compiled at first use into ``_build/native-<hash of the source and
flags>/`` inside the package (listed in ``.gitignore``), under a
temporary name moved into place with ``os.replace``, so concurrent first
builds in separate processes never load a torn library. ``<libz>`` is
the ``libz.so.1`` the interpreter itself has loaded (its ``zlib``
module's); where zlib's headers are absent the source declares the few
entry points it calls. ``READS`` counts the calls that read through the
library, so a caller can tell which engine served a read.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["READS", "native_available", "read_spectra_native",
           "build_error", "build_library"]

_DIR = Path(__file__).resolve().parent
SRC = _DIR / "npz_reader.cpp"
BUILD_ROOT = _DIR.parent / "_build"
LIB_NAME = "libqfa_native.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

#: calls of :func:`read_spectra_native` that read through the library
READS = 0

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None  #: the first build or load failure


def _libz() -> list[str]:
    """Link arguments for the zlib the interpreter has loaded: its file
    when ``/proc/self/maps`` shows it, else the soname, else ``-lz``."""
    import zlib  # noqa: F401  (maps libz into this process)

    try:
        with open("/proc/self/maps") as maps:
            for line in maps:
                path = line.split()[-1]
                if os.path.basename(path).startswith("libz.so"):
                    return [path, f"-Wl,-rpath,{os.path.dirname(path)}"]
    except OSError:
        pass
    name = ctypes.util.find_library("z")
    return [f"-l:{name}"] if name else ["-lz"]


def _build_dir(root: Path, flags: tuple) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(SRC.read_bytes())
    return root / f"native-{h.hexdigest()[:16]}"


def build_library(force: bool = False, build_root=None,
                  defines: tuple = ()) -> str:
    """Compile the reader unless this source and these flags are built
    already (``force`` rebuilds); returns the library's path. Raises
    ``RuntimeError`` with the compiler's output if the build fails.
    ``build_root`` replaces the package's ``_build/``; ``defines`` adds
    ``-D`` flags (``QFA_DECLARE_ZLIB`` builds with the declared zlib entry
    points even where the headers exist)."""
    flags = (*CXX_FLAGS, *(f"-D{d}" for d in defines))
    link = (*_libz(), "-lpthread")
    out_dir = _build_dir(Path(build_root or BUILD_ROOT), flags + link)
    lib = out_dir / LIB_NAME
    if lib.exists() and not force:
        return str(lib)
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".tmp-", suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        cmd = ["g++", *flags, "-o", tmp, str(SRC), *link]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:  # no compiler at all
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed with exit code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{proc.stderr.strip()}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(lib)


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.qfa_read_spectra.restype = ctypes.c_int
    lib.qfa_read_spectra.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),  # paths
        ctypes.c_int,  # n_files
        ctypes.c_int,  # npix
        ctypes.c_void_p,  # flux (float32)
        ctypes.c_void_p,  # error (float32)
        ctypes.c_void_p,  # mask (uint8)
        ctypes.c_void_p,  # flux_ok (uint8)
        ctypes.c_void_p,  # z (float32)
        ctypes.c_int,  # n_threads
        ctypes.c_char_p,  # errbuf
        ctypes.c_int,  # errbuf_len
    ]
    return lib


def _load() -> ctypes.CDLL | None:
    """The bound library, built at first use; None after a failed build
    or load (the failure is kept, :func:`build_error`)."""
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    with _lock:
        if _lib is None and _build_error is None:
            try:
                _lib = _bind(build_library())
            except (RuntimeError, OSError) as e:
                _build_error = str(e).strip()[-2000:]
    return _lib


def native_available() -> bool:
    """Whether the reader builds and loads on this machine."""
    return _load() is not None


def build_error() -> str | None:
    """The compiler's (or the loader's) message of a failed first build,
    or None."""
    _load()
    return _build_error


def read_spectra_native(
    paths, npix: int, n_threads: int = 16
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Read many spectra npz files on the C++ thread pool.

    Returns (flux, error, mask, z, flux_ok): flux and error float32 (N,
    npix), mask and flux_ok bool (N, npix), z float32 (N,), the contract
    of ``data.loader.read_spectra``'s Python engine. Raises
    ``RuntimeError`` when the reader cannot be built, and ``IOError``
    naming the first failure when a file cannot be read.
    """
    global READS
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native reader unavailable: {_build_error}")
    n = len(paths)
    flux = np.empty((n, npix), np.float32)
    error = np.empty((n, npix), np.float32)
    mask = np.empty((n, npix), np.uint8)
    flux_ok = np.empty((n, npix), np.uint8)
    z = np.empty((n,), np.float32)
    c_paths = (ctypes.c_char_p * n)(*(os.fsencode(p) for p in paths))
    errbuf = ctypes.create_string_buffer(512)
    rc = lib.qfa_read_spectra(
        c_paths, n, npix, flux.ctypes.data, error.ctypes.data,
        mask.ctypes.data, flux_ok.ctypes.data, z.ctypes.data, n_threads,
        errbuf, len(errbuf))
    READS += 1
    if rc != 0:
        raise IOError(f"native reader: {rc}/{n} files failed "
                      f"({errbuf.value.decode(errors='replace')})")
    return flux, error, mask.view(bool), z, flux_ok.view(bool)
