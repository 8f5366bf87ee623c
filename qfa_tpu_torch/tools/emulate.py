"""The epoch kernel's CUDA source, compiled for the CPU.

    from qfa_tpu_torch.tools import emulate
    lib = emulate.load(emulate.build(out_dir, nhs=(3, 8)))

:func:`build` compiles ``csrc/epoch.cu`` itself with g++ against the
stand-in headers in ``tools/cuda_emu`` (one std::thread per CUDA thread,
the blocks of a launch one after another, ``__syncthreads`` a barrier)
into a shared library with the kernel's C interface; :func:`load` binds
it with the CUDA library's ctypes signatures, and :func:`installed` puts
it behind ``ops.epoch_kernel``'s CUDA wrapper so that the wrapper runs it
on CPU tensors. This checks the kernel's indexing, tiling, reductions and
arrival counters where there is no card and no CUDA compiler; it checks
no resource limit (registers, 48 KB of static shared memory) and no
timing. Needs g++ with C++20.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

HEADERS = Path(__file__).resolve().parent / "cuda_emu"


def build(out_dir, nhs=None) -> Path:
    """Compile ``csrc/epoch.cu`` for the CPU into ``out_dir``; with
    ``nhs``, instantiate only those nh (faster to build). Returns the
    library's path; raises with g++'s output if it fails."""
    from ..ops import _build

    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the CPU build of epoch.cu needs it")
    src = (_build.CSRC / "epoch.cu").read_text()
    if nhs is not None:
        keep = {str(n) for n in nhs}
        src = re.sub(r"    case (\d+): return run<\1>",
                     lambda m: m[0] if m[1] in keep else
                     f"    case {m[1]}: return cudaErrorInvalidValue; //",
                     src)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cpp = out / "epoch_emu.cpp"
    cpp.write_text(src)
    lib = out / "libepoch_emu.so"
    res = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-Wno-unknown-pragmas", f"-I{HEADERS}", f"-I{_build.CSRC}",
         "-x", "c++", str(cpp), "-o", str(lib)],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{res.stdout}{res.stderr}")
    return lib


def load(path) -> ctypes.CDLL:
    """The built library with the epoch kernel's ctypes signatures."""
    from ..ops import _build

    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _build.SIGNATURES.items():
        if name.startswith("qfa_train_epoch"):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
    return lib


@contextlib.contextmanager
def installed(lib):
    """Within the block, ``ops.epoch_kernel``'s CUDA wrapper (``_launch``)
    runs ``lib`` on whatever device its tensors are on."""
    from ..ops import _build, epoch_kernel

    saved = _build.load_library, epoch_kernel._device_and_stream
    _build.load_library = lambda: lib
    epoch_kernel._device_and_stream = lambda dev: (0, None)
    try:
        yield
    finally:
        _build.load_library, epoch_kernel._device_and_stream = saved
