"""The CUDA kernels' own sources, compiled for the CPU.

    from qfa_tpu_torch.tools import emulate
    lib = emulate.load(emulate.build(out_dir, nhs=(3, 8)))
    lib = emulate.load(emulate.build(out_dir, nhs=(3, 8), source="predict.cu"))
    lib = emulate.load(emulate.build(out_dir, nhs=(3, 8), source="step.cu"))
    lib = emulate.load(emulate.build(out_dir, source="kdepth.cu"))

:func:`build` compiles ``csrc/epoch.cu``, ``csrc/predict.cu``,
``csrc/step.cu`` or ``csrc/kdepth.cu`` itself with g++ against the
stand-in headers in ``tools/cuda_emu`` (one std::thread per CUDA thread,
the blocks of a launch one after another, ``__syncthreads`` a barrier, an
asynchronous copy landing when its thread waits for it, the warp's
m16n8k8 TF32 tensor-core product in the PTX ISA's fragment layout) into a
shared library with the kernel's C interface; :func:`load` binds it with
the CUDA library's ctypes signatures, and :func:`installed` puts it
behind the CUDA wrappers (``_launch`` of ``ops.epoch_kernel``,
``ops.infer_kernel``, ``ops.fused_step`` and ``ops.kdepth``) so that they
run it on CPU tensors. This checks a kernel's indexing, tiling, fragment
layouts, ring of copies, reductions and arrival counters where there is
no card and no CUDA compiler; it checks no resource limit (registers,
shared memory) and no timing. Needs g++ with C++20.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

HEADERS = Path(__file__).resolve().parent / "cuda_emu"


def build(out_dir, nhs=None, source="epoch.cu") -> Path:
    """Compile ``csrc/<source>`` for the CPU into ``out_dir``; with
    ``nhs``, instantiate only those nh (faster to build). Returns the
    library's path; raises with g++'s output if it fails."""
    from ..ops import _build

    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: the CPU build of {source} needs it")
    src = (_build.CSRC / source).read_text()
    if nhs is not None:
        keep = {str(n) for n in nhs}
        src = re.sub(r"    case (\d+): return \w+<\1>",
                     lambda m: m[0] if m[1] in keep else
                     f"    case {m[1]}: return cudaErrorInvalidValue; //",
                     src)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    stem = Path(source).stem
    cpp = out / f"{stem}_emu.cpp"
    cpp.write_text(src)
    lib = out / f"lib{stem}_emu.so"
    res = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-Wno-unknown-pragmas", f"-I{HEADERS}", f"-I{_build.CSRC}",
         "-x", "c++", str(cpp), "-o", str(lib)],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{res.stdout}{res.stderr}")
    return lib


def load(path) -> ctypes.CDLL:
    """The built library, each of its entry points with the CUDA
    library's ctypes signature."""
    from ..ops import _build

    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _build.SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
    if not hasattr(lib, "qfa_cuda_error_string"):  # predict.cu's
        lib.qfa_cuda_error_string = lambda code: b"emulated CUDA error"
    return lib


@contextlib.contextmanager
def installed(lib):
    """Within the block, the CUDA wrappers (``_launch``) run ``lib`` on
    whatever device their tensors are on."""
    from ..ops import _build

    saved = _build.load_library, _build.device_and_stream
    _build.load_library = lambda: lib
    _build.device_and_stream = lambda dev: (0, None)
    try:
        yield
    finally:
        _build.load_library, _build.device_and_stream = saved
