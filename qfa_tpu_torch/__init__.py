"""PyTorch and CUDA port of qfa_tpu (Quasar Factor Analysis) for NVIDIA Hopper.

The prediction and serving path: the plain batched torch likelihood and
posterior (``models.qfa``), the fused prediction kernel written in CUDA
C++ for ``sm_90a`` with its plain torch version (``ops.infer_kernel``),
the predict CLI (``cli``) and the HTTP server (``serve``). Imports
neither ``jax`` nor ``qfa_tpu``; the JAX package is the reference the
tests hold it against.
"""

from .data.grid import WavelengthGrid, make_grid

__version__ = "0.1.0"

__all__ = ["WavelengthGrid", "make_grid", "__version__"]
