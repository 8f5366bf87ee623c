"""PyTorch and CUDA port of qfa_tpu (Quasar Factor Analysis) for NVIDIA Hopper.

The plain batched torch likelihood and posterior (``models.qfa``); three
kernels written in CUDA C++ for ``sm_90a``, each beside its plain torch
version: prediction (``ops.infer_kernel``), whole training epochs
(``ops.epoch_kernel``) and one batch's loss and gradients
(``ops.fused_step``); the trainers (``train``: ``fit_fused`` on the epoch
kernel, ``fit_streaming`` from host RAM on the step kernel, ``fit`` by
autograd); the CLI (``cli``) and the HTTP server (``serve``). Imports
neither ``jax`` nor ``qfa_tpu``; the JAX package is the reference the
tests hold it against.
"""

from .data.grid import WavelengthGrid, make_grid

__version__ = "0.1.0"

__all__ = ["WavelengthGrid", "make_grid", "__version__"]
