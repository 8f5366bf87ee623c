"""PyTorch and CUDA port of qfa_tpu (Quasar Factor Analysis) for NVIDIA Hopper.

The plain batched torch likelihood and posterior (``models.qfa``); three
kernels written in CUDA C++ for ``sm_90a``, each beside its plain torch
version: prediction (``ops.infer_kernel``), whole training epochs
(``ops.epoch_kernel``) and one batch's loss and gradients
(``ops.fused_step``); the trainers (``train``: ``fit_fused`` on the epoch
kernel, ``fit_streaming`` from host RAM on the step kernel, ``fit`` by
autograd); the CLI (``cli``) and the HTTP server (``serve``); the
reference-API facade (``compat``: ``QFA``, ``Dataloader``, ``Adam``) and
the conditional mixture density network (``models.mdn``). The top level
re-exports the JAX package's names. Imports neither ``jax`` nor
``qfa_tpu``, and builds no kernel at import; the JAX package is the
reference the tests hold it against.
"""

from . import infer, linalg, models, parallel, physics, train
from .config import ConfigNode, default_config, load_config
from .data.batch import SpectraBatch, pad_batch
from .data.grid import WavelengthGrid, make_grid
from .models import (
    ModelOptions,
    PredictResult,
    QFAParams,
    batch_nll,
    clip_params,
    load_npz,
    loss_and_grads,
    predict,
    random_init,
    save_npz,
    smooth_params,
)

__version__ = "0.1.0"

__all__ = [
    "infer",
    "linalg",
    "models",
    "parallel",
    "physics",
    "train",
    "ConfigNode",
    "default_config",
    "load_config",
    "SpectraBatch",
    "pad_batch",
    "WavelengthGrid",
    "make_grid",
    "ModelOptions",
    "PredictResult",
    "QFAParams",
    "batch_nll",
    "clip_params",
    "load_npz",
    "loss_and_grads",
    "predict",
    "random_init",
    "save_npz",
    "smooth_params",
    "__version__",
]
