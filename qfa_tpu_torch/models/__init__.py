"""QFA parameters and the plain torch likelihood / prediction path."""

from .params import ParamBounds, QFAParams, load_npz, random_init, save_npz
from .qfa import ModelOptions, PredictResult, batch_nll, predict

__all__ = [
    "ParamBounds",
    "QFAParams",
    "load_npz",
    "random_init",
    "save_npz",
    "ModelOptions",
    "PredictResult",
    "batch_nll",
    "predict",
]
