"""QFA parameters, the plain torch likelihood / prediction path, and the
conditional mixture density network of the latent factors (``mdn``)."""

from .params import (
    DEFAULT_BOUNDS,
    ParamBounds,
    QFAParams,
    clip_params,
    load_npz,
    num_params,
    random_init,
    save_npz,
    smooth_params,
)
from .qfa import (
    ModelOptions,
    PredictResult,
    absorption,
    batch_factors,
    batch_nll,
    loss_and_grads,
    make_delta,
    mean_nll,
    noise_diagonal,
    normalize_grads,
    predict,
)

__all__ = [
    "DEFAULT_BOUNDS",
    "ParamBounds",
    "QFAParams",
    "clip_params",
    "load_npz",
    "num_params",
    "random_init",
    "save_npz",
    "smooth_params",
    "ModelOptions",
    "PredictResult",
    "absorption",
    "batch_factors",
    "batch_nll",
    "loss_and_grads",
    "make_delta",
    "mean_nll",
    "noise_diagonal",
    "normalize_grads",
    "predict",
]
