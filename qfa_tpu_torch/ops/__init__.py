"""Kernels written by hand for Hopper, each beside its plain torch version."""

from .common import TAU_LAW_ABC, loglam_row, tau_law_abc, zq_column
from .fused_step import (
    FusedStepOutputs,
    finish_f_gradient,
    fused_loss_grads,
    fused_loss_grads_plain,
)
from .infer_kernel import FusedPredictOutputs, fused_predict, fused_predict_plain

__all__ = [
    "TAU_LAW_ABC",
    "loglam_row",
    "tau_law_abc",
    "zq_column",
    "FusedStepOutputs",
    "finish_f_gradient",
    "fused_loss_grads",
    "fused_loss_grads_plain",
    "FusedPredictOutputs",
    "fused_predict",
    "fused_predict_plain",
]
