"""Batch inference: continuum prediction and OOD scoring over datasets."""

from .predict import (
    ood_scores,
    predict_dataset,
    predict_dataset_fused,
    select_ood,
    write_consolidated_npz,
    write_npz_outputs,
)

__all__ = [
    "ood_scores",
    "predict_dataset",
    "predict_dataset_fused",
    "select_ood",
    "write_consolidated_npz",
    "write_npz_outputs",
]
