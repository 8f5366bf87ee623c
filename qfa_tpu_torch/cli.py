"""Command-line entry point: ``python -m qfa_tpu_torch.cli --type predict``.

The flags, ``config.yaml``/``log.txt`` run directory and output files of
``qfa_tpu.cli``, plus ``--device`` (``RUNTIME.DEVICE``, default ``cuda``).
``--type predict`` runs the fused CUDA prediction kernel when the device is
a GPU and ``TRAIN.ENGINE`` is ``auto`` or ``pallas``, and the plain torch
path otherwise. Training is not ported yet.
"""

from __future__ import annotations

import argparse
import os
import time

from .config import ConfigNode, get_config

__all__ = ["build_parser", "main", "run_predict"]


def _str2bool(value: str) -> bool:
    """argparse bool: ``--validation False`` must parse as False."""
    if isinstance(value, bool):
        return value
    low = value.strip().lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {value!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Quasar Factor Analysis on PyTorch / CUDA (predict)"
    )
    p.add_argument("--cfg", type=str, help="yaml configuration file")
    p.add_argument("--type", type=str, help="mode: train or predict")
    p.add_argument("--catalog", type=str, help="catalog csv (file,snr,z,num_mask)")
    p.add_argument("--data_dir", type=str, help="directory with spectra npz files")
    p.add_argument("--output_dir", type=str, help="run output directory")
    p.add_argument("--data_num", type=int, help="number of training spectra")
    p.add_argument("--validation_catalog", type=str)
    p.add_argument("--validation_num", type=int)
    p.add_argument("--validation_dir", type=str)
    p.add_argument("--validation", type=_str2bool)
    p.add_argument("--batch_size", type=int)
    p.add_argument("--n_epochs", type=int)
    p.add_argument("--nh", type=int, help="number of latent factors")
    p.add_argument("--tau", type=str, help="mean optical depth law")
    p.add_argument("--learning_rate", type=float)
    p.add_argument("--weight_decay", type=float)
    p.add_argument("--decay_alpha", type=float)
    p.add_argument("--decay_step", type=int)
    p.add_argument("--snr_min", type=float)
    p.add_argument("--snr_max", type=float)
    p.add_argument("--z_min", type=float)
    p.add_argument("--z_max", type=float)
    p.add_argument("--num_mask", type=int)
    p.add_argument("--nprocs", type=int)
    p.add_argument("--resume", type=str, help="checkpoint npz to resume from")
    p.add_argument("--seed", type=int)
    p.add_argument("--device", type=str,
                   help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument(
        "--opts", nargs="*", default=None, help="KEY.SUBKEY VALUE override pairs"
    )
    return p


def run_predict(cfg: ConfigNode) -> dict:
    """Predict every spectrum of ``DATA.CATALOG`` with the ``MODEL.RESUME``
    checkpoint; write the per-spectrum npz files (or one consolidated
    file). Returns the spectrum count and the wall seconds spent reading,
    predicting (host-device copies included) and writing."""
    from .data.grid import make_grid
    from .data.loader import SpectraDataset, read_predict_catalog
    from .infer.predict import (
        predict_dataset,
        predict_dataset_fused,
        write_consolidated_npz,
        write_npz_outputs,
    )
    from .models import load_npz
    from .models.qfa import ModelOptions
    from .utils.device import resolve_device
    from .utils.logging import make_logger, setup_run_dir

    device = resolve_device(cfg.RUNTIME.DEVICE)
    out = setup_run_dir(cfg.DATA.OUTPUT_DIR, cfg)
    logger = make_logger(out)
    grid = make_grid(cfg.DATA.LAMMIN, cfg.DATA.LAMMAX, cfg.DATA.LOGLAM_DELTA)

    t_read = time.time()
    paths = read_predict_catalog(cfg.DATA.CATALOG, cfg.DATA.DATA_DIR)
    dataset = SpectraDataset.from_paths(paths, max_workers=cfg.DATA.NPROCS)
    params, mu = load_npz(cfg.MODEL.RESUME,
                          compat_c0_bug=cfg.MODEL.COMPAT_C0_BUG, device=device)
    t0 = time.time()
    options = ModelOptions(tau_which=cfg.MODEL.TAU)
    if cfg.TRAIN.ENGINE in ("auto", "pallas") and device.type == "cuda":
        logger.info("predict engine: fused CUDA kernel on %s", device)
        result = predict_dataset_fused(params, mu, dataset, grid,
                                       options=options)
    else:
        result = predict_dataset(
            params, mu, dataset, grid,
            batch_size=min(cfg.DATA.BATCH_SIZE, 4096), options=options,
        )
    t_write = time.time()
    if cfg.RUNTIME.CONSOLIDATED_PREDICT:
        write_consolidated_npz(
            result, dataset.paths, os.path.join(out, "predictions.npz")
        )
    else:
        write_npz_outputs(result, dataset.paths, os.path.join(out, "predict"))
    t_end = time.time()
    dt = t_end - t0
    logger.info(
        "predicted %d spectra in %.2f s (%.1f spectra/s)",
        dataset.size, dt, dataset.size / max(dt, 1e-9),
    )
    print(f"Finish predicting {dataset.size} spectra in {dt:.2f} seconds...")
    return {
        "n": dataset.size,
        "read_s": t0 - t_read,
        "predict_s": t_write - t0,
        "write_s": t_end - t_write,
    }


def main(argv=None) -> dict | None:
    """Parse the flags and run the mode; returns :func:`run_predict`'s
    timings for ``--type predict``."""
    args = build_parser().parse_args(argv)
    cfg = get_config(args)
    if cfg.TYPE == "train":
        raise NotImplementedError(
            "--type train is not ported to PyTorch yet (ROADMAP A6: the "
            "training half and its CUDA epoch kernel); train with "
            "qfa_tpu.cli and predict here from its checkpoint"
        )
    if cfg.TYPE == "predict":
        return run_predict(cfg)
    raise SystemExit(f"TYPE must be 'train' or 'predict', got {cfg.TYPE!r}")


if __name__ == "__main__":
    main()
