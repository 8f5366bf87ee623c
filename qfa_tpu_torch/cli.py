"""Command line: ``python -m qfa_tpu_torch.cli --type train|predict``.

The flags, ``config.yaml``/``log.txt`` run directory and output files of
``qfa_tpu.cli``, plus ``--device`` (``RUNTIME.DEVICE``, default ``cuda``).
When the device is a GPU and ``TRAIN.ENGINE`` is ``auto`` or ``pallas``,
``--type train`` runs every epoch in the CUDA epoch kernel
(``train.fit_fused``) and ``--type predict`` in the CUDA prediction
kernel. Otherwise, as in ``qfa_tpu.cli``, ``--type train`` runs the
per-step trainer ``train.fit`` and ``--type predict`` the plain
prediction path.
"""

from __future__ import annotations

import argparse
import os
import time

from .config import ConfigNode, get_config

__all__ = ["build_parser", "main", "resident_layout", "run_predict",
           "run_train", "train_config"]


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
        description="Quasar Factor Analysis on PyTorch / CUDA (train / predict)"
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


def _load_training_data(cfg: ConfigNode, grid, device):
    """Select and read the training spectra, estimate mu, and build the
    residual tensors on ``device``; plus the held-out validation set
    (``DATA.VALIDATION``), unless ``DATA.VALIDATION_CONCAT_COMPAT`` trains
    on it as the reference does."""
    from .data.loader import (
        SpectraDataset,
        compute_taus,
        estimate_mu,
        make_residuals,
        select_from_catalog,
        validation_concat_paths,
    )

    cuts = dict(snr_min=cfg.DATA.SNR_MIN, snr_max=cfg.DATA.SNR_MAX,
                z_min=cfg.DATA.Z_MIN, z_max=cfg.DATA.Z_MAX,
                num_mask=cfg.DATA.NUM_MASK, output_dir=cfg.DATA.OUTPUT_DIR)
    paths = select_from_catalog(cfg.DATA.CATALOG, cfg.DATA.DATA_DIR,
                                cfg.DATA.DATA_NUM, seed=cfg.SEED,
                                prefix="train", **cuts)
    extra = validation_concat_paths(cfg.DATA, cfg.SEED,
                                    output_dir=cfg.DATA.OUTPUT_DIR)
    concat_compat = extra is not None
    if concat_compat:
        paths = list(paths) + extra
    dataset = SpectraDataset.from_paths(paths, max_workers=cfg.DATA.NPROCS)
    taus = compute_taus(grid, dataset.zqso, tau_which=cfg.MODEL.TAU,
                        device=device)
    mu = estimate_mu(dataset, grid, tau_which=cfg.MODEL.TAU,
                     window=cfg.TRAIN.WINDOW_LENGTH_FOR_MU, taus=taus)
    residuals = make_residuals(dataset, grid, mu, tau_which=cfg.MODEL.TAU,
                               device=device, taus=taus)
    del taus
    val_residuals = None
    if (not concat_compat and cfg.DATA.VALIDATION
            and os.path.exists(cfg.DATA.VALIDATION_CATALOG)):
        val_paths = select_from_catalog(
            cfg.DATA.VALIDATION_CATALOG, cfg.DATA.VALIDATION_DIR,
            cfg.DATA.VALIDATION_NUM, seed=cfg.SEED + 1, prefix="validation",
            **cuts)
        val_dataset = SpectraDataset.from_paths(val_paths,
                                                max_workers=cfg.DATA.NPROCS)
        val_residuals = make_residuals(val_dataset, grid, mu,
                                       tau_which=cfg.MODEL.TAU, device=device)
    return dataset, mu, residuals, val_residuals


def train_config(cfg: ConfigNode):
    """The ``TrainConfig`` of a run's configuration."""
    from .models.qfa import ModelOptions
    from .train import TrainConfig

    return TrainConfig(
        n_epochs=cfg.TRAIN.NEPOCHS,
        batch_size=cfg.DATA.BATCH_SIZE,
        learning_rate=cfg.TRAIN.LEARNING_RATE,
        weight_decay=cfg.TRAIN.WEIGHT_DECAY,
        decay_alpha=cfg.TRAIN.DECAY_ALPHA,
        decay_step=cfg.TRAIN.DECAY_STEP,
        smooth_interval=cfg.TRAIN.SMOOTH_INTERVAL,
        save_interval=cfg.TRAIN.SAVE_INTERVAL,
        reference_norm=cfg.TRAIN.REFERENCE_NORM,
        mxu_bf16=cfg.TRAIN.MXU_BF16,
        bwd_wide=cfg.TRAIN.BWD_WIDE,
        options=ModelOptions(tau_which=cfg.MODEL.TAU),
    )


def resident_layout(dataset, residuals, grid, device):
    """The fused engine's production resident layout: when every masked
    pixel carries error == 0, the engine derives the mask (error > 0) and
    the absorber redshifts (the (N, 2) zq column and the loglam row).
    Returns the residuals and ``fit_fused``'s layout keywords (empty when
    the planes stay)."""
    import numpy as np
    import torch

    from .ops.common import loglam_row, zq_column

    if not bool(np.all((dataset.error > 0.0) == dataset.mask)):
        return residuals, {}
    residuals = residuals._replace(
        zabs=zq_column(torch.as_tensor(dataset.zqso, device=device)),
        mask=None)
    return residuals, dict(derive_mask=True,
                           loglam=loglam_row(grid.wav, device=device))


def run_train(cfg: ConfigNode) -> dict:
    """Train on ``DATA.CATALOG``: resume from the newest full state in the
    run directory, else ``MODEL.RESUME``, else a random init from ``SEED``;
    write ``metrics.jsonl``, the checkpoints and ``model_parameters.npz``.
    Returns the spectrum count, the per-epoch loss history, the engine, and
    the wall seconds spent loading and training."""
    import torch

    from .data.grid import make_grid
    from .models import load_npz, random_init, save_npz
    from .train import fit, fit_fused
    from .train.checkpoint import latest_checkpoint, load_state
    from .utils.device import resolve_device
    from .utils.logging import MetricsWriter, make_logger, setup_run_dir

    device = resolve_device(cfg.RUNTIME.DEVICE)
    for key in ("PROFILE_DIR", "DEBUG_NANS"):
        if cfg.RUNTIME[key]:
            raise NotImplementedError(
                f"RUNTIME.{key} is not ported yet (ROADMAP A8: the port's "
                "profiling goes through torch.profiler)")
    out = setup_run_dir(cfg.DATA.OUTPUT_DIR, cfg)
    logger = make_logger(out)
    grid = make_grid(cfg.DATA.LAMMIN, cfg.DATA.LAMMAX, cfg.DATA.LOGLAM_DELTA)

    t_read = time.time()
    dataset, mu, residuals, val_residuals = _load_training_data(
        cfg, grid, device)
    logger.info("loaded %d spectra (grid npix=%d nb=%d)", dataset.size,
                grid.npix, grid.nb)

    # resume priority: (1) the newest full state in the run directory
    # (params, Adam moments, epoch), (2) MODEL.RESUME (params only),
    # (3) a random init from SEED
    params = initial_state = None
    auto = latest_checkpoint(os.path.join(out, "checkpoints")) \
        if cfg.TRAIN.AUTO_RESUME else None
    if auto is not None:
        initial_state, _ = load_state(auto, device=device)
        params = initial_state.params
        if (tuple(params.F.shape) != (grid.npix, cfg.MODEL.NH)
                or params.omega.shape[0] != grid.nb):
            raise ValueError(
                f"auto-resume checkpoint {auto} has F shape "
                f"{tuple(params.F.shape)} / omega length "
                f"{params.omega.shape[0]} but the current config wants "
                f"({grid.npix}, {cfg.MODEL.NH}) / {grid.nb}; delete the "
                "stale checkpoints/ in the output dir, change "
                "DATA.OUTPUT_DIR, or set TRAIN.AUTO_RESUME False")
        if cfg.MODEL.RESUME:
            logger.warning(
                "ignoring MODEL.RESUME=%s: auto-resuming the run already in "
                "%s instead (set TRAIN.AUTO_RESUME False to override)",
                cfg.MODEL.RESUME, out)
        start = int(initial_state.opt_state.epoch)
        if start >= cfg.TRAIN.NEPOCHS:
            logger.warning(
                "auto-resumed state is already at epoch %d >= NEPOCHS=%d: "
                "no epochs will run and the saved model is the checkpoint "
                "as-is", start, cfg.TRAIN.NEPOCHS)
        logger.info("auto-resumed full training state from %s (epoch %d)",
                    auto, start)
    elif cfg.MODEL.RESUME and os.path.exists(cfg.MODEL.RESUME):
        params, _ = load_npz(cfg.MODEL.RESUME,
                             compat_c0_bug=cfg.MODEL.COMPAT_C0_BUG,
                             device=device)
        logger.info("resumed parameters from %s", cfg.MODEL.RESUME)
    else:
        # drawn on the CPU: one seed gives one init on every device
        params = random_init(
            grid.npix, grid.nb, cfg.MODEL.NH,
            generator=torch.Generator().manual_seed(cfg.SEED)).to(device)

    if device.type == "cuda" and torch.cuda.device_count() > 1:
        logger.info("%d CUDA devices visible; training on %s only "
                    "(data-parallel training is ROADMAP A10)",
                    torch.cuda.device_count(), device)
    # the JAX CLI's choice: the fused engine on the accelerator for
    # TRAIN.ENGINE auto/pallas, else the per-step trainer train.fit
    use_kernel = cfg.TRAIN.ENGINE in ("auto", "pallas") and \
        device.type == "cuda"
    if use_kernel:
        logger.info("trainer engine: fused CUDA epoch kernel on %s", device)
    else:
        if cfg.TRAIN.ENGINE == "pallas":
            logger.warning("TRAIN.ENGINE=pallas requested but %s is no CUDA "
                           "device; falling back to the XLA trainer", device)
        logger.info("trainer engine: XLA trainer (train.fit, per-step "
                    "autograd) on %s", device)
    train_cfg = train_config(cfg)
    if cfg.TRAIN.MXU_BF16 and use_kernel:
        logger.info("mxu mode: bf16 operands on the six heavy products "
                    "(f32 accumulation)")
    if cfg.TRAIN.BF16_PLANES:
        from .data.loader import bf16_planes

        residuals = bf16_planes(residuals)
        logger.info("capacity mode: bf16-stored delta/error planes (half "
                    "the resident bytes; f32 arithmetic)")
    kwargs = {}
    if use_kernel:
        residuals, kwargs = resident_layout(dataset, residuals, grid, device)
        if kwargs:
            logger.info("resident layout: derived mask + zq-column "
                        "redshifts")
        if cfg.TRAIN.EPOCHS_PER_LAUNCH > 1:
            kwargs["epochs_per_launch"] = cfg.TRAIN.EPOCHS_PER_LAUNCH
            logger.info("up to %d epochs per call of the epoch engine",
                        cfg.TRAIN.EPOCHS_PER_LAUNCH)
    t0 = time.time()
    with MetricsWriter(out) as metrics:
        fit_kwargs = dict(
            seed=cfg.SEED, output_dir=out, logger=logger,
            val_data=val_residuals, initial_state=initial_state,
            metrics_cb=lambda e, loss, dt: metrics.write(
                epoch=e, loss=loss, seconds=dt,
                spectra_per_s=round(residuals.size / max(dt, 1e-9), 1)))
        if use_kernel:
            params, history = fit_fused(params, residuals, mu, train_cfg,
                                        **kwargs, **fit_kwargs)
        else:
            params, history = fit(params, residuals, mu, train_cfg,
                                  **fit_kwargs)
    t_end = time.time()
    save_npz(os.path.join(out, "model_parameters.npz"), params, mu)
    logger.info("training done: %d epochs, final loss %.3f", len(history),
                history[-1] if history else float("nan"))
    return {
        "n": dataset.size,
        "history": history,
        "engine": "kernel" if use_kernel else "fit",
        "read_s": t0 - t_read,
        "train_s": t_end - t0,
    }


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


def main(argv=None) -> dict:
    """Parse the flags and run the mode; returns :func:`run_train`'s or
    :func:`run_predict`'s summary."""
    args = build_parser().parse_args(argv)
    cfg = get_config(args)
    if cfg.TYPE == "train":
        return run_train(cfg)
    if cfg.TYPE == "predict":
        return run_predict(cfg)
    raise SystemExit(f"TYPE must be 'train' or 'predict', got {cfg.TYPE!r}")


if __name__ == "__main__":
    main()
