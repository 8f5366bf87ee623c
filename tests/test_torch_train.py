"""The port's training path against the JAX package: the training half of
the data layer (catalog selection, tau, mu, residuals) and the whole-epoch
engine ``fit_fused`` (on the CPU: the plain version) against
``fit_pallas(interpret=True)``, fed the JAX run's own permutations
(``fold_in(key, epoch)``).

Tolerances, and why: catalog selection and the written catalog are
identical; taus, mu and residuals rtol 1e-5 (float32 power laws through
XLA and torch); per-epoch losses rtol 1e-5 and final parameters rtol 5e-4
atol 1e-5 after several epochs, smoothing and a reshuffle (the JAX
package's own bound between its two resident layouts,
tests/test_epoch_kernel.py:322-324). Runs of the port against itself
(resume, chunking) are exact: the plain version is deterministic.
"""

import functools
import logging
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qfa_tpu
from qfa_tpu.data import loader as jax_loader
from qfa_tpu.data.loader import ResidualDataset as JaxResidualDataset
from qfa_tpu.data.synthetic import generate
from qfa_tpu.models import random_init as jax_random_init
from qfa_tpu.ops import loglam_row as jax_loglam_row
from qfa_tpu.ops import zq_column as jax_zq_column
from qfa_tpu.train import TrainConfig as JaxTrainConfig
from qfa_tpu.train import fit_pallas
from qfa_tpu_torch.data import loader
from qfa_tpu_torch.data.grid import make_grid
from qfa_tpu_torch.data.loader import ResidualDataset
from qfa_tpu_torch.models.params import PARAM_NAMES, QFAParams
from qfa_tpu_torch.ops.common import loglam_row
from qfa_tpu_torch.train import (
    SeededShuffler,
    TrainConfig,
    TrainState,
    adam,
    fit_fused,
    guard_nonfinite,
    pick_tiling,
)
from qfa_tpu_torch.train.checkpoint import load_state

N = 64
KEY = 6


class JaxShuffler:
    """The permutations fit_pallas draws: tiles ``permutation(fold_in(key,
    epoch))``, reshuffles ``permutation(fold_in(fold_in(key, epoch), 1))``."""

    def __init__(self, seed):
        self.key = jax.random.key(seed)

    def tiles(self, epoch, n):
        k = jax.random.fold_in(self.key, epoch)
        return torch.tensor(np.asarray(jax.random.permutation(k, n)))

    def rows(self, epoch, n):
        k = jax.random.fold_in(jax.random.fold_in(self.key, epoch), 1)
        return torch.tensor(np.asarray(jax.random.permutation(k, n)))


@functools.lru_cache(maxsize=None)
def make_problem(noise: str = "moderate"):
    """64 training and 16 validation spectra, start params, mu (numpy)."""
    grid = qfa_tpu.make_grid(1150.0, 1300.0, 1e-3)
    nh = 4
    var, err = (0.4, 0.1) if noise == "moderate" else (0.02, 0.03)
    true = jax_random_init(jax.random.key(0), grid.npix, grid.nb, nh)
    true = true._replace(
        Psi=jnp.full((grid.npix,), var), omega=jnp.full((grid.nb,), var),
        tau0=jnp.asarray(0.12), c0=jnp.asarray(0.21), beta=jnp.asarray(1.7))
    mu = jnp.full((grid.npix,), 1.1, jnp.float32)
    syn = generate(jax.random.key(1), true, mu, grid, N + 16, mask_frac=0.15,
                   error_scale=err)
    b = syn.to_batch(mu)
    data = {k: np.array(getattr(b, k), np.float32)
            for k in ("delta", "error", "zabs", "mask")}
    data["zq"] = np.array(jax_zq_column(syn.zqso))
    p0 = true if noise == "low" else jax_random_init(
        jax.random.key(5), grid.npix, grid.nb, nh)
    p0 = {k: np.asarray(v) for k, v in p0.as_dict().items()}
    return grid, data, p0, np.asarray(mu)


def jax_data(data, rows, derived):
    d = {k: jnp.asarray(v[rows]) for k, v in data.items()}
    if derived:
        return JaxResidualDataset(delta=d["delta"], error=d["error"],
                                  zabs=d["zq"], mask=None)
    return JaxResidualDataset(delta=d["delta"], error=d["error"],
                              zabs=d["zabs"], mask=d["mask"])


def port_data(data, rows, derived):
    d = {k: torch.tensor(v[rows]) for k, v in data.items()}
    if derived:
        return ResidualDataset(delta=d["delta"], error=d["error"],
                               zabs=d["zq"][:, :2], mask=None)
    return ResidualDataset(delta=d["delta"], error=d["error"],
                           zabs=d["zabs"], mask=d["mask"])


CFG = dict(batch_size=24, learning_rate=1e-2, weight_decay=0.01,
           smooth_interval=2, save_interval=2, mxu_bf16=True)
TRAIN, VAL = slice(0, N), slice(N, N + 16)


def run_both(tmp_path, *, n_epochs, derived=True, data=None, cfg=None,
             noise="moderate", val=False, bf16_planes=False, **kw):
    """fit_pallas (interpret mode) and fit_fused on the same data, start
    parameters and permutations (with ``bf16_planes``, both train on
    bfloat16-stored delta and error planes); returns ((params, history),
    ...) of each."""
    grid, base, p0, mu = make_problem(noise)
    data = base if data is None else data
    cfg = {**CFG, **(cfg or {}), "n_epochs": n_epochs}
    layout = dict(derive_mask=True) if derived else {}
    jax_train, port_train = (jax_data(data, TRAIN, derived),
                             port_data(data, TRAIN, derived))
    if bf16_planes:
        jax_train = jax_loader.bf16_planes(jax_train)
        port_train = loader.bf16_planes(port_train)
    ref = fit_pallas(
        qfa_tpu.models.QFAParams(**{k: jnp.asarray(v) for k, v in p0.items()}),
        jax_train, jnp.asarray(mu), JaxTrainConfig(**cfg),
        key=jax.random.key(KEY), tile_batch=8, interpret=True,
        output_dir=str(tmp_path / "jax"),
        val_data=jax_data(base, VAL, False) if val else None,
        loglam=jax_loglam_row(grid.wav) if derived else None, **layout, **kw)
    port = fit_fused(
        QFAParams.from_numpy(p0), port_train,
        mu, TrainConfig(**cfg), shuffler=JaxShuffler(KEY), tile_batch=8,
        output_dir=str(tmp_path / "port"),
        logger=logging.getLogger(f"test_torch_train.{tmp_path.name}"),
        val_data=port_data(base, VAL, False) if val else None,
        loglam=loglam_row(grid.wav) if derived else None, **layout, **kw)
    return ref, port


def assert_params_close(port, ref, **tol):
    for k in PARAM_NAMES:
        np.testing.assert_allclose(getattr(port, k).detach().numpy(),
                                   np.asarray(getattr(ref, k)), err_msg=k,
                                   **(tol or dict(rtol=5e-4, atol=1e-5)))


def test_fit_fused_matches_fit_pallas(tmp_path, caplog):
    """Production layout (derived mask + zq column, bf16 operands), batch
    24 of 64 rows (the tail batch padded with inert rows), smoothing and
    saving every 2 epochs, a physical reshuffle every 3, held-out
    validation; then a resume from the epoch-4 state (replaying the
    reshuffle) equals the uninterrupted run exactly."""
    grid, data, p0, mu = make_problem()
    with caplog.at_level(logging.INFO):
        (ref_p, ref_h), (p, h) = run_both(
            tmp_path, n_epochs=6, reshuffle_interval=3, val=True)
    np.testing.assert_allclose(h, ref_h, rtol=1e-5)
    assert_params_close(p, ref_p)
    vals = [r.message for r in caplog.records
            if r.name.startswith("test_torch_train") and "val_loss" in
            r.message]
    assert len(vals) == 6
    ckpts = sorted(os.listdir(tmp_path / "port" / "checkpoints"))
    assert ckpts == sorted(os.listdir(tmp_path / "jax" / "checkpoints"))
    assert "state_epoch_06.npz" in ckpts

    state, _ = load_state(str(tmp_path / "port/checkpoints/state_epoch_04.npz"))
    assert state.opt_state.epoch == 4
    p_res, h_res = fit_fused(
        None, port_data(data, TRAIN, True), mu,
        TrainConfig(**{**CFG, "n_epochs": 6}), shuffler=JaxShuffler(KEY),
        tile_batch=8, initial_state=state, reshuffle_interval=3,
        derive_mask=True, loglam=loglam_row(grid.wav))
    assert h_res == h[4:]
    for k in PARAM_NAMES:
        assert torch.equal(getattr(p_res, k), getattr(p, k)), k


def test_fit_fused_matches_fit_pallas_bf16_planes(tmp_path):
    """TRAIN.BF16_PLANES: both engines train on bfloat16-stored delta and
    error planes (production layout, bf16 operands), to the tolerances of
    the float32 planes; the planes stay bfloat16."""
    (ref_p, ref_h), (p, h) = run_both(tmp_path, n_epochs=4, bf16_planes=True)
    np.testing.assert_allclose(h, ref_h, rtol=1e-5)
    assert_params_close(p, ref_p)
    _, data, _, _ = make_problem()
    stored = loader.bf16_planes(port_data(data, TRAIN, True))
    assert stored.delta.dtype == stored.error.dtype == torch.bfloat16


def test_fit_fused_rolls_back_nonfinite_epochs(tmp_path, caplog):
    """An inf in the data poisons every epoch: both engines reject each
    one, keep the parameters at the init, and still write the interval
    checkpoint from the restored state."""
    grid, data, p0, mu = make_problem()
    poisoned = dict(data, delta=data["delta"].copy())
    poisoned["delta"][3, 10] = np.inf
    with caplog.at_level(logging.WARNING):
        (ref_p, ref_h), (p, h) = run_both(
            tmp_path, n_epochs=2, derived=False, data=poisoned,
            cfg=dict(batch_size=32, smooth_interval=100))
    assert len(h) == len(ref_h) == 2
    assert not np.isfinite(h).any() and not np.isfinite(ref_h).any()
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(getattr(p, k).detach().numpy(), p0[k])
    rejects = [r for r in caplog.records if r.name.startswith(
        "test_torch_train") and "rolled back" in r.message]
    assert len(rejects) == 2
    saved = np.load(tmp_path / "port/checkpoints/model_parameters_epoch_02.npz")
    np.testing.assert_array_equal(saved["F"], p0["F"])


def test_fit_fused_stops_on_negative_loss(tmp_path):
    """Low-noise data give a negative loss in the first epoch: both engines
    smooth, save and stop there."""
    (ref_p, ref_h), (p, h) = run_both(
        tmp_path, n_epochs=5, noise="low", cfg=dict(smooth_interval=100))
    assert len(h) == len(ref_h) == 1 and h[0] < 0
    np.testing.assert_allclose(h, ref_h, rtol=1e-5)
    assert_params_close(p, ref_p)
    ckpts = sorted(os.listdir(tmp_path / "port" / "checkpoints"))
    assert ckpts == sorted(os.listdir(tmp_path / "jax" / "checkpoints"))
    assert "state_epoch_01.npz" in ckpts


def test_fit_fused_epochs_per_launch_equals_per_epoch():
    """Chunks of up to 3 epochs per call, aligned to the smoothing
    interval, give the per-epoch run bit for bit."""
    grid, data, p0, mu = make_problem()
    runs = [fit_fused(QFAParams.from_numpy(p0), port_data(data, TRAIN, True),
                      mu, TrainConfig(**{**CFG, "n_epochs": 5,
                                         "smooth_interval": 4}),
                      seed=3, derive_mask=True, loglam=loglam_row(grid.wav),
                      epochs_per_launch=epl) for epl in (1, 3)]
    assert runs[0][1] == runs[1][1] and len(runs[0][1]) == 5
    for k in PARAM_NAMES:
        assert torch.equal(getattr(runs[0][0], k), getattr(runs[1][0], k))


def test_pick_tiling_never_pads_and_shuffler_is_seeded():
    assert pick_tiling(500) == (4, 500)
    assert pick_tiling(512) == (256, 512)
    assert pick_tiling(24) == (8, 24)
    assert pick_tiling(7) == (1, 7)
    assert pick_tiling(1024, limit=64) == (64, 1024)
    a, b = SeededShuffler(3), SeededShuffler(3)
    assert torch.equal(a.tiles(5, 40), b.tiles(5, 40))
    assert not torch.equal(a.tiles(5, 40), a.tiles(6, 40))
    assert not torch.equal(a.tiles(5, 40), a.rows(5, 40))
    assert sorted(a.rows(2, 9).tolist()) == list(range(9))


def test_guard_nonfinite_keeps_the_old_state():
    grid, data, p0, mu = make_problem()
    old = TrainState(QFAParams.from_numpy(p0),
                     adam.init(QFAParams.from_numpy(p0)))
    bad = dict(p0, Psi=np.where(np.arange(len(p0["Psi"])) == 3, np.nan,
                                p0["Psi"]).astype(np.float32))
    new = TrainState(QFAParams.from_numpy(bad), old.opt_state)
    assert guard_nonfinite(new, old, 1.0) == (old, False)
    good = TrainState(QFAParams.from_numpy(p0), old.opt_state)
    assert guard_nonfinite(good, old, 2.0) == (good, True)
    assert guard_nonfinite(good, old, float("inf")) == (old, False)


def test_fit_fused_multi_device_modes_raise():
    grid, data, p0, mu = make_problem()
    for kw in (dict(mesh=object()), dict(dp_exact=True)):
        with pytest.raises(NotImplementedError, match="A10"):
            fit_fused(QFAParams.from_numpy(p0), port_data(data, TRAIN, False),
                      mu, TrainConfig(n_epochs=1), **kw)


# ---- the training half of the data layer ---------------------------------


def write_catalog(path, rng, n=30):
    names = [f"spec-{i:03d}.npz" for i in range(n)]
    with open(path, "w") as f:
        f.write("file,snr,z,num_mask\n")
        for i, name in enumerate(names):
            f.write(f"{name},{rng.uniform(0, 20):.3f},"
                    f"{rng.uniform(1.5, 4.0):.4f},{int(rng.integers(0, 3))}\n")


@pytest.mark.parametrize("num", [5, 60])
def test_select_from_catalog_matches_jax(tmp_path, num):
    """Same cuts, same rng.choice draw (with replacement when too few rows
    survive), same written catalog, byte for byte."""
    cat = tmp_path / "cat.csv"
    write_catalog(cat, np.random.default_rng(num))
    kw = dict(snr_min=3.0, snr_max=18.0, z_min=2.0, z_max=3.5, num_mask=1,
              seed=11, prefix="train")
    port = loader.select_from_catalog(str(cat), "/data", num,
                                      output_dir=str(tmp_path / "p"), **kw)
    ref = jax_loader.select_from_catalog(str(cat), "/data", num,
                                         output_dir=str(tmp_path / "j"), **kw)
    assert port == ref and len(port) == num
    assert (tmp_path / "p" / "train-catalog.csv").read_bytes() == \
        (tmp_path / "j" / "train-catalog.csv").read_bytes()
    with pytest.raises(ValueError, match="empty"):
        loader.select_from_catalog(str(cat), "/data", 3, snr_min=99.0)


def test_validation_concat_paths_matches_jax(tmp_path):
    cat = tmp_path / "val.csv"
    write_catalog(cat, np.random.default_rng(4))
    cfg = types.SimpleNamespace(
        VALIDATION_CONCAT_COMPAT=True, VALIDATION=True,
        VALIDATION_CATALOG=str(cat), VALIDATION_DIR=str(tmp_path),
        VALIDATION_NUM=7, SNR_MIN=2.0, SNR_MAX=100.0, Z_MIN=2.0, Z_MAX=3.5,
        NUM_MASK=2)
    assert loader.validation_concat_paths(cfg, 3) == \
        jax_loader.validation_concat_paths(cfg, 3)
    cfg.VALIDATION_CONCAT_COMPAT = False
    assert loader.validation_concat_paths(cfg, 3) is None
    cfg.VALIDATION_CONCAT_COMPAT, cfg.VALIDATION = True, False
    with pytest.raises(ValueError, match="DATA.VALIDATION"):
        loader.validation_concat_paths(cfg, 3)
    cfg.VALIDATION, cfg.VALIDATION_CATALOG = True, str(tmp_path / "none.csv")
    with pytest.raises(FileNotFoundError):
        loader.validation_concat_paths(cfg, 3)


def test_taus_mu_and_residuals_match_jax():
    grid_j = qfa_tpu.make_grid(1030.0, 1600.0, 2e-3)
    grid = make_grid(1030.0, 1600.0, 2e-3)
    rng = np.random.default_rng(7)
    n = 40
    mask = rng.uniform(size=(n, grid.npix)) > 0.1
    flux_ok = mask | (rng.uniform(size=mask.shape) > 0.5)
    ds = loader.SpectraDataset(
        flux=np.where(mask, rng.uniform(0.5, 1.5, mask.shape), 0.0
                      ).astype(np.float32),
        error=np.where(mask, rng.uniform(0.05, 0.2, mask.shape), 0.0
                       ).astype(np.float32),
        mask=mask, zqso=rng.uniform(2.0, 3.5, n).astype(np.float32),
        paths=(), flux_ok=flux_ok)
    ds_j = jax_loader.SpectraDataset(*ds)
    taus = loader.compute_taus(grid, ds.zqso, chunk=16)
    taus_j = jax_loader.compute_taus(grid_j, ds_j.zqso)
    np.testing.assert_allclose(taus, taus_j, rtol=1e-5, atol=1e-7)
    for compat in (True, False):
        np.testing.assert_allclose(
            loader.estimate_mu(ds, grid, compat_denominator=compat),
            jax_loader.estimate_mu(ds_j, grid_j, compat_denominator=compat),
            rtol=1e-5)
    mu = loader.estimate_mu(ds, grid)
    res = loader.make_residuals(ds, grid, mu)
    ref = jax_loader.make_residuals(ds_j, grid_j, mu)
    np.testing.assert_allclose(res.delta.numpy(), np.asarray(ref.delta),
                               rtol=1e-5, atol=1e-6)
    for k in ("error", "zabs", "mask"):
        np.testing.assert_array_equal(getattr(res, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    half = loader.bf16_planes(res)
    assert half.delta.dtype == torch.bfloat16 and half.mask is res.mask
    assert loader.as_f32(half.error).dtype == torch.float32
