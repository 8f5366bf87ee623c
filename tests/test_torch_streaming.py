"""The port's host-streaming trainer and resident autograd trainer against
the JAX package, on the CPU: ``stream_batches``, ``fit_streaming`` (with
the autograd step and with the fused step, whose plain version stands for
the CUDA kernel here, against ``make_pallas_step_fn(interpret=True)``),
``fit``, ``make_epoch_fn``, ``train_epoch``, ``make_sliced_epoch_fn``, the
index functions, ``ResidualDataset.gather``, the host residuals and the
synthetic spectra.

Inputs come from ``qfa_tpu.data.synthetic.generate`` on the JAX tests'
grid (1030-1090 A: 25 pixels, all blue; nh 3) and go to both
packages as numpy; the port's shuffles are fed JAX's own permutations
(``fold_in(key, epoch)``), the streaming shuffles are the same numpy
draws in both. Tolerances, and why: batches, indices, gathers and
checkpoint lists are identical; per-epoch losses rel 1e-5 and parameters
rtol 1e-4 atol 1e-6 (the one-step tolerances of
tests/test_fused_step.py:107-129: float32 sums in different orders, over
12 updates and two smoothings); runs of the port against itself (resume,
kill and resume) are exact.
"""

import dataclasses
import functools
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qfa_tpu
from qfa_tpu.data import loader as jax_loader
from qfa_tpu.data.loader import ResidualDataset as JaxResidualDataset
from qfa_tpu.data.streaming import HostResiduals as JaxHostResiduals
from qfa_tpu.data.streaming import make_host_residuals as jax_host_residuals
from qfa_tpu.data.streaming import stream_batches as jax_stream_batches
from qfa_tpu.data.synthetic import SyntheticSpectra as JaxSynthetic
from qfa_tpu.data.synthetic import generate as jax_generate
from qfa_tpu.models import random_init as jax_random_init
from qfa_tpu.train import TrainConfig as JaxTrainConfig
from qfa_tpu.train import TrainState as JaxTrainState
from qfa_tpu.train import adam as jax_adam
from qfa_tpu.train import fit as jax_fit
from qfa_tpu.train import fit_streaming as jax_fit_streaming
from qfa_tpu.train.loop import make_epoch_fn as jax_make_epoch_fn
from qfa_tpu.train.loop import make_pallas_step_fn as jax_pallas_step_fn
from qfa_tpu.train.loop import make_sliced_epoch_fn as jax_make_sliced
from qfa_tpu_torch.data import loader
from qfa_tpu_torch.data.grid import make_grid
from qfa_tpu_torch.data.loader import ResidualDataset
from qfa_tpu_torch.data.streaming import (
    HostResiduals,
    make_host_residuals,
    stream_batches,
)
from qfa_tpu_torch.data.synthetic import SyntheticSpectra, generate
from qfa_tpu_torch.models.params import PARAM_NAMES, QFAParams
from qfa_tpu_torch.train import (
    TrainConfig,
    TrainState,
    adam,
    fit,
    fit_streaming,
    make_epoch_fn,
    make_fused_step_fn,
    make_sliced_epoch_fn,
    make_step_fn,
    train_epoch,
)
from qfa_tpu_torch.train.checkpoint import latest_checkpoint, load_state

PLANES = ("delta", "error", "zabs", "mask")


@functools.lru_cache(maxsize=None)
def make_problem():
    """56 spectra (40 to train, 16 held out), start params and mu, numpy."""
    grid = qfa_tpu.make_grid(1030.0, 1090.0, 1e-3)
    true = jax_random_init(jax.random.key(0), grid.npix, grid.nb, 3)
    true = true._replace(Psi=jnp.full((grid.npix,), 0.3),
                         omega=jnp.full((grid.nb,), 0.5))
    mu = jnp.full((grid.npix,), 1.1, jnp.float32)
    syn = jax_generate(jax.random.key(1), true, mu, grid, 56, mask_frac=0.1)
    b = syn.to_batch(mu)
    data = {k: np.array(getattr(b, k), np.float32) for k in PLANES}
    p0 = jax_random_init(jax.random.key(21), grid.npix, grid.nb, 3)
    return grid, data, {k: np.asarray(v) for k, v in p0.as_dict().items()}, \
        np.asarray(mu)


def host(data, rows=slice(0, 40)):
    return {k: v[rows] for k, v in data.items()}


def jax_params(p):
    return qfa_tpu.models.QFAParams(**{k: jnp.asarray(v) for k, v in p.items()})


def jax_dataset(d):
    return JaxResidualDataset(**{k: jnp.asarray(d[k]) for k in PLANES})


def port_dataset(d):
    return ResidualDataset(**{k: torch.tensor(d[k]) for k in PLANES})


def assert_params_close(port, ref):
    for k in PARAM_NAMES:
        np.testing.assert_allclose(getattr(port, k).detach().numpy(),
                                   np.asarray(getattr(ref, k)), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


class JaxRows:
    """The row permutations jax fit draws: ``permutation(fold_in(key, e))``."""

    def __init__(self, seed):
        self.key = jax.random.key(seed)

    def rows(self, epoch, n):
        k = jax.random.fold_in(self.key, epoch)
        return torch.tensor(np.asarray(jax.random.permutation(k, n)))


# ---- stream_batches ------------------------------------------------------


@pytest.mark.parametrize("n,drop", [(40, False), (37, False), (40, True),
                                    (32, False)])
def test_stream_batches_match_jax(n, drop):
    """Same numpy generator, same batches: rows, order and weights."""
    grid, data, p0, mu = make_problem()
    h = host(data, slice(0, n))
    ref = list(jax_stream_batches(JaxHostResiduals(**h), 16,
                                  np.random.default_rng(n),
                                  drop_remainder=drop))
    got = list(stream_batches(HostResiduals(**h), 16,
                              np.random.default_rng(n), device="cpu",
                              drop_remainder=drop))
    assert len(got) == len(ref) == (n // 16 if drop else -(-n // 16))
    for g, r in zip(got, ref):
        for k in (*PLANES, "weight"):
            np.testing.assert_array_equal(getattr(g, k).numpy(),
                                          np.asarray(getattr(r, k)), err_msg=k)


@pytest.mark.parametrize("prefetch", [0, 2, 5])
def test_stream_batches_serve_every_spectrum_once(prefetch):
    grid, data, p0, mu = make_problem()
    h = host(data, slice(0, 37))
    seen, total_w = [], 0.0
    for batch in stream_batches(HostResiduals(**h), 16,
                                np.random.default_rng(0), prefetch=prefetch,
                                device="cpu"):
        w = batch.weight.numpy()
        total_w += w.sum()
        real = batch.delta.numpy()[w > 0]
        seen += [int(np.argmin(np.abs(h["delta"] - row).sum(axis=1)))
                 for row in real]
        # pad rows duplicate row 0 at weight 0
        for row in batch.delta.numpy()[w == 0]:
            np.testing.assert_array_equal(row, h["delta"][0])
    assert total_w == 37.0 and sorted(seen) == list(range(37))


def test_make_host_residuals_match_jax():
    grid = make_grid(1030.0, 1300.0, 2e-3)
    grid_j = qfa_tpu.make_grid(1030.0, 1300.0, 2e-3)
    rng = np.random.default_rng(2)
    mask = rng.uniform(size=(12, grid.npix)) > 0.1
    ds = loader.SpectraDataset(
        flux=np.where(mask, rng.uniform(0.5, 1.5, mask.shape), 0.0
                      ).astype(np.float32),
        error=np.where(mask, rng.uniform(0.05, 0.2, mask.shape), 0.0
                       ).astype(np.float32),
        mask=mask, zqso=rng.uniform(2.0, 3.5, 12).astype(np.float32),
        paths=(), flux_ok=mask)
    mu = loader.estimate_mu(ds, grid)
    got = make_host_residuals(ds, grid, mu)
    ref = jax_host_residuals(jax_loader.SpectraDataset(*ds), grid_j, mu)
    assert all(isinstance(x, np.ndarray) for x in got)
    np.testing.assert_allclose(got.delta, ref.delta, rtol=1e-5, atol=1e-6)
    for k in ("error", "zabs", "mask"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))


# ---- fit_streaming -------------------------------------------------------


CFG = dict(n_epochs=4, batch_size=16, learning_rate=1e-2, weight_decay=0.0,
           smooth_interval=2, save_interval=2)


@functools.lru_cache(maxsize=None)
def jax_streaming_run(engine, out):
    grid, data, p0, mu = make_problem()
    cfg = JaxTrainConfig(**CFG)
    step = jax_pallas_step_fn(cfg, tile_batch=16, interpret=True) \
        if engine == "fused" else None
    params, hist = jax_fit_streaming(
        jax_params(p0), JaxHostResiduals(**host(data)), jnp.asarray(mu), cfg,
        seed=5, step_fn=step, output_dir=out,
        val_data=jax_dataset(host(data, slice(40, 56))))
    return params, hist


@pytest.mark.parametrize("engine", ["autograd", "fused"])
def test_fit_streaming_matches_jax(tmp_path, caplog, engine):
    """4 epochs of 40 spectra at batch 16 (tail 8), smoothing and saving
    every 2 epochs, held-out validation: the port on the CPU against JAX
    fit_streaming, with the default step and with the fused step."""
    grid, data, p0, mu = make_problem()
    ref_p, ref_h = jax_streaming_run(engine, str(tmp_path / "jax"))
    cfg = TrainConfig(**CFG)
    step = make_fused_step_fn(cfg, tile_batch=16) if engine == "fused" \
        else None
    with caplog.at_level(logging.INFO):
        p, h = fit_streaming(
            QFAParams.from_numpy(p0), HostResiduals(**host(data)), mu, cfg,
            seed=5, step_fn=step, output_dir=str(tmp_path / "port"),
            val_data=port_dataset(host(data, slice(40, 56))), device="cpu",
            logger=logging.getLogger("test_torch_streaming"))
    np.testing.assert_allclose(h, ref_h, rtol=1e-5)
    assert_params_close(p, ref_p)
    assert sorted(os.listdir(tmp_path / "port" / "checkpoints")) == [
        "model_parameters_epoch_02.npz", "model_parameters_epoch_04.npz",
        "state_epoch_02.npz", "state_epoch_04.npz"]
    vals = [r.message for r in caplog.records
            if r.name == "test_torch_streaming" and "val_loss" in r.message]
    assert len(vals) == 4


def test_fit_streaming_resumes_the_uninterrupted_run(tmp_path):
    """Killed after 2 epochs and resumed from the full state to 4: the same
    trajectory, bit for bit."""
    grid, data, p0, mu = make_problem()
    cfg = TrainConfig(**CFG)
    hd = HostResiduals(**host(data))
    p_a, h_a = fit_streaming(QFAParams.from_numpy(p0), hd, mu, cfg, seed=5,
                             device="cpu")
    out = str(tmp_path / "b")
    fit_streaming(QFAParams.from_numpy(p0), hd, mu,
                  dataclasses.replace(cfg, n_epochs=2), seed=5,
                  output_dir=out, device="cpu")
    state, _ = load_state(latest_checkpoint(f"{out}/checkpoints"))
    assert state.opt_state.epoch == 2
    p_b, h_b = fit_streaming(None, hd, mu, cfg, seed=5, output_dir=out,
                             initial_state=state, device="cpu")
    assert h_b == h_a[2:]
    for k in PARAM_NAMES:
        assert torch.equal(getattr(p_a, k), getattr(p_b, k)), k


def test_fit_streaming_stops_on_negative_loss(tmp_path):
    """Tiny residuals drive the loss negative: smooth, save and stop."""
    grid, data, p0, mu = make_problem()
    n, npix = 32, data["delta"].shape[1]
    tiny = HostResiduals(
        delta=np.full((n, npix), 1e-4, np.float32),
        error=np.full((n, npix), 1e-3, np.float32),
        zabs=np.full((n, data["zabs"].shape[1]), 2.5, np.float32),
        mask=np.ones((n, npix), np.float32))
    cfg = TrainConfig(n_epochs=50, batch_size=16, learning_rate=1e-2,
                      weight_decay=0.0, smooth_interval=1000,
                      save_interval=1000)
    _, h = fit_streaming(QFAParams.from_numpy(p0), tiny, mu, cfg,
                         output_dir=str(tmp_path), device="cpu")
    assert len(h) < 50 and h[-1] < 0
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        f"model_parameters_epoch_{len(h):02d}.npz",
        f"state_epoch_{len(h):02d}.npz"]


# ---- the resident autograd trainer ---------------------------------------


def test_fit_matches_jax(tmp_path):
    """fit on 40 resident spectra at batch 16 (the tail trains at weight
    0 padding), 4 epochs, smoothing and saving every 2, validation, fed
    JAX's epoch permutations; then a resume from epoch 2 equals the run."""
    grid, data, p0, mu = make_problem()
    cfg = dict(CFG)
    ref_p, ref_h = jax_fit(
        jax_params(p0), jax_dataset(host(data)), jnp.asarray(mu),
        JaxTrainConfig(**cfg), key=jax.random.key(12),
        output_dir=str(tmp_path / "jax"),
        val_data=jax_dataset(host(data, slice(40, 56))))
    p, h = fit(QFAParams.from_numpy(p0), port_dataset(host(data)), mu,
               TrainConfig(**cfg), shuffler=JaxRows(12),
               output_dir=str(tmp_path / "port"),
               val_data=port_dataset(host(data, slice(40, 56))))
    np.testing.assert_allclose(h, ref_h, rtol=1e-5)
    assert_params_close(p, ref_p)
    assert sorted(os.listdir(tmp_path / "port" / "checkpoints")) == \
        sorted(os.listdir(tmp_path / "jax" / "checkpoints"))
    state, _ = load_state(str(tmp_path / "port/checkpoints/state_epoch_02.npz"))
    p_r, h_r = fit(None, port_dataset(host(data)), mu, TrainConfig(**cfg),
                   shuffler=JaxRows(12), initial_state=state)
    assert h_r == h[2:]
    for k in PARAM_NAMES:
        assert torch.equal(getattr(p_r, k), getattr(p, k)), k


def test_epoch_fn_and_train_epoch_match_jax():
    """make_epoch_fn fed JAX's epoch_indices(fold_in(key, e)) (tail batch
    at weight 0), then train_epoch fed the same permutation, against the
    JAX epoch function."""
    grid, data, p0, mu = make_problem()
    cfg = dict(batch_size=16, learning_rate=1e-2, weight_decay=0.01)
    key = jax.random.fold_in(jax.random.key(3), 1)
    ei = jax_loader.epoch_indices(key, 40, 16)
    pj = jax_params(p0)
    st_j, loss_j = jax_make_epoch_fn(JaxTrainConfig(**cfg))(
        JaxTrainState(pj, jax_adam.init(pj)), jax_dataset(host(data)),
        ei.idx, ei.weight)
    params = QFAParams.from_numpy(p0)
    st, loss = make_epoch_fn(TrainConfig(**cfg))(
        TrainState(params, adam.init(params)), port_dataset(host(data)),
        np.asarray(ei.idx), np.asarray(ei.weight))
    assert float(loss) == pytest.approx(float(loss_j), rel=1e-5)
    assert st.opt_state.epoch == 1
    assert_params_close(st.params, st_j.params)
    perm = np.asarray(jax.random.permutation(key, 40))
    params = QFAParams.from_numpy(p0)
    st2, loss2 = train_epoch(TrainState(params, adam.init(params)),
                             port_dataset(host(data)), None,
                             TrainConfig(**cfg), perm=perm)
    assert loss2 == float(loss)
    for k in PARAM_NAMES:
        assert torch.equal(getattr(st2.params, k), getattr(st.params, k))


def test_tail_epoch_equals_the_padded_step():
    """A pure-tail epoch (8 rows, batch 16) is exactly the update of the
    explicitly padded single step: weight-0 rows contribute nothing."""
    from qfa_tpu_torch.data.batch import pad_batch

    grid, data, p0, mu = make_problem()
    small = port_dataset(host(data, slice(0, 8)))
    cfg = TrainConfig(batch_size=16, learning_rate=1e-2, weight_decay=0.01)
    ei = loader.epoch_indices(torch.Generator().manual_seed(10), 8, 16)
    params = QFAParams.from_numpy(p0)
    st_e, loss_e = make_epoch_fn(cfg)(TrainState(params, adam.init(params)),
                                      small, ei.idx, ei.weight)
    params = QFAParams.from_numpy(p0)
    st_s, loss_s = make_step_fn(cfg)(TrainState(params, adam.init(params)),
                                     pad_batch(small.gather(ei.idx[0, :8]), 16))
    assert float(loss_e) == pytest.approx(float(loss_s), rel=1e-6)
    for k in PARAM_NAMES:
        np.testing.assert_allclose(getattr(st_e.params, k).detach().numpy(),
                                   getattr(st_s.params, k).detach().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_fit_trains_the_tail_batch():
    """A pixel observed only by the rows of epoch 0's tail batch moves."""
    grid, data, p0, mu = make_problem()
    rows = JaxRows(12).rows(0, 40)
    tail_rows = rows[32:].numpy()
    d = host(data)
    j = 5
    d["mask"] = d["mask"].copy()
    d["mask"][:, j] = 0.0
    d["mask"][tail_rows, j] = 1.0
    cfg = TrainConfig(n_epochs=1, batch_size=16, learning_rate=1e-2,
                      weight_decay=0.0, smooth_interval=100)
    p, h = fit(QFAParams.from_numpy(p0), port_dataset(d), mu, cfg,
               shuffler=JaxRows(12))
    assert np.isfinite(h).all()
    assert abs(float(p.Psi.detach()[j]) - float(p0["Psi"][j])) > 1e-7


def test_sliced_epoch_matches_gathered_and_jax():
    grid, data, p0, mu = make_problem()
    d = host(data, slice(0, 48))
    b = 16
    order = np.random.default_rng(0).permutation(3)
    offsets = order * b
    idx = np.stack([np.arange(o, o + b) for o in offsets])
    cfg = TrainConfig(batch_size=b, learning_rate=1e-2, weight_decay=0.01)
    params = QFAParams.from_numpy(p0)
    st_g, loss_g = make_epoch_fn(cfg)(TrainState(params, adam.init(params)),
                                      port_dataset(d), idx)
    params = QFAParams.from_numpy(p0)
    st_s, loss_s = make_sliced_epoch_fn(cfg)(
        TrainState(params, adam.init(params)), port_dataset(d), offsets)
    assert float(loss_s) == pytest.approx(float(loss_g), rel=1e-6)
    for k in PARAM_NAMES:
        np.testing.assert_allclose(getattr(st_s.params, k).detach().numpy(),
                                   getattr(st_g.params, k).detach().numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    pj = jax_params(p0)
    st_j, loss_j = jax_make_sliced(JaxTrainConfig(**dataclasses.asdict(
        cfg) | {"options": qfa_tpu.models.qfa.ModelOptions(),
                "bounds": qfa_tpu.models.params.DEFAULT_BOUNDS}))(
        JaxTrainState(pj, jax_adam.init(pj)), jax_dataset(d),
        jnp.asarray(offsets, jnp.int32))
    assert float(loss_s) == pytest.approx(float(loss_j), rel=1e-5)
    assert_params_close(st_s.params, st_j.params)


# ---- index functions, gather, synthetic spectra --------------------------


def test_index_functions_match_jax():
    key = jax.random.key(4)
    perm = np.asarray(jax.random.permutation(key, 37))
    np.testing.assert_array_equal(
        loader.batch_indices(None, 37, 16, perm=perm).numpy(),
        np.asarray(jax_loader.batch_indices(key, 37, 16)))
    ei, ref = loader.epoch_indices(None, 37, 16, perm=perm), \
        jax_loader.epoch_indices(key, 37, 16)
    np.testing.assert_array_equal(ei.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(ei.weight.numpy(), np.asarray(ref.weight))
    g = loader.epoch_indices(torch.Generator().manual_seed(0), 37, 16)
    assert sorted(g.idx[g.weight > 0].tolist()) == list(range(37))
    with pytest.raises(NotImplementedError, match="epoch_indices"):
        loader.batch_indices(None, 37, 16, perm=perm, drop_remainder=False)
    with pytest.raises(ValueError, match="permutation"):
        loader.batch_indices(None, 37, 16, perm=np.zeros(37, int))


def test_gather_matches_jax():
    grid, data, p0, mu = make_problem()
    idx = np.array([3, 0, 7, 0])
    wt = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    for w in (None, wt):
        got = port_dataset(data).gather(idx, w)
        ref = jax_dataset(data).gather(jnp.asarray(idx),
                                       None if w is None else jnp.asarray(w))
        for k in (*PLANES, "weight"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(ref, k)))


def test_synthetic_spectra_match_jax_given_its_draws():
    """to_batch and to_dataset on JAX's draws; the port's own draws follow
    the model (shapes, masked chunk, finite values, noise scale)."""
    grid_j = qfa_tpu.make_grid(1030.0, 1090.0, 1e-3)
    grid = make_grid(1030.0, 1090.0, 1e-3)
    true = jax_random_init(jax.random.key(0), grid.npix, grid.nb, 3)
    mu = np.full((grid.npix,), 1.1, np.float32)
    syn = jax_generate(jax.random.key(1), true, jnp.asarray(mu), grid_j, 12,
                       mask_frac=0.2)
    port = SyntheticSpectra(*(torch.tensor(np.asarray(x)) for x in syn))
    for law in ("becker", "fg"):
        got, ref = port.to_batch(mu, law), syn.to_batch(jnp.asarray(mu), law)
        for k in (*PLANES, "weight"):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(ref, k)),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    ds, ds_j = port.to_dataset(), JaxSynthetic.to_dataset(syn)
    for k in ("flux", "error", "mask", "zqso", "flux_ok"):
        np.testing.assert_array_equal(getattr(ds, k), getattr(ds_j, k))
    params = QFAParams.from_numpy({k: np.asarray(v)
                                   for k, v in true.as_dict().items()})
    own = generate(params, mu, grid, 400, mask_frac=0.2,
                   generator=torch.Generator().manual_seed(0))
    assert own.flux.shape == (400, grid.npix) and own.zabs.shape == \
        (400, grid.nb) and own.h.shape == (400, 3)
    assert torch.isfinite(own.flux).all()
    span = int(0.2 * grid.npix)
    assert (own.mask.sum(dim=1) == grid.npix - span).all()
    assert 2.0 <= float(own.zqso.min()) and float(own.zqso.max()) <= 3.5
    # the flux scatters about A * continuum with the model's variance
    from qfa_tpu_torch.models.qfa import absorption
    from qfa_tpu_torch.physics.tau import omega_func

    p = {k: v.detach() for k, v in params.named_parameters()}
    amp = absorption(own.zabs, grid.nr)
    zdep = omega_func(own.zabs, p["tau0"], p["beta"], p["c0"])
    var = amp * amp * p["Psi"] + p["omega"] * zdep + own.error ** 2
    z2 = float(((own.flux - amp * own.continuum) ** 2 / var).mean())
    assert 0.9 < z2 < 1.1
