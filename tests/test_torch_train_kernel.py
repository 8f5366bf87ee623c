"""The port's whole-epoch trainer (on the CPU: its plain torch version)
against the JAX package's Pallas epoch kernel in interpret mode, and the
training leaf modules (Adam, clip, smoothing, full-state checkpoints)
against their JAX counterparts.

Inputs come from ``qfa_tpu.data.synthetic.generate`` on a grid of 25 blue
and 29 red pixels, as numpy, and go to both packages. Tolerances, and why:

* per-batch ``loss_sums``: rtol 1e-6 (float32 sums of ~30 NLLs of ~60 in
  different orders); ``n_real``: exact;
* params rtol 2e-4 atol 2e-6, m rtol 2e-3 atol 2e-6, v rtol 2e-3 atol
  1e-9: the JAX kernel's own tolerances against its XLA epoch
  (tests/test_epoch_kernel.py:85-98). Adam's first step is lr * sign(g),
  so a gradient within rounding of 0 may move by 2 lr in one version and
  not the other; these data have no such gradient;
* the analytic backward against ``torch.autograd``: rtol 1e-4 atol 1e-5
  (the two differentiate the same float32 likelihood in different
  orders);
* Adam, clip and smoothing: rtol 1e-6 atol 1e-7 (float32, one or two
  roundings apart); checkpoints: exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qfa_tpu
from qfa_tpu.data.synthetic import generate
from qfa_tpu.models import random_init as jax_random_init
from qfa_tpu.models.params import clip_params as jax_clip_params
from qfa_tpu.models.params import smooth_params as jax_smooth_params
from qfa_tpu.ops import loglam_row as jax_loglam_row
from qfa_tpu.ops import zq_column as jax_zq_column
from qfa_tpu.ops.epoch_kernel import fused_train_epoch as jax_fused_train_epoch
from qfa_tpu.physics.smoothing import sliding_mean as jax_sliding_mean
from qfa_tpu.physics.smoothing import smooth_curve as jax_smooth_curve
from qfa_tpu.train import TrainState as JaxTrainState
from qfa_tpu.train import adam as jax_adam
from qfa_tpu.train.checkpoint import load_state as jax_load_state
from qfa_tpu.train.checkpoint import save_state as jax_save_state
from qfa_tpu_torch.data.batch import SpectraBatch
from qfa_tpu_torch.models.params import (
    PARAM_NAMES,
    ParamBounds,
    QFAParams,
    clip_params,
    smooth_params,
)
from qfa_tpu_torch.models.qfa import loss_and_grads
from qfa_tpu_torch.ops import epoch_kernel
from qfa_tpu_torch.ops.common import loglam_row
from qfa_tpu_torch.ops.epoch_kernel import fused_train_epoch
from qfa_tpu_torch.physics.smoothing import sliding_mean, smooth_curve
from qfa_tpu_torch.train import TrainState, adam
from qfa_tpu_torch.train.checkpoint import load_state, save_state

TOL = {
    "params": dict(rtol=2e-4, atol=2e-6),
    "m": dict(rtol=2e-3, atol=2e-6),
    "v": dict(rtol=2e-3, atol=1e-9),
}
N, TB = 64, 8


@functools.lru_cache(maxsize=None)
def make_problem(nh: int):
    """64 spectra with contiguous masked chunks (row 5 fully masked) and
    start parameters, as numpy."""
    grid = qfa_tpu.make_grid(1150.0, 1300.0, 1e-3)
    true = jax_random_init(jax.random.key(nh), grid.npix, grid.nb, nh)
    true = true._replace(
        Psi=jnp.full((grid.npix,), 0.4), omega=jnp.full((grid.nb,), 0.7),
        tau0=jnp.asarray(0.12), c0=jnp.asarray(0.21), beta=jnp.asarray(1.7),
    )
    mu = jnp.full((grid.npix,), 1.1, jnp.float32)
    syn = generate(jax.random.key(nh + 1), true, mu, grid, N, mask_frac=0.15)
    b = syn.to_batch(mu)
    mask = np.array(b.mask, np.float32)
    mask[5] = 0.0
    data = dict(
        delta=np.array(b.delta, np.float32) * mask,
        error=np.array(b.error, np.float32) * mask,
        zabs=np.array(b.zabs, np.float32),
        mask=mask,
        zq=np.array(jax_zq_column(syn.zqso)),
    )
    p0 = jax_random_init(jax.random.key(nh + 2), grid.npix, grid.nb, nh)
    return grid, {k: np.asarray(v) for k, v in p0.as_dict().items()}, data


def jax_params(d):
    return qfa_tpu.models.QFAParams(**{k: jnp.asarray(v) for k, v in d.items()})


def zero_moments(p):
    return {k: np.zeros_like(v) for k, v in p.items()}


def layout_args(grid, data, layout, rows=None):
    """(zabs, mask, kwargs) of one layout, as numpy, for both packages."""
    sl = slice(None) if rows is None else rows
    if layout == "derived":
        return data["zq"][sl], None, dict(derive_zabs=True)
    return data["zabs"][sl], data["mask"][sl], {}


def run_jax(grid, p, m, v, data, perm, layout, planes="f32", **kw):
    zabs, mask, extra = layout_args(grid, data, layout)
    if layout == "derived":
        extra["loglam"] = jax_loglam_row(grid.wav)
    dt = jnp.bfloat16 if planes == "bf16" else jnp.float32
    return jax_fused_train_epoch(
        jax_params(p), jax_params(m), jax_params(v),
        jnp.asarray(data["delta"], dt), jnp.asarray(data["error"], dt),
        jnp.asarray(zabs), jnp.asarray(perm),
        None if mask is None else jnp.asarray(mask),
        interpret=True, **extra, **kw)


def run_port(grid, p, m, v, data, perm, layout, planes="f32", **kw):
    zabs, mask, extra = layout_args(grid, data, layout)
    if layout == "derived":
        zabs = zabs[:, :2]  # the port's (N, 2) zq column
        extra["loglam"] = loglam_row(grid.wav)
    t = torch.tensor
    dt = torch.bfloat16 if planes == "bf16" else torch.float32
    return fused_train_epoch(
        QFAParams.from_numpy(p), QFAParams.from_numpy(m),
        QFAParams.from_numpy(v), t(data["delta"]).to(dt),
        t(data["error"]).to(dt), t(zabs),
        t(np.asarray(perm)), None if mask is None else t(mask), **extra, **kw)


def assert_epoch_close(port, ref):
    np.testing.assert_allclose(port.loss_sums.numpy(),
                               np.asarray(ref.loss_sums), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(port.n_real.numpy(), np.asarray(ref.n_real))
    for part in ("params", "m", "v"):
        for k in PARAM_NAMES:
            np.testing.assert_allclose(
                getattr(getattr(port, part), k).detach().numpy(),
                np.asarray(getattr(getattr(ref, part), k)),
                err_msg=f"{part}.{k}", **TOL[part])


# (layout, nh, reference_norm, mxu_bf16, first epoch counter, epochs/call):
# counters 8 and 9 cross a step of the learning-rate decay (step 10)
CASES = [
    ("plane", 4, True, False, 0, 1),
    ("derived", 4, True, False, 0, 1),
    ("plane", 8, False, False, 0, 1),
    ("derived", 8, True, True, 8, 2),
    ("plane", 4, True, True, 25, 1),
    ("derived", 4, False, False, 11, 1),
]
# bfloat16 delta and error planes (TRAIN.BF16_PLANES), both layouts, bf16
# operands off and on: both packages convert the planes at load
BF16_PLANE_CASES = [
    ("plane", 4, True, False, 0, 1),
    ("plane", 8, True, True, 3, 1),
    ("derived", 4, True, False, 0, 1),
    ("derived", 8, False, True, 8, 2),
]


@pytest.mark.parametrize(
    "layout,nh,refnorm,mxu,epoch,n_epochs,planes",
    [pytest.param(*c, "f32", id="-".join(map(str, c))) for c in CASES]
    + [pytest.param(*c, "bf16", id="-".join(map(str, c)) + "-bf16planes")
       for c in BF16_PLANE_CASES])
def test_plain_epoch_matches_jax_kernel(layout, nh, refnorm, mxu, epoch,
                                        n_epochs, planes):
    grid, p0, data = make_problem(nh)
    m0 = zero_moments(p0)
    perm = np.stack([np.random.default_rng(e).permutation(N // TB)
                     for e in range(n_epochs)])
    kw = dict(epoch=epoch, n_batches=2, n_epochs=n_epochs, tile_batch=TB,
              learning_rate=1e-2, weight_decay=0.01, reference_norm=refnorm,
              mxu_bf16=mxu)
    ref = run_jax(grid, p0, m0, m0, data, perm, layout, planes, **kw)
    port = run_port(grid, p0, m0, m0, data, perm, layout, planes, **kw)
    assert port.loss_sums.shape == ((n_epochs, 2) if n_epochs > 1 else (2,))
    assert epoch_kernel.LAUNCHES == 0  # CPU tensors never launch
    assert_epoch_close(port, ref)


def test_padded_rows_are_inert_against_jax():
    """One zero tile after each batch's real tiles: the JAX kernel and the
    port agree, and n_real counts only the real rows (the fully masked
    real row 5 drops out in the plane layout)."""
    grid, p0, data = make_problem(4)
    pad = 2 * TB
    padded = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:],
                                             v.dtype)])
              for k, v in data.items()}
    tiles = N // TB
    perm = np.random.default_rng(3).permutation(tiles).reshape(2, -1)
    perm = np.concatenate([perm, [[tiles], [tiles + 1]]], axis=1).ravel()
    m0 = zero_moments(p0)
    kw = dict(epoch=0, n_batches=2, tile_batch=TB, learning_rate=1e-2,
              weight_decay=0.01)
    for layout, real in (("plane", N - 1), ("derived", N)):
        ref = run_jax(grid, p0, m0, m0, padded, perm, layout, **kw)
        port = run_port(grid, p0, m0, m0, padded, perm, layout, **kw)
        assert float(port.n_real.sum()) == real
        assert_epoch_close(port, ref)


def test_three_epochs_in_one_call_equal_three_chained_calls():
    grid, p0, data = make_problem(4)
    perm = np.stack([np.random.default_rng(10 + e).permutation(N // TB)
                     for e in range(3)])
    kw = dict(n_batches=4, tile_batch=TB, learning_rate=1e-2, mxu_bf16=True)
    m0 = zero_moments(p0)
    one = run_port(grid, p0, m0, m0, data, perm, "derived", epoch=7,
                   n_epochs=3, **kw)
    p, m, v = p0, m0, m0
    for e in range(3):
        out = run_port(grid, p, m, v, data, perm[e], "derived", epoch=7 + e,
                       **kw)
        assert torch.equal(out.loss_sums, one.loss_sums[e])
        p, m, v = (getattr(out, s).to_numpy() for s in ("params", "m", "v"))
    for part, chained in (("params", p), ("m", m), ("v", v)):
        for k in PARAM_NAMES:
            np.testing.assert_array_equal(
                getattr(getattr(one, part), k).detach().numpy(), chained[k],
                err_msg=f"{part}.{k}")


@pytest.mark.parametrize("layout", ["plane", "derived"])
def test_analytic_gradient_matches_autograd(layout):
    """One batch from zero moments: the first moment is (1 - b1) g, so the
    plain version's count-normalized gradient is m / (1 - b1); it equals
    torch.autograd through the port's batch_nll, normalized by the same
    counts."""
    grid, p0, data = make_problem(4)
    m0 = zero_moments(p0)
    out = run_port(grid, p0, m0, m0, data, np.arange(N // TB), layout,
                   epoch=0, n_batches=1, tile_batch=TB, weight_decay=0.0)
    omb1 = float(np.float32(1.0) - np.float32(0.9))
    t = torch.tensor
    batch = SpectraBatch(delta=t(data["delta"]), error=t(data["error"]),
                         zabs=t(data["zabs"]), mask=t(data["mask"]),
                         weight=torch.ones(N))
    _, grads = loss_and_grads(QFAParams.from_numpy(p0), batch)
    for k in PARAM_NAMES:
        analytic = getattr(out.m, k).detach().numpy() / omb1
        np.testing.assert_allclose(analytic, getattr(grads, k).numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_guards_and_not_ported_modes():
    grid, p0, data = make_problem(4)
    m0 = zero_moments(p0)
    kw = dict(epoch=0, n_batches=2, tile_batch=TB)
    perm = np.arange(N // TB)
    for bad in (dict(sync_grads=True), dict(pending=(1, 2, 3))):
        with pytest.raises(NotImplementedError, match="A10"):
            run_port(grid, p0, m0, m0, data, perm, "plane", **kw, **bad)
    with pytest.raises(ValueError, match="entries"):
        run_port(grid, p0, m0, m0, data, perm[:-1], "plane", **kw)
    with pytest.raises(ValueError, match="lie in"):
        run_port(grid, p0, m0, m0, data, perm + 1, "plane", **kw)
    with pytest.raises(ValueError, match="derive_zabs"):
        # a zq column passed as a plane
        run_port(grid, p0, m0, m0, {**data, "zabs": data["zq"][:, :2]}, perm,
                 "plane", **kw)
    # bwd_wide gives the results of False by its definition
    a = run_port(grid, p0, m0, m0, data, perm, "plane", **kw)
    b = run_port(grid, p0, m0, m0, data, perm, "plane", bwd_wide=True, **kw)
    assert torch.equal(a.params.F, b.params.F)
    # bf16 planes run on the plain version
    t = torch.tensor
    c = fused_train_epoch(
        QFAParams.from_numpy(p0), QFAParams.from_numpy(m0),
        QFAParams.from_numpy(m0), t(data["delta"]).bfloat16(),
        t(data["error"]).bfloat16(), t(data["zabs"]), t(perm),
        t(data["mask"]), **kw)
    assert torch.isfinite(c.params.F).all()
    meta = torch.empty((N, grid.npix), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_train_epoch(QFAParams.from_numpy(p0), QFAParams.from_numpy(m0),
                          QFAParams.from_numpy(m0), meta, meta,
                          meta[:, :grid.nb], perm, None, **kw)


def tree(rng, npix=40, nb=15, nh=3):
    t = {"F": rng.normal(size=(npix, nh)), "Psi": rng.uniform(-0.5, 3, npix),
         "omega": rng.uniform(-0.5, 3, nb), "tau0": rng.uniform(-1, 2),
         "c0": rng.uniform(-7, 7), "beta": rng.uniform(-1, 7)}
    return {k: np.asarray(v, np.float32) for k, v in t.items()}


@pytest.mark.parametrize("epoch", [0, 9, 37])
def test_adam_update_matches_jax(epoch):
    rng = np.random.default_rng(epoch)
    p, g, m = tree(rng), tree(rng), tree(rng)
    v = {k: np.abs(x) for k, x in tree(rng).items()}
    cfg = dict(learning_rate=3e-3, weight_decay=0.1, decay_alpha=0.9,
               decay_step=10)
    new_p, new_s = adam.apply_update(
        QFAParams.from_numpy(p), QFAParams.from_numpy(g),
        adam.AdamState.from_numpy(m, v, epoch), adam.AdamConfig(**cfg))
    ref_p, ref_s = jax_adam.apply_update(
        jax_params(p), jax_params(g),
        jax_adam.AdamState(m=jax_params(m), v=jax_params(v),
                           epoch=jnp.asarray(epoch, jnp.int32)),
        jax_adam.AdamConfig(**cfg))
    assert new_s.epoch == epoch and adam.next_epoch(new_s).epoch == epoch + 1
    for got, want in ((new_p, ref_p), (new_s.m, ref_s.m), (new_s.v, ref_s.v)):
        for k in PARAM_NAMES:
            np.testing.assert_allclose(getattr(got, k).detach().numpy(),
                                       np.asarray(getattr(want, k)),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(
        adam.scheduled_lr(adam.AdamConfig(**cfg), epoch),
        np.asarray(jax_adam.scheduled_lr(jax_adam.AdamConfig(**cfg),
                                         jnp.asarray(epoch))), rtol=1e-6)


def test_clip_and_smoothing_match_jax():
    rng = np.random.default_rng(1)
    p = tree(rng, npix=70, nb=30)
    bounds = ParamBounds(var_min=0.01, var_max=1.5, tau0_min=0.1,
                         tau0_max=0.9, beta_min=0.5, beta_max=4.0,
                         c0_min=-2.0, c0_max=2.0)
    jb = qfa_tpu.models.params.ParamBounds(*bounds)
    for got, want in ((clip_params(QFAParams.from_numpy(p), bounds),
                       jax_clip_params(jax_params(p), jb)),
                      (smooth_params(QFAParams.from_numpy(p)),
                       jax_smooth_params(jax_params(p)))):
        for k in PARAM_NAMES:
            np.testing.assert_allclose(getattr(got, k).detach().numpy(),
                                       np.asarray(getattr(want, k)),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    x = rng.normal(size=(9, 33)).astype(np.float32)
    np.testing.assert_allclose(
        sliding_mean(torch.tensor(x), 5, axis=1).numpy(),
        np.asarray(jax_sliding_mean(jnp.asarray(x), 5, axis=1)),
        rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="odd"):
        sliding_mean(torch.tensor(x), 4)
    curve = rng.normal(size=200)
    np.testing.assert_array_equal(smooth_curve(curve, 16),
                                  jax_smooth_curve(curve, 16))


def test_full_state_checkpoints_cross_load(tmp_path):
    """save_state/load_state in both directions, key for key."""
    rng = np.random.default_rng(2)
    p, m, v = tree(rng), tree(rng), tree(rng)
    mu = rng.normal(size=40).astype(np.float32)
    jax_path, port_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_save_state(jax_path, JaxTrainState(
        jax_params(p), jax_adam.AdamState(m=jax_params(m), v=jax_params(v),
                                          epoch=jnp.asarray(12, jnp.int32))),
        mu)
    st, mu_t = load_state(jax_path)
    assert st.opt_state.epoch == 12
    np.testing.assert_array_equal(mu_t.numpy(), mu)
    for got, want in ((st.params.to_numpy(), p),
                      (st.opt_state.to_numpy()[0], m),
                      (st.opt_state.to_numpy()[1], v)):
        for k in PARAM_NAMES:
            np.testing.assert_array_equal(got[k], want[k])
    save_state(port_path, TrainState(
        QFAParams.from_numpy(p), adam.AdamState.from_numpy(m, v, 12)),
        torch.tensor(mu))
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    jst, jmu = jax_load_state(port_path)
    assert int(jst.opt_state.epoch) == 12
    np.testing.assert_array_equal(np.asarray(jst.opt_state.v.F), v["F"])
