"""The port's per-step engine against the JAX package: the step kernel's
plain version ``ops.fused_step.fused_loss_grads_plain`` (what the CUDA
kernel ``csrc/step.cu`` is held against on the card) against the Pallas
``_step_kernel`` in interpret mode, and the step functions against
``make_pallas_step_fn(interpret=True)`` and ``make_step_fn``.

Inputs come from ``qfa_tpu.data.synthetic.generate`` on the JAX tests'
grid (25 blue and 33 red pixels), as numpy, and go to both packages.
Tolerances, and why:

* loss sums rel 1e-6 and each gradient to atol 1e-4 * max|g| (the form
  of tests/test_fused_step.py:33-56: float32 sums in different orders);
  counts exact (sums of 0/1 values). Low noise: loss rel 2e-4, the
  Woodbury NLL's fp32 cancellation (ROADMAP C);
* one training step: loss rel 1e-5, params rtol 1e-4 atol 1e-6
  (tests/test_fused_step.py:107-129).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qfa_tpu
from qfa_tpu.data.batch import SpectraBatch as JaxBatch
from qfa_tpu.data.batch import pad_batch as jax_pad_batch
from qfa_tpu.data.synthetic import generate
from qfa_tpu.models import random_init as jax_random_init
from qfa_tpu.models.qfa import ModelOptions as JaxOptions
from qfa_tpu.models.qfa import summed_stats as jax_summed_stats
from qfa_tpu.ops.fused_step import TAU_LAW_ABC
from qfa_tpu.ops.fused_step import finish_f_gradient as jax_finish
from qfa_tpu.ops.fused_step import fused_loss_grads as jax_fused
from qfa_tpu.train import TrainConfig as JaxTrainConfig
from qfa_tpu.train import TrainState as JaxTrainState
from qfa_tpu.train import adam as jax_adam
from qfa_tpu.train.loop import make_pallas_step_fn as jax_pallas_step_fn
from qfa_tpu.train.loop import make_step_fn as jax_step_fn
from qfa_tpu_torch.data.batch import SpectraBatch, pad_batch
from qfa_tpu_torch.models.params import PARAM_NAMES, QFAParams
from qfa_tpu_torch.models.qfa import ModelOptions, summed_stats
from qfa_tpu_torch.ops import fused_step
from qfa_tpu_torch.ops.common import tri_idx
from qfa_tpu_torch.ops.fused_step import (
    finish_f_gradient,
    fused_loss_grads,
    fused_loss_grads_plain,
)
from qfa_tpu_torch.train import (
    TrainConfig,
    TrainState,
    adam,
    make_fused_step_fn,
    make_step_fn,
)

N = 16


@functools.lru_cache(maxsize=None)
def make_problem(nh: int = 8, noise: str = "moderate"):
    """16 spectra with a 25 % masked chunk each, and parameters (numpy)."""
    grid = qfa_tpu.make_grid(1030.0, 1300.0, 1e-3)
    params = jax_random_init(jax.random.key(0), grid.npix, grid.nb, nh)
    params = params._replace(tau0=jnp.asarray(0.15), c0=jnp.asarray(0.24),
                             beta=jnp.asarray(1.33))
    err = 0.1
    if noise == "low":
        params = params._replace(Psi=jnp.full((grid.npix,), 2e-3),
                                 omega=jnp.full((grid.nb,), 3e-3))
        err = 0.03
    mu = jnp.ones((grid.npix,), jnp.float32)
    syn = generate(jax.random.key(1), params, mu, grid, N, mask_frac=0.25,
                   error_scale=err)
    b = syn.to_batch(mu)
    batch = {k: np.array(getattr(b, k), np.float32) for k in JaxBatch._fields}
    return grid, {k: np.asarray(v) for k, v in params.as_dict().items()}, batch


def jax_batch(batch):
    return JaxBatch(**{k: jnp.asarray(v) for k, v in batch.items()})


def port_batch(batch):
    return SpectraBatch(**{k: torch.tensor(v) for k, v in batch.items()})


def jax_params(p):
    return qfa_tpu.models.QFAParams(**{k: jnp.asarray(v) for k, v in p.items()})


def tail_batch(batch, n_real=11):
    """The stream's tail batch: the first ``n_real`` rows, then copies of
    row 0 at weight 0 (``data.streaming.stream_batches``)."""
    idx = np.concatenate([np.arange(n_real), np.zeros(N - n_real, int)])
    out = {k: v[idx] for k, v in batch.items()}
    out["weight"] = (np.arange(N) < n_real).astype(np.float32)
    return out


def scalar_count_batch(batch):
    """Row 1 keeps its blue pixels but has weight 0; row 2 has weight 1 and
    no observed blue pixel: the scalar count counts neither."""
    out = {k: v.copy() for k, v in batch.items()}
    out["weight"][1] = 0.0
    nb = out["zabs"].shape[1]
    out["mask"][2, :nb] = 0.0
    return out


BATCHES = {
    "plain": lambda b: b,
    "padded": lambda b: {k: np.asarray(v) for k, v in
                         jax_pad_batch(jax_batch(b), 24)._asdict().items()},
    "tail duplicates row 0": tail_batch,
    "scalar count after weight": scalar_count_batch,
}


@functools.lru_cache(maxsize=None)
def jax_outputs(nh, noise, case, law="becker"):
    grid, p, base = make_problem(nh, noise)
    batch = BATCHES[case](base)
    out = jax_fused(jax_params(p), jax_batch(batch), tau_which=law,
                    tile_batch=batch["delta"].shape[0], interpret=True)
    return batch, {
        "loss_sum": float(out.loss_sum),
        "grads": {k: np.asarray(getattr(out.grads, k)) for k in PARAM_NAMES},
        "pix": np.asarray(out.counts.pix),
        "scalar": float(out.counts.scalar),
    }


def assert_grads_match(got, want, rel=1e-4):
    for k in PARAM_NAMES:
        scale = np.max(np.abs(want[k])) + 1e-12
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=rel * scale,
                                   err_msg=k)


def assert_step_outputs_match(got, want, loss_rel=1e-6):
    assert got["loss_sum"] == pytest.approx(want["loss_sum"], rel=loss_rel)
    assert_grads_match(got["grads"], want["grads"])
    np.testing.assert_array_equal(got["pix"], want["pix"])
    assert got["scalar"] == want["scalar"]


@pytest.mark.parametrize("case", sorted(BATCHES))
@pytest.mark.parametrize("nh", [3, 8])
def test_plain_matches_jax_step_kernel(nh, case):
    """The plain batch, a batch padded with inert rows, the stream's tail
    batch whose weight-0 rows duplicate row 0, and the scalar count after
    mask * weight."""
    grid, p, _ = make_problem(nh)
    batch, want = jax_outputs(nh, "moderate", case)
    got = fused_loss_grads_plain(QFAParams.from_numpy(p), port_batch(batch))
    assert_step_outputs_match(got.to_numpy(), want)


def test_weight0_duplicates_contribute_nothing():
    """The tail batch gives the outputs of its real rows alone: a version
    that read the weight only for the loss would count row 0 twice in the
    counts and the gradients."""
    grid, p, base = make_problem(8)
    batch, _ = jax_outputs(8, "moderate", "tail duplicates row 0")
    real = {k: v[:11] for k, v in base.items()}
    got = fused_loss_grads_plain(QFAParams.from_numpy(p), port_batch(batch))
    want = fused_loss_grads_plain(QFAParams.from_numpy(p), port_batch(real))
    assert_step_outputs_match(got.to_numpy(), want.to_numpy())
    counts = got.counts.pix.numpy()
    assert counts.max() <= 11 and got.counts.scalar == 11


def test_scalar_count_counts_blue_rows_after_weight():
    batch, want = jax_outputs(8, "moderate", "scalar count after weight")
    assert want["scalar"] == N - 2
    grid, p, _ = make_problem(8)
    got = fused_loss_grads_plain(QFAParams.from_numpy(p), port_batch(batch))
    assert float(got.counts.scalar) == N - 2


@pytest.mark.parametrize("law", sorted(TAU_LAW_ABC))
def test_plain_matches_jax_for_each_tau_law(law):
    grid, p, _ = make_problem(8)
    batch, want = jax_outputs(8, "moderate", "plain", law)
    got = fused_loss_grads_plain(QFAParams.from_numpy(p), port_batch(batch),
                                 tau_which=law)
    assert_step_outputs_match(got.to_numpy(), want)


def test_low_noise_loss_within_stated_rtol():
    """d ~ 0.003: the Woodbury NLL cancels in float32; the loss is held to
    rtol 2e-4 (ROADMAP C), the gradients and counts as everywhere."""
    grid, p, _ = make_problem(8, "low")
    batch, want = jax_outputs(8, "low", "plain")
    got = fused_loss_grads_plain(QFAParams.from_numpy(p), port_batch(batch))
    assert_step_outputs_match(got.to_numpy(), want, loss_rel=2e-4)


@pytest.mark.parametrize("nh", [3, 8])
def test_plain_matches_autograd_summed_stats(nh):
    """The analytic backward against the port's ``torch.autograd`` on the
    tail batch; ``summed_stats`` itself against the JAX function."""
    grid, p, base = make_problem(nh)
    batch = tail_batch(base)
    params = QFAParams.from_numpy(p)
    total, n_real, grads, counts = summed_stats(params, port_batch(batch))
    got = fused_loss_grads_plain(params, port_batch(batch)).to_numpy()
    want = {"loss_sum": float(total), "grads": grads.to_numpy(),
            "pix": counts.pix.numpy(), "scalar": float(counts.scalar)}
    assert_step_outputs_match(got, want)
    assert float(n_real) == 11.0
    jt, jn, jg, jc = jax_summed_stats(jax_params(p), jax_batch(batch),
                                      JaxOptions())
    assert float(total) == pytest.approx(float(jt), rel=1e-6)
    assert_grads_match(want["grads"],
                       {k: np.asarray(getattr(jg, k)) for k in PARAM_NAMES})
    np.testing.assert_array_equal(want["pix"], np.asarray(jc.pix))


def test_finish_f_gradient_matches_jax_and_the_triangle():
    """finish_f_gradient on the JAX layout ((P, RC) with [dG | dF | pad]),
    and the kernel's form: the packed triangle of dG with the off-diagonal
    holding dG[ab] + dG[ba] and the diagonal counted twice gives the same
    dF as the full nh^2 Gram."""
    rng = np.random.default_rng(3)
    npix, nh = 58, 5
    drhs = rng.normal(size=(128, 128)).astype(np.float32)
    f = rng.normal(size=(npix, nh)).astype(np.float32)
    got = finish_f_gradient(torch.tensor(drhs), torch.tensor(f), npix, nh)
    want = np.asarray(jax_finish(jnp.asarray(drhs), jnp.asarray(f), npix, nh))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    dg = drhs[:npix, : nh * nh].reshape(npix, nh, nh)
    tri = {tri_idx(a, b): dg[:, a, b] + dg[:, b, a] if a != b else dg[:, a, a]
           for a in range(nh) for b in range(a + 1)}
    df = drhs[:npix, nh * nh: nh * nh + nh].copy()
    for a in range(nh):
        for b in range(nh):
            g = tri[tri_idx(a, b)]
            df[:, a] += (g + g if a == b else g) * f[:, b]
    np.testing.assert_allclose(df, want, rtol=1e-5, atol=1e-5)


def test_pad_batch_matches_jax():
    grid, p, base = make_problem(3)
    got = pad_batch(port_batch(base), 24)
    want = jax_pad_batch(jax_batch(base), 24)
    for k in JaxBatch._fields:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    assert pad_batch(got, 24) is got
    with pytest.raises(ValueError, match="padded down"):
        pad_batch(got, 8)


def test_cpu_tensors_take_the_plain_version_and_callables_raise():
    grid, p, base = make_problem(3)
    before = fused_step.LAUNCHES
    a = fused_loss_grads(QFAParams.from_numpy(p), port_batch(base),
                         tile_batch=5)
    b = fused_loss_grads_plain(QFAParams.from_numpy(p), port_batch(base))
    assert fused_step.LAUNCHES == before
    assert float(a.loss_sum) == float(b.loss_sum)
    with pytest.raises(ValueError, match="named"):
        fused_loss_grads(QFAParams.from_numpy(p), port_batch(base),
                         tau_which=lambda z: z)


CFG = dict(batch_size=16, learning_rate=1e-2, weight_decay=0.01)


@functools.lru_cache(maxsize=None)
def jax_step(engine):
    grid, p, base = make_problem(8)
    batch = tail_batch(base)
    cfg = JaxTrainConfig(**CFG)
    fn = jax_pallas_step_fn(cfg, tile_batch=N, interpret=True) \
        if engine == "fused" else jax_step_fn(cfg)
    params = jax_params(p)  # the step donates its state: a fresh copy
    st, loss = fn(JaxTrainState(params, jax_adam.init(params)),
                  jax_batch(batch))
    return float(loss), {k: np.asarray(v)
                         for k, v in st.params.as_dict().items()}


@pytest.mark.parametrize("engine", ["fused", "autograd"])
def test_step_fn_matches_jax(engine):
    """One step on the tail batch: the fused step (CPU: the plain version)
    against make_pallas_step_fn(interpret=True), the autograd step against
    make_step_fn."""
    grid, p, base = make_problem(8)
    cfg = TrainConfig(**CFG)
    fn = make_fused_step_fn(cfg, tile_batch=N) if engine == "fused" \
        else make_step_fn(cfg)
    params = QFAParams.from_numpy(p)
    st, loss = fn(TrainState(params, adam.init(params)),
                  port_batch(tail_batch(base)))
    want_loss, want = jax_step(engine)
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    assert st.opt_state.epoch == 0
    for k in PARAM_NAMES:
        np.testing.assert_allclose(getattr(st.params, k).detach().numpy(),
                                   want[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("engine", ["fused", "plain fused", "autograd"])
def test_nan_batch_leaves_the_state_unchanged(engine):
    grid, p, base = make_problem(3)
    poisoned = {k: v.copy() for k, v in base.items()}
    poisoned["delta"][4, np.argmax(poisoned["mask"][4])] = np.nan
    cfg = TrainConfig(**CFG)
    fn = {"fused": make_fused_step_fn(cfg),
          "plain fused": make_fused_step_fn(cfg, plain=True),
          "autograd": make_step_fn(cfg)}[engine]
    params = QFAParams.from_numpy(p)
    old = TrainState(params, adam.init(params))
    st, loss = fn(old, port_batch(poisoned))
    assert not np.isfinite(float(loss))
    for k in PARAM_NAMES:
        assert torch.equal(getattr(st.params, k), getattr(old.params, k)), k
        assert torch.equal(getattr(st.opt_state.m, k), getattr(old.opt_state.m, k))
        assert torch.equal(getattr(st.opt_state.v, k), getattr(old.opt_state.v, k))
    good, loss = fn(old, port_batch(base))
    assert np.isfinite(float(loss))
    assert not torch.equal(good.params.F, old.params.F)
