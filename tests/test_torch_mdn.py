"""The port's conditional mixture density network
(``qfa_tpu_torch.models.mdn``) against the JAX package's
(``qfa_tpu.models.mdn``), on the CPU.

Tolerances, and why: ``mdn_log_prob`` and its gradient by every weight on
the same (carried) weights and inputs rtol 1e-5 (float32 small matmuls,
triangular solves and logsumexp in XLA and in torch; the gradient by
``atol = 1e-5 * max|g|`` per leaf); ``torch.optim.Adam`` against
``optax.adam`` over 5 steps on the same gradients rtol 1e-6 atol
1e-4 * lr (the same update; torch divides by ``sqrt(v) / sqrt(bc2) +
eps`` and scales by ``lr / bc1`` where optax forms ``m / bc1`` and
``sqrt(v / bc2)``: float32 rounding of the step, 1e-7 against the 3e-3
steps); the fit recovers the
conditional mean to 0.25 and the conditional std within (0.12, 0.7)
around its 0.3 (``tests/test_mdn.py``'s own bounds for JAX; the draws
differ, ``torch.Generator`` against ``jax.random``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qfa_tpu.models import mdn as jax_mdn
from qfa_tpu_torch.models import mdn
from qfa_tpu_torch.models.mdn import (
    MDNConfig,
    MDNParams,
    fit_mdn,
    init_mdn,
    mdn_log_prob,
    mdn_sample,
    sample_mock_continua,
)

CFG = MDNConfig(cond_dim=2, out_dim=4, n_components=3, hidden=(16, 8))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The fits are thousands of steps of small ops: one intra-op thread
    runs them ~2x faster than eight here, and leaves the other test
    processes' cores alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def make_data(rng, n=4000, d=3):
    """h depends linearly on (z, lum) with noise of std 0.3."""
    z = rng.uniform(2.0, 3.5, n)
    lum = rng.uniform(-1.0, 1.0, n)
    cond = np.stack([z, lum], 1).astype(np.float32)
    w = rng.normal(size=(2, d))
    h = cond @ w + rng.normal(size=(n, d)) * 0.3
    return cond, h.astype(np.float32), w


def carried(cfg=CFG, seed=0):
    jp = jax_mdn.init_mdn(jax.random.key(seed), cfg)
    # move the heads off their 1e-2 init so every term matters
    jp = jax.tree.map(lambda x: x * 20.0 if x.ndim == 2 else x + 0.1, jp)
    return jp, MDNParams.from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def test_from_numpy_carries_jax_weights_and_config():
    jp, pp = carried()
    assert pp.config == CFG
    leaves = jax.tree.leaves(jp)
    assert len(list(pp.parameters())) == len(leaves) == 12
    for p, a in zip(pp.parameters(), leaves):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(a))
    assert isinstance(pp.layers[1].w, torch.nn.Parameter)


@pytest.mark.parametrize("lead", [(7,), (2, 5)])
def test_log_prob_and_gradient_match_jax(lead):
    jp, pp = carried()
    rng = np.random.default_rng(1)
    cond = rng.normal(size=lead + (2,)).astype(np.float32)
    h = rng.normal(size=lead + (4,)).astype(np.float32)
    want = np.asarray(jax_mdn.mdn_log_prob(jp, jnp.asarray(cond),
                                           jnp.asarray(h), CFG))
    got = mdn_log_prob(pp, torch.tensor(cond), torch.tensor(h))
    assert got.shape == lead
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    assert torch.equal(pp(torch.tensor(cond), torch.tensor(h)), got)
    gj = jax.grad(lambda p: jax_mdn.mdn_log_prob(
        p, jnp.asarray(cond), jnp.asarray(h), CFG).sum())(jp)
    got.sum().backward()
    for (name, p), g in zip(pp.named_parameters(), jax.tree.leaves(gj)):
        g = np.asarray(g)
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max(), err_msg=name)


def test_torch_adam_matches_optax_adam():
    """optax.adam(lr) and torch.optim.Adam(lr, betas=(0.9, 0.999),
    eps=1e-8) over 5 steps, each fed the same gradients."""
    jp, pp = carried()
    rng = np.random.default_rng(2)
    grads = [jax.tree.map(lambda x: jnp.asarray(
        rng.normal(size=x.shape).astype(np.float32)), jp) for _ in range(5)]
    tx = optax.adam(3e-3)
    state = tx.init(jp)
    opt = torch.optim.Adam(pp.parameters(), lr=3e-3, betas=(0.9, 0.999),
                           eps=1e-8)
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, gl in zip(pp.parameters(), jax.tree.leaves(g)):
            p.grad = torch.tensor(np.asarray(gl))
        opt.step()
    for p, w in zip(pp.parameters(), jax.tree.leaves(jp)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-4 * 3e-3)


def test_init_and_sample_shapes_and_determinism():
    p = init_mdn(torch.Generator().manual_seed(0), CFG, device="cpu")
    again = init_mdn(torch.Generator().manual_seed(0), CFG, device="cpu")
    for a, b in zip(p.parameters(), again.parameters()):
        assert torch.equal(a, b)
    assert [tuple(x.shape) for x in p.parameters()] == [
        tuple(np.shape(x)) for x in jax.tree.leaves(
            jax_mdn.init_mdn(jax.random.key(0), CFG))]
    lp = mdn_log_prob(p, torch.zeros(5, 2), torch.zeros(5, 4))
    assert lp.shape == (5,) and torch.isfinite(lp).all()
    s = mdn_sample(p, torch.Generator().manual_seed(1), torch.zeros(5, 2), 7)
    s2 = mdn_sample(p, torch.Generator().manual_seed(1), torch.zeros(5, 2), 7)
    assert s.shape == (7, 5, 4) and torch.isfinite(s).all()
    assert torch.equal(s, s2)


def test_sample_draws_the_mixture():
    """With the weights of one component's logit far above the others',
    every sample comes from it: mean and covariance L L^T of that
    component (4000 draws: mean to 0.1, covariance to 0.15)."""
    jp, pp = carried()
    with torch.no_grad():
        pp.head_logits.b[:] = torch.tensor([0.0, 50.0, 0.0])
    cond = torch.tensor([[0.3, -0.2]])
    _, means, tril, _ = mdn._heads(pp, cond, CFG)
    s = mdn_sample(pp, torch.Generator().manual_seed(3), cond, 4000)[:, 0]
    np.testing.assert_allclose(s.mean(0).numpy(),
                               means[0, 1].detach().numpy(), atol=0.1)
    cov = (tril[0, 1] @ tril[0, 1].T).detach().numpy()
    np.testing.assert_allclose(np.cov(s.numpy().T), cov, atol=0.15)


def test_fit_recovers_conditional_structure():
    rng = np.random.default_rng(0)
    cond, h, w = make_data(rng, n=4000, d=3)
    cfg = MDNConfig(cond_dim=2, out_dim=3, n_components=4, hidden=(32, 32))
    params, info = fit_mdn(torch.Generator().manual_seed(0), cond, h, cfg,
                           n_steps=1500, learning_rate=2e-3, device="cpu")
    assert len(info["losses"]) == 15
    assert info["losses"][-1] < info["losses"][0]
    np.testing.assert_allclose(info["cond_mean"].numpy(),
                               cond.astype(np.float64).mean(0), atol=1e-6)
    np.testing.assert_allclose(info["cond_std"].numpy(),
                               cond.astype(np.float64).std(0) + 1e-6,
                               rtol=1e-5)
    for probe in (np.array([[2.2, -0.5]]), np.array([[3.2, 0.7]])):
        pc = (torch.tensor(probe, dtype=torch.float32) - info["cond_mean"]) \
            / info["cond_std"]
        samples = mdn_sample(params, torch.Generator().manual_seed(2), pc,
                             4000, cfg)[:, 0, :].numpy()
        err = np.abs(samples.mean(0) - (probe @ w)[0])
        assert (err < 0.25).all(), (samples.mean(0), probe @ w)
        assert (samples.std(0) < 0.7).all() and (samples.std(0) > 0.12).all()


def test_mock_continua_pipeline():
    rng = np.random.default_rng(1)
    cond, h, _ = make_data(rng, n=1000, d=3)
    cfg = MDNConfig(cond_dim=2, out_dim=3, n_components=2, hidden=(16,))
    params, info = fit_mdn(torch.Generator().manual_seed(0), cond, h, cfg,
                           n_steps=200, device="cpu")
    npix = 40
    f = torch.tensor(rng.normal(size=(npix, 3)), dtype=torch.float32) * 0.1
    mu = torch.ones(npix)
    continua = sample_mock_continua(params, torch.Generator().manual_seed(3),
                                    cond[:5], f, mu, 6, cfg, info)
    assert continua.shape == (6, 5, npix)
    assert torch.isfinite(continua).all()


def test_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_mdn(torch.Generator(), CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_mdn(None, np.zeros((4, 2)), np.zeros((4, 4)), CFG, n_steps=1)
