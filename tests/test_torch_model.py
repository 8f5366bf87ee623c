"""The port's plain likelihood path against qfa_tpu on the same numpy
inputs: linalg.smallchol, linalg.lowrank (including dense_masked_nll),
models.qfa.batch_nll and models.qfa.predict.

Tolerances: the unrolled Cholesky and solves rtol 1e-5 (float32, the same
operation order, matrix condition ~10); the per-spectrum NLL rtol 2e-5 and
the predict outputs with the prediction-kernel tolerances of
tests/test_infer_kernel.py, since both sides sum in float32 in different
orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qfa_tpu
from qfa_tpu.data.batch import SpectraBatch as JaxBatch
from qfa_tpu.data.synthetic import generate
from qfa_tpu.linalg import lowrank as jlow
from qfa_tpu.linalg import smallchol as jchol
from qfa_tpu.models import qfa as jqfa
from qfa_tpu.models import random_init as jax_random_init
from qfa_tpu_torch.data.batch import SpectraBatch
from qfa_tpu_torch.linalg import lowrank, smallchol
from qfa_tpu_torch.models import qfa
from qfa_tpu_torch.models.params import QFAParams

PRED_TOL = {
    "ll": dict(rtol=2e-5, atol=0.0),
    "hmean": dict(rtol=1e-4, atol=1e-6),
    "hcov": dict(rtol=1e-4, atol=1e-7),
    "continuum": dict(rtol=1e-4, atol=1e-5),
    "continuum_std": dict(rtol=1e-3, atol=1e-5),
}


def spd_batch(nh, n=6, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, nh, nh)).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) + nh * np.eye(nh)).astype(np.float32)


@pytest.mark.parametrize("nh", [1, 3, 8])
def test_smallchol_matches_jax(nh):
    k = spd_batch(nh)
    b = np.random.default_rng(1).normal(size=(6, nh)).astype(np.float32)
    kt, bt = torch.from_numpy(k), torch.from_numpy(b)
    kj, bj = jnp.asarray(k), jnp.asarray(b)
    lt, lj = smallchol.cholesky_small(kt), jchol.cholesky_small(kj)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol)
    for ft, fj in [
        (smallchol.solve_lower_small, jchol.solve_lower_small),
        (smallchol.solve_upper_small, jchol.solve_upper_small),
        (smallchol.chol_solve_small, jchol.chol_solve_small),
    ]:
        np.testing.assert_allclose(ft(lt, bt).numpy(), np.asarray(fj(lj, bj)),
                                   **tol)
    np.testing.assert_allclose(smallchol.logdet_from_chol(lt).numpy(),
                               np.asarray(jchol.logdet_from_chol(lj)), **tol)
    np.testing.assert_allclose(smallchol.inverse_from_chol(lt).numpy(),
                               np.asarray(jchol.inverse_from_chol(lj)), **tol)


@pytest.fixture(scope="module")
def problem():
    """nh = 4 on a grid with 25 blue and 29 red pixels; 12 synthetic
    spectra with contiguous masked chunks, as numpy arrays."""
    grid = qfa_tpu.make_grid(1150.0, 1300.0, 1e-3)
    jp = jax_random_init(jax.random.key(2), grid.npix, grid.nb, 4)
    jp = jp._replace(
        Psi=jnp.full((grid.npix,), 0.3), omega=jnp.full((grid.nb,), 0.6),
        tau0=jnp.asarray(0.1), c0=jnp.asarray(0.25), beta=jnp.asarray(2.2),
    )
    mu = np.linspace(0.8, 1.2, grid.npix).astype(np.float32)
    syn = generate(jax.random.key(3), jp, jnp.asarray(mu), grid, 12,
                   mask_frac=0.2)
    mask = np.array(syn.mask, np.float32)
    data = {
        "flux": np.array(syn.flux, np.float32) * mask,
        "error": np.array(syn.error, np.float32) * mask,
        "zabs": np.array(syn.zabs, np.float32),
        "mask": mask,
    }
    np_params = {k: np.asarray(v) for k, v in jp.as_dict().items()}
    return grid, np_params, mu, data


def both(problem):
    grid, np_params, mu, d = problem
    jp = qfa_tpu.models.QFAParams(**{k: jnp.asarray(v)
                                     for k, v in np_params.items()})
    tp = QFAParams.from_numpy(np_params)
    return jp, tp


def test_lowrank_factorize_nll_posterior_match_jax(problem):
    grid, np_params, mu, d = problem
    jp, tp = both(problem)
    jb = JaxBatch(delta=jnp.asarray(d["flux"]), error=jnp.asarray(d["error"]),
                  zabs=jnp.asarray(d["zabs"]), mask=jnp.asarray(d["mask"]),
                  weight=jnp.ones(12))
    tb = SpectraBatch(*(torch.from_numpy(d[k])
                        for k in ("flux", "error", "zabs", "mask")),
                      weight=torch.ones(12))
    jf, _ = jqfa.batch_factors(jp, jb)
    tf, amp = qfa.batch_factors(tp, tb)
    for name in ("chol", "w", "quad", "logdet_d", "n_obs"):
        np.testing.assert_allclose(getattr(tf, name).detach().numpy(),
                                   np.asarray(getattr(jf, name)),
                                   rtol=2e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(lowrank.nll(tf).detach().numpy(),
                               np.asarray(jlow.nll(jf)), rtol=2e-5)
    (th, tc), (jh, jc) = lowrank.solve_posterior(tf), jlow.solve_posterior(jf)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               **PRED_TOL["hmean"])
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc),
                               **PRED_TOL["hcov"])
    np.testing.assert_allclose(
        lowrank.gram_matrix(tp.F).detach().numpy(),
        np.asarray(jlow.gram_matrix(jp.F)), rtol=1e-6,
    )


def test_dense_masked_nll_matches_jax_and_lowrank(problem):
    """The O(Npix^3) dense reference agrees with JAX's, and with the
    masked low-rank NLL it validates."""
    grid, np_params, mu, d = problem
    jp, tp = both(problem)
    tb = SpectraBatch(*(torch.from_numpy(d[k])
                        for k in ("flux", "error", "zabs", "mask")),
                      weight=torch.ones(12))
    amp = qfa.absorption(tb.zabs, grid.nr)
    dinv, _, zdep = qfa.noise_diagonal(tp, tb, amp)
    omega_full = torch.cat([tp.omega * zdep, torch.zeros(12, grid.nr)], 1)
    dd = (amp * amp * tp.Psi + omega_full + tb.error ** 2).detach()
    low = qfa.batch_nll(tp, tb).detach().numpy()
    for i in (0, 5):
        args = (tp.F.detach(), tb.delta[i], amp[i], dd[i], tb.mask[i])
        dense = lowrank.dense_masked_nll(*args)
        jdense = jlow.dense_masked_nll(*(jnp.asarray(a.numpy()) for a in args))
        np.testing.assert_allclose(float(dense), float(jdense), rtol=2e-5)
        np.testing.assert_allclose(float(dense), low[i], rtol=2e-5)


def test_batch_nll_matches_jax(problem):
    grid, np_params, mu, d = problem
    jp, tp = both(problem)
    jb = JaxBatch(delta=jnp.asarray(d["flux"]), error=jnp.asarray(d["error"]),
                  zabs=jnp.asarray(d["zabs"]), mask=jnp.asarray(d["mask"]),
                  weight=jnp.ones(12))
    tb = SpectraBatch(*(torch.from_numpy(d[k])
                        for k in ("flux", "error", "zabs", "mask")),
                      weight=torch.ones(12))
    for tau_which in ("becker", "mock"):
        ref = jqfa.batch_nll(jp, jb, jqfa.ModelOptions(tau_which=tau_which))
        out = qfa.batch_nll(tp, tb, qfa.ModelOptions(tau_which=tau_which))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   rtol=2e-5)


@pytest.mark.parametrize("tau", ["becker", "callable"])
def test_predict_matches_jax(problem, tau):
    """models.qfa.predict, with a named law and with a tau callable (the
    plain path evaluates callables exactly)."""
    grid, np_params, mu, d = problem
    jp, tp = both(problem)
    if tau == "callable":
        jopt = jqfa.ModelOptions(tau_which=lambda z: 0.004 * (1.0 + z) ** 3.5)
        topt = qfa.ModelOptions(tau_which=lambda z: 0.004 * (1.0 + z) ** 3.5)
    else:
        jopt, topt = jqfa.ModelOptions(), qfa.ModelOptions()
    ref = jqfa.predict(jp, jnp.asarray(mu), *(jnp.asarray(d[k]) for k in
                       ("flux", "error", "zabs", "mask")), jopt)
    out = qfa.predict(tp, torch.from_numpy(mu), *(torch.from_numpy(d[k]) for
                      k in ("flux", "error", "zabs", "mask")), topt)
    for name, tol in PRED_TOL.items():
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **tol)
