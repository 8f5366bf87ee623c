"""The port's fused_predict (on the CPU: its plain torch version) against
the JAX package's Pallas fused_predict in interpret mode, in every mode on
the prediction path.

Inputs come from ``qfa_tpu.data.synthetic.generate`` as numpy and go to
both packages. Tolerances are those of tests/test_infer_kernel.py (the
JAX kernel against the XLA path): ll rtol 2e-5; hmean rtol 1e-4 atol
1e-6; hcov rtol 1e-4 atol 1e-7; continuum rtol 1e-4 atol 1e-5; std rtol
1e-3 atol 1e-5; n_obs exact. Both sides compute in float32 with the sums
taken in different orders.
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
from qfa_tpu.ops import loglam_row as jax_loglam_row
from qfa_tpu.ops import zq_column as jax_zq_column
from qfa_tpu.ops.infer_kernel import fused_predict as jax_fused_predict
from qfa_tpu_torch.models.params import QFAParams
from qfa_tpu_torch.ops import common
from qfa_tpu_torch.ops.infer_kernel import fused_predict, fused_predict_plain

TOL = {
    "ll": dict(rtol=2e-5, atol=0.0),
    "hmean": dict(rtol=1e-4, atol=1e-6),
    "hcov": dict(rtol=1e-4, atol=1e-7),
    "continuum": dict(rtol=1e-4, atol=1e-5),
    "continuum_std": dict(rtol=1e-3, atol=1e-5),
    "n_obs": dict(rtol=0.0, atol=0.0),
}
STATS = ("ll", "hmean", "hcov", "n_obs")
MASKED_ROW = 3  # fully masked in every problem


def assert_outputs_close(port, ref, names):
    for name in names:
        np.testing.assert_allclose(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
            err_msg=name, **TOL[name],
        )


@functools.lru_cache(maxsize=None)
def make_problem(nh: int):
    """Small grid (25 blue + 29 red pixels), 16 spectra with contiguous
    masked chunks and one fully masked row, as numpy arrays."""
    grid = qfa_tpu.make_grid(1150.0, 1300.0, 1e-3)
    params = jax_random_init(jax.random.key(nh), grid.npix, grid.nb, nh)
    params = params._replace(
        Psi=jnp.full((grid.npix,), 0.4),
        omega=jnp.full((grid.nb,), 0.7),
        tau0=jnp.asarray(0.12), c0=jnp.asarray(0.21), beta=jnp.asarray(1.7),
    )
    mu = np.linspace(0.9, 1.3, grid.npix).astype(np.float32)
    syn = generate(jax.random.key(nh + 100), params, jnp.asarray(mu), grid,
                   16, mask_frac=0.15)
    mask = np.array(syn.mask, np.float32)
    mask[MASKED_ROW] = 0.0
    data = dict(
        flux=np.array(syn.flux, np.float32) * mask,
        error=np.array(syn.error, np.float32) * mask,
        mask=mask,
        zabs=np.array(syn.zabs, np.float32),
        zq=np.array(jax_zq_column(syn.zqso)),
        zqso=np.array(syn.zqso, np.float32),
    )
    np_params = {k: np.asarray(v) for k, v in params.as_dict().items()}
    return grid, np_params, mu, data


def jax_run(nh, mask_mode, zabs_mode):
    grid, np_params, mu, d = make_problem(nh)
    params = qfa_tpu.models.QFAParams(
        **{k: jnp.asarray(v) for k, v in np_params.items()}
    )
    kw = dict(tile_batch=8, interpret=True)
    zabs = d["zabs"]
    if zabs_mode == "zq":
        zabs = d["zq"]
        kw.update(loglam=jax_loglam_row(grid.wav), derive_zabs=True)
    return jax_fused_predict(
        params, jnp.asarray(mu), jnp.asarray(d["flux"]),
        jnp.asarray(d["error"]), jnp.asarray(zabs),
        None if mask_mode == "derived" else jnp.asarray(d["mask"]), **kw,
    )


def port_run(nh, mask_mode, zabs_mode, *, stats_only=False, fn=fused_predict,
             zabs_width=None):
    grid, np_params, mu, d = make_problem(nh)
    params = QFAParams.from_numpy(np_params)
    t = torch.from_numpy
    kw = dict(stats_only=stats_only)
    if zabs_mode == "zq":
        # the JAX zq buffer is 128 lanes wide; the port's column is its
        # first two: [log1p(zqso), weight]
        zabs = t(d["zq"][:, : common.ZQ_WIDTH].copy())
        kw.update(loglam=common.loglam_row(grid.wav), derive_zabs=True)
    else:
        zabs = t(d["zabs"])
        if zabs_width is not None:
            zabs = torch.nn.functional.pad(zabs, (0, zabs_width - grid.nb))
    return fn(
        params, t(mu), t(d["flux"]), t(d["error"]), zabs,
        None if mask_mode == "derived" else t(d["mask"]), **kw,
    )


@pytest.mark.parametrize("zabs_mode", ["plane", "zq"])
@pytest.mark.parametrize("mask_mode", ["plane", "derived"])
def test_fused_predict_matches_jax_kernel(mask_mode, zabs_mode):
    """Full output and stats_only, nh = 8, in each mask x zabs mode."""
    ref = jax_run(8, mask_mode, zabs_mode)
    full = port_run(8, mask_mode, zabs_mode)
    assert_outputs_close(full, ref, TOL)
    lean = port_run(8, mask_mode, zabs_mode, stats_only=True)
    assert lean.continuum is None and lean.continuum_std is None
    assert_outputs_close(lean, ref, STATS)


@pytest.mark.parametrize("nh", [1, 10])
def test_fused_predict_nh_edges_match_jax_kernel(nh):
    ref = jax_run(nh, "plane", "plane")
    out = port_run(nh, "plane", "plane")
    assert out.hcov.shape == (16, nh, nh)
    assert_outputs_close(out, ref, TOL)


@pytest.mark.parametrize("width", ["npix", "p128"])
def test_fused_predict_zabs_plane_widths(width):
    """A zabs plane of width Npix or round_up(Npix, 128) reads only its
    blue part, like the Nb-wide plane."""
    grid = make_problem(8)[0]
    w = grid.npix if width == "npix" else -(-grid.npix // 128) * 128
    ref = port_run(8, "plane", "plane")
    out = port_run(8, "plane", "plane", zabs_width=w)
    for name in TOL:
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      getattr(ref, name).numpy(), name)


def test_fused_predict_fully_masked_row_is_prior():
    """A fully masked row comes back as ll = 0, n_obs = 0, hmean = 0,
    hcov = I, continuum = mu and std = sqrt(diag(F F^T))."""
    grid, np_params, mu, _ = make_problem(8)
    for mask_mode in ("plane", "derived"):
        out = port_run(8, mask_mode, "zq")
        r = MASKED_ROW
        assert float(out.ll[r]) == 0.0
        assert float(out.n_obs[r]) == 0.0
        np.testing.assert_array_equal(out.hmean[r].numpy(), 0.0)
        np.testing.assert_array_equal(out.hcov[r].numpy(), np.eye(8))
        np.testing.assert_allclose(out.continuum[r].numpy(), mu, rtol=1e-6)
        f = np_params["F"]
        np.testing.assert_allclose(out.continuum_std[r].numpy(),
                                   np.sqrt((f * f).sum(1)), rtol=1e-5)


def test_zq_column_and_loglam_match_jax():
    grid, _, _, d = make_problem(8)
    zq = common.zq_column(torch.from_numpy(d["zqso"])).numpy()
    np.testing.assert_allclose(zq, d["zq"][:, : common.ZQ_WIDTH], rtol=1e-7)
    np.testing.assert_array_equal(common.loglam_row(grid.wav).numpy(),
                                  np.asarray(jax_loglam_row(grid.wav)))


@pytest.mark.parametrize("fn", [fused_predict, fused_predict_plain])
def test_fused_predict_rejects_oversized_nh(fn):
    """nh = 11 needs 2 + 11 + 121 = 134 > 128 stats entries in the JAX
    kernel; the port keeps the bound and its ValueError."""
    grid = qfa_tpu.make_grid(1150.0, 1300.0, 1e-3)
    params = QFAParams.from_numpy({
        "F": np.zeros((grid.npix, 11), np.float32),
        "Psi": np.ones(grid.npix, np.float32),
        "omega": np.ones(grid.nb, np.float32),
        "tau0": 0.1, "c0": 0.2, "beta": 2.0,
    })
    z = torch.zeros((4, grid.npix))
    with pytest.raises(ValueError, match="nh"):
        fn(params, torch.ones(grid.npix), z, z, z, None)


@pytest.mark.parametrize("fn", [fused_predict, fused_predict_plain])
def test_fused_predict_rejects_callable_tau(fn):
    with pytest.raises(ValueError, match="named"):
        port_run(8, "plane", "plane",
                 fn=functools.partial(fn, tau_which=lambda z: 0.1 * z))


def test_fused_predict_rejects_zq_column_without_flag():
    """An (N, 2) zq column passed as a plane is refused, not misread."""
    with pytest.raises(ValueError, match="derive_zabs"):
        grid, np_params, mu, d = make_problem(8)
        fused_predict(
            QFAParams.from_numpy(np_params), torch.from_numpy(mu),
            torch.from_numpy(d["flux"]), torch.from_numpy(d["error"]),
            torch.from_numpy(d["zq"][:, :2].copy()), None,
        )
