"""The port's fused_predict (on the CPU: its plain torch version) against
the JAX package's Pallas fused_predict in interpret mode, in every mode on
the prediction path, with float32 and bfloat16 planes and outputs.

Inputs come from ``qfa_tpu.data.synthetic.generate`` as numpy and go to
both packages. Tolerances are those of tests/test_infer_kernel.py (the
JAX kernel against the XLA path): ll rtol 2e-5; hmean rtol 1e-4 atol
1e-6; hcov rtol 1e-4 atol 1e-7; continuum rtol 1e-4 atol 1e-5; std rtol
1e-3 atol 1e-5; n_obs exact. Both sides compute in float32 with the sums
taken in different orders. On bfloat16 planes both read the same bf16
values, so the same tolerances hold; against the float32 run on the
unrounded planes, JAX's own data-quantization limits (ll rtol 2e-2,
continuum rtol 5e-2 atol 2e-2; tests/test_infer_kernel.py). Planes
stored as bfloat16 (out_dtype) are within one bf16 ulp (rtol 2^-7) of
JAX's plus the float32 atol: the two round float32 values that differ in
their last bits.
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
PLANES = ("continuum", "continuum_std")
MASKED_ROW = 3  # fully masked in every problem
BF16_ULP = 2.0**-7
#: JAX's data-quantization limits, bf16 against float32 planes
#: (tests/test_infer_kernel.py::test_fused_predict_bf16_planes)
QUANT_TOL = {"ll": dict(rtol=2e-2), "continuum": dict(rtol=5e-2, atol=2e-2)}


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


def jax_run(nh, mask_mode, zabs_mode, bf16=(), out_dtype=jnp.float32):
    """JAX's kernel; the planes named in ``bf16`` go in as bfloat16."""
    grid, np_params, mu, d = make_problem(nh)
    params = qfa_tpu.models.QFAParams(
        **{k: jnp.asarray(v) for k, v in np_params.items()}
    )
    kw = dict(tile_batch=8, interpret=True, out_dtype=out_dtype)

    def plane(name):
        x = jnp.asarray(d[name])
        return x.astype(jnp.bfloat16) if name in bf16 else x

    zabs = plane("zabs")
    if zabs_mode == "zq":
        zabs = jnp.asarray(d["zq"])
        kw.update(loglam=jax_loglam_row(grid.wav), derive_zabs=True)
    return jax_fused_predict(
        params, jnp.asarray(mu), plane("flux"), plane("error"), zabs,
        None if mask_mode == "derived" else plane("mask"), **kw,
    )


def port_run(nh, mask_mode, zabs_mode, *, stats_only=False, fn=fused_predict,
             zabs_width=None, bf16=(), out_dtype=torch.float32,
             plane_dtype=torch.float32):
    """The port's call; the planes named in ``bf16`` go in as bfloat16,
    the others as ``plane_dtype``."""
    grid, np_params, mu, d = make_problem(nh)
    params = QFAParams.from_numpy(np_params)
    t = torch.from_numpy

    def plane(name):
        return t(d[name]).to(torch.bfloat16 if name in bf16 else plane_dtype)

    kw = dict(stats_only=stats_only, out_dtype=out_dtype)
    if zabs_mode == "zq":
        # the JAX zq buffer is 128 lanes wide; the port's column is its
        # first two: [log1p(zqso), weight]
        zabs = t(d["zq"][:, : common.ZQ_WIDTH].copy())
        kw.update(loglam=common.loglam_row(grid.wav), derive_zabs=True)
    else:
        zabs = plane("zabs")
        if zabs_width is not None:
            zabs = torch.nn.functional.pad(zabs, (0, zabs_width - grid.nb))
    return fn(
        params, t(mu), plane("flux"), plane("error"), zabs,
        None if mask_mode == "derived" else plane("mask"), **kw,
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


ALL_BF16 = ("flux", "error", "mask", "zabs")


@pytest.mark.parametrize("zabs_mode", ["plane", "zq"])
@pytest.mark.parametrize("mask_mode", ["plane", "derived"])
def test_fused_predict_bf16_planes_match_jax_kernel(mask_mode, zabs_mode):
    """bfloat16 flux, error, mask and zabs planes (where the mode has
    them), full output and stats_only, against JAX's kernel on the same
    bf16 planes; then against the float32 run on the unrounded planes, to
    JAX's data-quantization limits."""
    ref = jax_run(8, mask_mode, zabs_mode, bf16=ALL_BF16)
    full = port_run(8, mask_mode, zabs_mode, bf16=ALL_BF16)
    assert full.continuum.dtype == torch.float32
    assert_outputs_close(full, ref, TOL)
    lean = port_run(8, mask_mode, zabs_mode, stats_only=True, bf16=ALL_BF16)
    assert_outputs_close(lean, ref, STATS)
    f32 = port_run(8, mask_mode, zabs_mode)
    np.testing.assert_array_equal(full.n_obs.numpy(), f32.n_obs.numpy())
    for name, tol in QUANT_TOL.items():
        np.testing.assert_allclose(getattr(full, name).numpy(),
                                   getattr(f32, name).numpy(), err_msg=name,
                                   **tol)


@pytest.mark.parametrize("bf16", [("flux",), ("error", "mask")],
                         ids=["flux", "error+mask"])
def test_fused_predict_mixed_plane_dtypes_match_jax_kernel(bf16):
    """Each plane may be bfloat16 on its own, as JAX's wrapper allows."""
    ref = jax_run(8, "plane", "plane", bf16=bf16)
    assert_outputs_close(port_run(8, "plane", "plane", bf16=bf16), ref, TOL)


@pytest.mark.parametrize("zabs_mode", ["plane", "zq"])
@pytest.mark.parametrize("mask_mode", ["plane", "derived"])
def test_fused_predict_bf16_out_matches_jax_kernel(mask_mode, zabs_mode):
    """out_dtype=bfloat16: the continuum and std planes come back
    bfloat16, within one bf16 ulp of JAX's; the stats are float32 and
    bitwise equal to the float32-out call's."""
    bf = torch.bfloat16
    ref = jax_run(8, mask_mode, zabs_mode, out_dtype=jnp.bfloat16)
    got = port_run(8, mask_mode, zabs_mode, out_dtype=bf)
    f32 = port_run(8, mask_mode, zabs_mode)
    for name in PLANES:
        a = getattr(got, name)
        assert a.dtype == bf, name
        np.testing.assert_allclose(
            a.float().numpy(), np.asarray(getattr(ref, name), np.float32),
            rtol=BF16_ULP, atol=TOL[name]["atol"], err_msg=name)
    for name in STATS:
        a = getattr(got, name)
        assert a.dtype == torch.float32, name
        assert torch.equal(a, getattr(f32, name)), name


def test_fused_predict_casts_other_dtypes_to_float32():
    """A float64 plane (and float64 parameters, mu and zq column) on the
    CPU path gives JAX's float32 result: the wrapper casts them to
    float32, as JAX's does."""
    ref = jax_run(8, "plane", "zq")
    grid, np_params, mu, d = make_problem(8)
    f64 = torch.float64
    params = QFAParams.from_numpy(
        {k: np.asarray(v, np.float64) for k, v in np_params.items()})
    got = fused_predict(
        params, torch.from_numpy(mu).to(f64),
        torch.from_numpy(d["flux"]).to(f64), torch.from_numpy(d["error"]),
        torch.from_numpy(d["zq"][:, : common.ZQ_WIDTH].copy()).to(f64),
        torch.from_numpy(d["mask"]).to(f64),
        loglam=common.loglam_row(grid.wav).to(f64), derive_zabs=True)
    for name in TOL:
        assert getattr(got, name).dtype == torch.float32, name
    assert_outputs_close(got, ref, TOL)


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


class _Captured(Exception):
    pass


@pytest.mark.parametrize("nh", [1, 3, 8, 10])
def test_gram_table_is_jax_rhst(nh, monkeypatch):
    """The table of the port's tensor-core body (``gram_table``: the lower
    Gram triangle's columns ``F_a * F_b``, then F) equals the rows JAX's
    fused_predict builds once outside its kernel (``rhst``, its last
    operand, taken from its ``pl.pallas_call``) bitwise; its TF32 split
    holds TF32 values (the 13 low bits clear) and hi + lo recombines to
    it within the rounding of lo, 2^-22 of each entry; and the copy the
    kernel reads (``_tc_table``) holds those hi and lo, bitwise, in the
    MMA fragments' order."""
    from jax.experimental import pallas as pl

    from qfa_tpu_torch.ops.infer_kernel import _tc_table, gram_table, split_tf32

    got = {}

    def capture(kernel, **kw):
        def call(*args):
            got["rhst"] = np.asarray(args[-1])
            raise _Captured

        return call

    monkeypatch.setattr(pl, "pallas_call", capture)
    with jax.disable_jit(), pytest.raises(_Captured):
        jax_run(nh, "plane", "plane")
    grid, np_params, _, _ = make_problem(nh)
    ntri = nh * (nh + 1) // 2
    table = gram_table(torch.from_numpy(np_params["F"].copy()))
    assert table.shape == (grid.npix, ntri + nh)
    want = torch.from_numpy(got["rhst"][:ntri + nh, :grid.npix].T.copy())
    assert torch.equal(table, want)
    hi, lo = split_tf32(table)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    err = (hi.double() + lo.double() - table.double()).abs()
    assert bool((err <= 2.0**-22 * table.double().abs()).all())
    assert float((hi - table).abs().max()) > 0  # the split is not trivial
    # the tensor-core body's copy: these hi and lo, the Gram columns and
    # F's each padded to a multiple of 8, in fragment order (entry (k, n,
    # t) = hi, hi, lo, lo of pixels 8 k + t and 8 k + t + 4)
    ng, nf = -(-ntri // 8) * 8, -(-nh // 8) * 8
    pad = 128
    p = -(-grid.npix // pad) * pad
    padded = torch.zeros((2, p, ng + nf))
    padded[0, :grid.npix, :ntri], padded[0, :grid.npix, ng:ng + nh] = \
        hi[:, :ntri], hi[:, ntri:]
    padded[1, :grid.npix, :ntri], padded[1, :grid.npix, ng:ng + nh] = \
        lo[:, :ntri], lo[:, ntri:]
    frag = padded.view(2, p // 8, 2, 4, ng + nf).permute(1, 4, 3, 0, 2)
    got = _tc_table(torch.from_numpy(np_params["F"].copy()), pad)
    assert torch.equal(got, frag.reshape(-1))
