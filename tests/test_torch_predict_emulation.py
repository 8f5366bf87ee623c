"""The CUDA prediction kernel's own source (``csrc/predict.cu``), compiled
for the CPU by g++ (``qfa_tpu_torch.tools.emulate``: one thread per CUDA
thread, asynchronous copies that land only when waited for, shared memory
filled with NaN before each block), run through the CUDA wrapper
``_launch`` on CPU tensors and held against ``fused_predict_plain``, which
tests/test_torch_infer_kernel.py holds against the JAX kernel.

Tolerances are ``chip_smoke.py``'s ``TOL`` (those of the CPU parity
tests): ll rtol 2e-5; hmean rtol 1e-4 atol 1e-6; hcov rtol 1e-4 atol 1e-7;
continuum rtol 1e-4 atol 1e-5; std rtol 1e-3 atol 1e-5; n_obs exact. The
kernel and the plain version take their float32 sums in different orders.

The shapes leave every edge ragged: 601 pixels are two chunks of 256 and
one of 89, the blue side (300 pixels) ends inside the second chunk, 11 and
27 spectra leave a part tile of 3 (tiles of 8 spectra, one per warp), and
rows of an odd width start at every offset mod 16 bytes. The emulated
card has 2 SMs of one block each, so at 27 spectra each block walks two
tiles and its ring of copies runs on from one into the next. And,
bitwise: a row's outputs do not depend on its batch, its tile or its
neighbours, nor on the run.
"""

import numpy as np
import pytest
import torch

from qfa_tpu_torch.models.params import QFAParams
from qfa_tpu_torch.ops import _build, infer_kernel
from qfa_tpu_torch.ops.common import loglam_row, tau_law_abc, zq_column
from qfa_tpu_torch.ops.infer_kernel import fused_predict_plain
from qfa_tpu_torch.tools import emulate

NHS = (1, 3, 8, 10)
TILE = 8  # spectra per block tile, one per warp (kWarps in csrc/predict.cu)
NPIX, NB = 601, 300
MASKED = (3, 9)  # fully masked rows
TOL = {
    "ll": dict(rtol=2e-5, atol=0.0),
    "hmean": dict(rtol=1e-4, atol=1e-6),
    "hcov": dict(rtol=1e-4, atol=1e-7),
    "continuum": dict(rtol=1e-4, atol=1e-5),
    "continuum_std": dict(rtol=1e-3, atol=1e-5),
    "n_obs": dict(rtol=0.0, atol=0.0),
}
MODES = ("mask plane + zabs plane", "derived mask + zabs plane",
         "mask plane + zq column", "derived mask + zq column")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    src = (_build.CSRC / "predict.cu").read_text()
    assert f"constexpr int kWarps = {TILE};" in src
    lib = emulate.load(emulate.build(tmp_path_factory.mktemp("emu"), NHS,
                                     source="predict.cu"))
    before = infer_kernel.LAUNCHES
    with emulate.installed(lib):
        yield lib
    # these calls went through the CUDA wrapper on CPU tensors; other
    # files check that CPU calls never count
    infer_kernel.LAUNCHES = before


def problem(nh, n, seed, npix=NPIX, nb=NB):
    """Seeded parameters, mean continuum and n spectra drawn from the
    model (10 % of pixels masked, rows MASKED fully), as torch tensors."""
    g = np.random.default_rng(seed)
    f32 = np.float32
    F = g.uniform(-0.5, 0.5, (npix, nh)).astype(f32)
    params = QFAParams(
        F=torch.tensor(F),
        Psi=torch.tensor(g.uniform(0.3, 0.6, npix).astype(f32)),
        omega=torch.tensor(g.uniform(0.3, 0.8, nb).astype(f32)),
        tau0=torch.tensor(0.12), c0=torch.tensor(0.2),
        beta=torch.tensor(2.4))
    mu = g.uniform(0.8, 1.2, npix).astype(f32)
    mask = (g.uniform(size=(n, npix)) > 0.1).astype(f32)
    mask[[r for r in MASKED if r < n]] = 0.0
    err = g.uniform(0.05, 0.15, (n, npix)).astype(f32) * mask
    cont = mu + g.normal(size=(n, nh)).astype(f32) @ F.T
    flux = (cont + 0.3 * g.normal(size=(n, npix))).astype(f32) * mask
    zq = g.uniform(2.0, 3.5, n).astype(f32)
    lam = np.exp(np.log(1030.0) + 1e-3 * np.arange(npix))
    zabs = ((1 + zq[:, None]) * lam[None, :nb] / 1215.67 - 1).astype(f32)
    data = {"flux": torch.tensor(flux), "error": torch.tensor(err),
            "mask": torch.tensor(mask), "zabs": torch.tensor(zabs),
            "zq": zq_column(torch.tensor(zq)), "loglam": loglam_row(lam)}
    return params, torch.tensor(mu), data


def call(fn, params, mu, data, mode, stats_only=False, rows=slice(None),
         zabs=None):
    mask = data["mask"][rows] if mode.startswith("mask plane") else None
    kw = dict(stats_only=stats_only)
    if mode.endswith("zq column"):
        z = data["zq"][rows]
        kw.update(loglam=data["loglam"], derive_zabs=True)
    else:
        z = (data["zabs"] if zabs is None else zabs)[rows]
    return fn(params, mu, data["flux"][rows], data["error"][rows],
              z.contiguous(), None if mask is None else mask.contiguous(),
              **kw)


def kernel(params, mu, flux, error, zabs, mask, *, stats_only=False,
           loglam=None, derive_zabs=False):
    """``fused_predict``'s CUDA branch, on whatever device the tensors
    are on."""
    infer_kernel._check_args(params, flux, error, zabs, mask, loglam,
                             derive_zabs)
    return infer_kernel._launch(
        params, mu, flux.contiguous(), error.contiguous(), zabs, mask,
        law=tau_law_abc("becker"), stats_only=stats_only, loglam=loglam,
        derive_zabs=derive_zabs, out_dtype=torch.float32)


def assert_close(got, want, stats_only):
    for name, tol in TOL.items():
        a, b = getattr(got, name), getattr(want, name)
        if stats_only and name.startswith("continuum"):
            assert a is None and b is None, name
            continue
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **tol)


def assert_equal(got, want, rows=slice(None)):
    for name in TOL:
        a, b = getattr(got, name), getattr(want, name)
        assert torch.equal(a, b[rows]), name


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nh", [3, 8])
def test_emulated_kernel_matches_plain(emulated, nh, mode):
    """Every plane mode, full output and stats_only, 27 spectra."""
    params, mu, data = problem(nh, 27, nh)
    for stats_only in (False, True):
        got = call(kernel, params, mu, data, mode, stats_only)
        want = call(fused_predict_plain, params, mu, data, mode, stats_only)
        assert_close(got, want, stats_only)


@pytest.mark.parametrize("nh", [1, 10])
def test_emulated_kernel_nh_edges(emulated, nh):
    params, mu, data = problem(nh, 11, 100 + nh)
    got = call(kernel, params, mu, data, MODES[0])
    assert got.hcov.shape == (11, nh, nh)
    assert_close(got, call(fused_predict_plain, params, mu, data, MODES[0]),
                 False)


@pytest.mark.parametrize("n", [1, TILE + 3])
def test_emulated_kernel_small_batches(emulated, n):
    """One spectrum, and one tile plus a part tile."""
    params, mu, data = problem(8, n, 7 + n)
    for mode in (MODES[0], MODES[3]):
        got = call(kernel, params, mu, data, mode)
        assert_close(got, call(fused_predict_plain, params, mu, data, mode),
                     False)


@pytest.mark.parametrize("width", ["npix", "p128"])
def test_emulated_kernel_zabs_plane_widths(emulated, width):
    """A zabs plane of width Npix or round_up(Npix, 128) reads only its
    blue part: the same bits as the Nb-wide plane."""
    params, mu, data = problem(3, 11, 5)
    w = NPIX if width == "npix" else -(-NPIX // 128) * 128
    wide = torch.nn.functional.pad(data["zabs"], (0, w - NB), value=7.0)
    ref = call(kernel, params, mu, data, MODES[0])
    assert_equal(call(kernel, params, mu, data, MODES[0], zabs=wide), ref)


def test_emulated_kernel_fully_masked_rows_are_prior(emulated):
    params, mu, data = problem(8, 11, 3)
    out = call(kernel, params, mu, data, MODES[3])
    f = params.F
    for r in MASKED:
        assert float(out.ll[r]) == 0.0 and float(out.n_obs[r]) == 0.0
        assert torch.equal(out.hmean[r], torch.zeros(8))
        assert torch.equal(out.hcov[r], torch.eye(8))
        torch.testing.assert_close(out.continuum[r], mu)
        torch.testing.assert_close(out.continuum_std[r],
                                   torch.sqrt((f * f).sum(dim=1)))


@pytest.mark.parametrize("mode", [MODES[0], MODES[3]])
def test_emulated_rows_are_independent(emulated, mode):
    """Bitwise: a row alone, a few rows, the rows at another offset in
    memory, and a second run all give the batch's outputs; one count per
    call."""
    params, mu, data = problem(8, 27, 11)
    launches = infer_kernel.LAUNCHES
    batch = call(kernel, params, mu, data, mode)
    assert_equal(call(kernel, params, mu, data, mode), batch)
    for rows in (slice(0, 1), slice(5, 6), slice(13, 18), slice(1, 27)):
        assert_equal(call(kernel, params, mu, data, mode, rows=rows), batch,
                     rows)
    # the same planes one float further into their storage: every row
    # starts at another offset mod 16 bytes
    moved = {}
    for k, v in data.items():
        buf = torch.empty(v.numel() + 1)
        moved[k] = buf[1:].view(v.shape).copy_(v)
    assert_equal(call(kernel, params, mu, moved, mode), batch)
    assert infer_kernel.LAUNCHES == launches + 7
