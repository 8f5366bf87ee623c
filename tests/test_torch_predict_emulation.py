"""The CUDA prediction kernel's own source (``csrc/predict.cu``) on
planes read as float32 (float32 and bfloat16 outputs), compiled for the
CPU by g++ (``qfa_tpu_torch.tools.emulate``: one thread per CUDA thread,
asynchronous copies that land only when waited for, shared memory filled
with NaN before each block), run through the CUDA wrapper ``_launch`` on
CPU tensors and held against ``fused_predict_plain``, which
tests/test_torch_infer_kernel.py holds against the JAX kernel. Planes
read as bfloat16, and ``csrc/predict_tc.cu``, are
tests/test_torch_predict_bf16_emulation.py; the library, the problem and
the comparisons are tests/_predict_emulation.py.

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

import pytest
import torch

from _predict_emulation import (  # noqa: F401 (emulated: a fixture)
    FLOAT32_READ_CASES,
    MASKED,
    MODES,
    NB,
    NPIX,
    TILE,
    assert_close,
    assert_equal,
    call,
    emulated,
    kernel,
    moved,
    plane_and_out_dtypes,
    problem,
)
from qfa_tpu_torch.ops import infer_kernel
from qfa_tpu_torch.ops.infer_kernel import fused_predict_plain


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
    assert_equal(call(kernel, params, mu, moved(data), mode), batch)
    assert infer_kernel.LAUNCHES == launches + 7


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", FLOAT32_READ_CASES)
def test_emulated_kernel_plane_and_out_dtypes(emulated, case, mode):
    """Planes read as float32: float32 planes, and bf16 flux beside
    float32 error (a mixed pair is read as float32); float32 and bfloat16
    outputs. Planes read as bfloat16:
    tests/test_torch_predict_bf16_emulation.py. See
    ``plane_and_out_dtypes``."""
    plane_and_out_dtypes(case, mode)
