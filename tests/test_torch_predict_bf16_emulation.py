"""The CUDA prediction kernels' own sources on planes read as bfloat16,
compiled for the CPU by g++ as in
tests/test_torch_predict_emulation.py (``qfa_tpu_torch.tools.emulate``),
run through the CUDA wrapper ``_launch`` on CPU tensors and held against
``fused_predict_plain``, which tests/test_torch_infer_kernel.py holds
against the JAX kernel.

Tolerances are ``chip_smoke.py``'s ``TOL`` (those of the CPU parity
tests): ll rtol 2e-5; hmean rtol 1e-4 atol 1e-6; hcov rtol 1e-4 atol 1e-7;
continuum rtol 1e-4 atol 1e-5; std rtol 1e-3 atol 1e-5; n_obs exact. The
kernel and the plain version take their float32 sums in different orders.

Planes stored as bfloat16 (flux/error, the mask plane, the zabs plane,
each alone or together) and continuum/std stored as bfloat16: at 601
pixels a bf16 row is 1202 bytes, so rows start at every even offset mod
16 and chunks begin or end inside a 4-byte word, where cp.async cannot
go (the emulator refuses a copy that is not 4, 8 or 16 bytes from and to
addresses aligned to its size, as the card does). Each case is held
against the plain version on the same planes (TOL), bitwise against the
float32 kernel on the planes upcast (exact), and bitwise row by row; with
bf16 output the planes are the float32 call's cast, the stats unchanged.

bfloat16 flux and error go to ``csrc/predict_tc.cu`` (tiles of 64 spectra,
the products as mma.sync TF32 tensor-core products, which the emulator
computes from the PTX fragment layout), float32 ones (a mixed pair is read
as float32) to ``csrc/predict.cu``. The exact witness of a call is the
same body on the planes upcast: ``predict_tc.cu``'s float32 instantiation
(never routed from ``fused_predict``) when flux and error are bfloat16.
The tc body is held at nh 3, 8 and 10 (the Gram triangle and F padded to
40 + 8 = 48 columns at nh 8, 56 + 16 = 72 at nh 10), at 150 spectra (three
tiles, the last a part tile, two of them walked by one emulated block),
and with fully masked rows; each launch is counted per body.
"""

import functools

import pytest
import torch

from _predict_emulation import (  # noqa: F401 (emulated: a fixture)
    FLOAT32_READ_CASES,
    BF16_CASES,
    COUNTS,
    MASKED,
    MODES,
    TC_CASES,
    TC_TILE,
    TOL,
    assert_close,
    assert_equal,
    call,
    counts,
    emulated,
    kernel,
    moved,
    plane_and_out_dtypes,
    problem,
    witness,
)
from qfa_tpu_torch.ops.infer_kernel import fused_predict_plain


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", [c for c in BF16_CASES
                                  if c not in FLOAT32_READ_CASES])
def test_emulated_kernel_plane_and_out_dtypes(emulated, case, mode):
    """Planes read as bfloat16: the mask and zabs planes on predict.cu,
    flux and error on the tc body (planes read as float32:
    tests/test_torch_predict_emulation.py). See ``plane_and_out_dtypes``."""
    plane_and_out_dtypes(case, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", TC_CASES)
def test_emulated_tc_body_matches_plain(emulated, case, mode):
    """The tc body at nh 3 (nh 8: the test above), 27 spectra, every mode,
    full output and stats_only: within TOL of the plain version on the
    same planes, bitwise its float32 instantiation on the planes upcast;
    rows alone and the planes moved in memory bitwise the batch; bf16
    output the float32 call's cast. Each call one tc launch."""
    bf = torch.bfloat16
    params, mu, data = problem(3, 27, 31)
    planes = {k: v.to(bf) if k in BF16_CASES[case] else v
              for k, v in data.items()}
    before = counts()
    for stats_only in (False, True):
        got = call(kernel, params, mu, planes, mode, stats_only)
        assert_close(got, call(fused_predict_plain, params, mu, planes, mode,
                               stats_only), stats_only)
        assert_equal(got, witness(params, mu, planes, mode, stats_only))
    batch = call(kernel, params, mu, planes, mode)
    assert_equal(call(kernel, params, mu, planes, mode, rows=slice(5, 9)),
                 batch, slice(5, 9))
    assert_equal(call(kernel, params, mu, moved(planes), mode), batch)
    out = call(kernel, params, mu, planes, mode, out_dtype=bf)
    for name in TOL:
        a, b = getattr(out, name), getattr(batch, name)
        want = b.to(bf) if name.startswith("continuum") else b
        assert a.dtype == want.dtype and torch.equal(a, want), name
    after = counts()
    assert after["TC_LAUNCHES"] - before["TC_LAUNCHES"] == 8
    assert after["WARP_LAUNCHES"] == before["WARP_LAUNCHES"]


@pytest.mark.parametrize("nh", [1, 10])
def test_emulated_tc_body_nh_edges(emulated, nh):
    """nh 1 (8 + 8 table columns) and nh 10 (56 + 16 = 72): within TOL of
    the plain version, bitwise the float32 instantiation."""
    bf = torch.bfloat16
    params, mu, data = problem(nh, 11, 200 + nh)
    planes = {k: v.to(bf) if k in ("flux", "error") else v
              for k, v in data.items()}
    got = call(kernel, params, mu, planes, MODES[0])
    assert got.hcov.shape == (11, nh, nh)
    assert_close(got, call(fused_predict_plain, params, mu, planes, MODES[0]),
                 False)
    assert_equal(got, witness(params, mu, planes, MODES[0]))


@pytest.mark.parametrize("mode", [MODES[0], MODES[3]])
def test_emulated_tc_body_ragged_tiles(emulated, mode):
    """150 spectra: tiles of 64, 64 and 22 rows, the first and the last
    walked by one emulated block, so its ring runs on from one tile into
    the next. Within TOL of the plain version; rows across a tile's edge,
    and a row of the part tile, alone bitwise the batch."""
    bf = torch.bfloat16
    n = 150
    assert n % TC_TILE and n > 2 * TC_TILE
    params, mu, data = problem(8, n, 41)
    planes = {k: v.to(bf) if k in ("flux", "error") else v
              for k, v in data.items()}
    batch = call(kernel, params, mu, planes, mode)
    assert_close(batch, call(fused_predict_plain, params, mu, planes, mode),
                 False)
    for rows in (slice(60, 70), slice(149, 150)):
        assert_equal(call(kernel, params, mu, planes, mode, rows=rows),
                     batch, rows)


def test_emulated_tc_body_fully_masked_rows_are_prior(emulated):
    """A fully masked row: ll = 0, n_obs = 0, hmean = 0, hcov = I, the
    continuum mu, std the prior's sqrt(diag(F F^T))."""
    params, mu, data = problem(8, 11, 3)
    planes = {k: v.to(torch.bfloat16) if k in ("flux", "error") else v
              for k, v in data.items()}
    out = call(kernel, params, mu, planes, MODES[3])
    f = params.F
    for r in MASKED:
        assert float(out.ll[r]) == 0.0 and float(out.n_obs[r]) == 0.0
        assert torch.equal(out.hmean[r], torch.zeros(8))
        assert torch.equal(out.hcov[r], torch.eye(8))
        assert torch.equal(out.continuum[r], mu)
        torch.testing.assert_close(out.continuum_std[r],
                                   torch.sqrt((f * f).sum(dim=1)))


def test_emulated_bodies_by_plane_type(emulated):
    """fused_predict's routing: bfloat16 flux and error run the tc body,
    float32 and mixed pairs (read as float32: no bfloat16 plane)
    predict.cu, bitwise the warp body called by
    name (predict.cu, as it was); the float32 instantiation of the tc body
    is reached only by name and reads no bfloat16 plane. One count per
    launch, in LAUNCHES and in its body's."""
    params, mu, data = problem(3, 11, 51)
    bf = torch.bfloat16
    cases = (({}, "WARP_LAUNCHES", None), ({}, "TC_LAUNCHES", "tc"),
             ({"flux"}, "WARP_LAUNCHES", None),
             ({"flux", "error"}, "TC_LAUNCHES", None),
             ({"flux", "error"}, "WARP_LAUNCHES", "warp"))
    for which, body, name in cases:
        planes = {k: v.to(bf) if k in which else v for k, v in data.items()}
        before = counts()
        got = call(functools.partial(kernel, body=name), params, mu, planes,
                   MODES[0])
        after = counts()
        assert {k: after[k] - before[k] for k in COUNTS} == {
            "LAUNCHES": 1, "BF16_LAUNCHES": int(len(which) == 2),
            "TC_LAUNCHES": int(body == "TC_LAUNCHES"),
            "WARP_LAUNCHES": int(body == "WARP_LAUNCHES")}, (which, name)
        if body == "WARP_LAUNCHES" and name is None:
            assert_equal(got, witness(params, mu, planes, MODES[0]))
    with pytest.raises(ValueError, match="no prediction body"):
        call(functools.partial(kernel, body="simt"), params, mu, data,
             MODES[0])
