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
each tile's pixel axis cut into parts walked by separate blocks, the
products as mma.sync TF32 tensor-core products, which the emulator
computes from the PTX fragment layout), float32 ones (a mixed pair is read
as float32) to ``csrc/predict.cu`` below ``TC_MIN_ROWS`` spectra and to
the tc body's float32 instantiation at or above it. The exact witness of
a call is the same body on the planes upcast: ``predict_tc.cu``'s float32
instantiation when flux and error are bfloat16. The tc body is held at nh
3, 8 and 10 (the Gram triangle and F padded to 40 + 8 = 48 columns at nh
8, 56 + 16 = 72 at nh 10), at 150 spectra (three tiles, the last a part
tile; at 601 pixels each tile in three parts of 256, 256 and 89 pixels,
so that the two emulated blocks of the persistent grid walk nine items),
on float32 planes through the route too, and with fully masked rows; its
table launch is held bitwise to the plain ``_tc_table``; each launch is
counted per body.
"""

import ctypes
import functools

import pytest
import torch

from _predict_emulation import (  # noqa: F401 (emulated: a fixture)
    FLOAT32_READ_CASES,
    BF16_CASES,
    COUNTS,
    MASKED,
    MODES,
    NB,
    NPIX,
    NHS,
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
from qfa_tpu_torch.ops import infer_kernel
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


def test_emulated_bodies_by_plane_type(emulated, monkeypatch):
    """fused_predict's routing: bfloat16 flux and error run the tc body
    whatever N; float32 and mixed pairs (read as float32: no bfloat16
    plane) run predict.cu below TC_MIN_ROWS spectra, bitwise the warp body
    called by name (predict.cu, as it was), and the tc body's float32
    instantiation at or above it, bitwise that body called by name and
    counted in TC_F32_LAUNCHES; either body is reached by name whatever
    the planes and N. One count per launch, in LAUNCHES and in its
    body's. (TC_MIN_ROWS is lowered around the call's 11 rows.)"""
    n = 11
    params, mu, data = problem(3, n, 51)
    bf = torch.bfloat16
    # (planes stored as bf16, TC_MIN_ROWS, the body that runs, by name)
    cases = (({}, n + 1, "warp", None), ({}, n + 1, "tc", "tc"),
             ({"flux"}, n + 1, "warp", None),
             ({"flux", "error"}, n + 1, "tc", None),
             ({"flux", "error"}, n + 1, "warp", "warp"),
             ({}, n, "tc", None), ({"flux"}, n, "tc", None),
             ({}, n, "warp", "warp"), ({"flux", "error"}, n, "tc", None),
             ({"flux", "error"}, 1, "tc", None))
    for which, min_rows, body, name in cases:
        monkeypatch.setattr(infer_kernel, "TC_MIN_ROWS", min_rows)
        planes = {k: v.to(bf) if k in which else v for k, v in data.items()}
        before = counts()
        got = call(functools.partial(kernel, body=name), params, mu, planes,
                   MODES[0])
        after = counts()
        assert {k: after[k] - before[k] for k in COUNTS} == {
            "LAUNCHES": 1, "BF16_LAUNCHES": int(len(which) == 2),
            "TC_LAUNCHES": int(body == "tc"),
            "WARP_LAUNCHES": int(body == "warp"),
            "TC_F32_LAUNCHES": int(body == "tc" and len(which) < 2)}, (
                which, min_rows, name)
        if name is None and body == "warp":
            assert_equal(got, witness(params, mu, planes, MODES[0]))
        elif name is None:
            assert_equal(got, call(functools.partial(kernel, body="tc"),
                                   params, mu, planes, MODES[0]))
    with pytest.raises(ValueError, match="no prediction body"):
        call(functools.partial(kernel, body="simt"), params, mu, data,
             MODES[0])


def test_emulated_tc_split_of_the_pixel_axis(emulated):
    """The tc body's parts of the pixel axis: NPIX 601 gives three of 256,
    256 and 89 pixels (the last ragged, a boundary at pixel 256 inside the
    blue side of NB 300 pixels); at both published widths (1,913 and
    9,243 pixels) an 8,192-row call makes at least two blocks' worth of
    (tile, part) items for each of an H100's 132 SMs."""
    def parts(npix):
        px = ctypes.c_int()
        return emulated.qfa_predict_tc_parts(npix, ctypes.byref(px)), px.value

    assert parts(NPIX) == (3, 256) and 256 < NB
    for npix in (NPIX, 1913, 9243):
        k, px = parts(npix)
        assert px % 128 == 0 and (k - 1) * px < npix <= k * px, npix
        if npix > NPIX:
            assert 8192 // TC_TILE * k >= 2 * 132, npix


@pytest.mark.parametrize("nh", NHS)
def test_emulated_tc_table_launch_matches_plain(emulated, nh):
    """The table kernel's table is ``_tc_table``'s (the plain version)
    bitwise, the rounding ties to TF32 included (rows 0 and 1 hold
    +-(1 + 2^-11), whose low 13 bits are 0x1000)."""
    g = torch.Generator().manual_seed(300 + nh)
    F = torch.randn(NPIX, nh, generator=g)
    F[0], F[1] = 1 + 2.0 ** -11, -(1 + 2.0 ** -11)
    want = infer_kernel._tc_table(F, emulated.qfa_predict_tc_chunk())
    got = torch.full_like(want, float("nan"))
    assert emulated.qfa_predict_tc_table(F.data_ptr(), NPIX, nh,
                                         got.data_ptr(), 0, None) == 0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("stats_only", [False, True])
@pytest.mark.parametrize("case", ["float32", "bf16 flux/error"])
def test_emulated_tc_split_body(emulated, monkeypatch, case, stats_only):
    """The tc body with each tile's pixel axis in three parts (NPIX 601),
    float32 planes routed to it (TC_MIN_ROWS lowered to 1) and bf16 ones,
    150 spectra (tiles of 64, 64 and 22 rows; rows 3 and 9 fully masked)
    in desi-predict's mode (derived mask, zq column): within TOL of the
    plain version; the fully masked rows the prior; rows alone (one, ten
    across a tile's edge, the part tile's last, all but the first) and
    the planes moved one element in memory bitwise the batch. Every call
    runs the tc body, counted in TC_F32_LAUNCHES on float32 planes."""
    monkeypatch.setattr(infer_kernel, "TC_MIN_ROWS", 1)
    n, mode = 150, MODES[3]
    params, mu, data = problem(8, n, 61)
    planes = {k: v.to(torch.bfloat16) if k in BF16_CASES[case] else v
              for k, v in data.items()}
    before = counts()
    batch = call(kernel, params, mu, planes, mode, stats_only)
    assert_close(batch, call(fused_predict_plain, params, mu, planes, mode,
                             stats_only), stats_only)
    for r in MASKED:
        assert float(batch.ll[r]) == 0.0 and float(batch.n_obs[r]) == 0.0
        assert torch.equal(batch.hmean[r], torch.zeros(8))
        assert torch.equal(batch.hcov[r], torch.eye(8))
    for rows in (slice(0, 1), slice(60, 70), slice(149, 150), slice(1, n)):
        assert_equal(call(kernel, params, mu, planes, mode, stats_only,
                          rows=rows), batch, rows)
    assert_equal(call(kernel, params, mu, moved(planes), mode, stats_only),
                 batch)
    after = counts()
    assert after["TC_LAUNCHES"] - before["TC_LAUNCHES"] == 6
    assert after["TC_F32_LAUNCHES"] - before["TC_F32_LAUNCHES"] == \
        6 * (case == "float32")
    assert after["WARP_LAUNCHES"] == before["WARP_LAUNCHES"]
