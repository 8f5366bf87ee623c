"""The CUDA prediction kernels' own sources (``csrc/predict.cu`` and
``csrc/predict_tc.cu``), compiled for the CPU by g++ (``qfa_tpu_torch.tools.emulate``: one thread per CUDA
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
TC_TILE = 64  # spectra per block tile of csrc/predict_tc.cu (kM)
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
#: the planes stored as bfloat16 in each case
BF16_CASES = {"float32": (), "bf16 flux/error": ("flux", "error"),
              "bf16 flux": ("flux",), "bf16 mask/zabs": ("mask", "zabs"),
              "bf16 planes": ("flux", "error", "mask", "zabs")}


#: the bf16 cases whose flux and error are both bfloat16: the tc body's
TC_CASES = [k for k, v in BF16_CASES.items() if {"flux", "error"} <= set(v)]
COUNTS = ("LAUNCHES", "BF16_LAUNCHES", "TC_LAUNCHES", "WARP_LAUNCHES")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    src = (_build.CSRC / "predict.cu").read_text()
    assert f"constexpr int kWarps = {TILE};" in src
    tc = (_build.CSRC / "predict_tc.cu").read_text()
    assert f"constexpr int kM = {TC_TILE};" in tc
    lib = emulate.load(emulate.build(tmp_path_factory.mktemp("emu"), NHS,
                                     source=("predict.cu", "predict_tc.cu")))
    before = {k: getattr(infer_kernel, k) for k in COUNTS}
    with emulate.installed(lib):
        yield lib
    # these calls went through the CUDA wrapper on CPU tensors; other
    # files check that CPU calls never count
    for k, v in before.items():
        setattr(infer_kernel, k, v)


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
         zabs=None, out_dtype=torch.float32):
    mask = data["mask"][rows] if mode.startswith("mask plane") else None
    kw = dict(stats_only=stats_only, out_dtype=out_dtype)
    if mode.endswith("zq column"):
        z = data["zq"][rows]
        kw.update(loglam=data["loglam"], derive_zabs=True)
    else:
        z = (data["zabs"] if zabs is None else zabs)[rows]
    return fn(params, mu, data["flux"][rows], data["error"][rows],
              z.contiguous(), None if mask is None else mask.contiguous(),
              **kw)


def kernel(params, mu, flux, error, zabs, mask, *, stats_only=False,
           loglam=None, derive_zabs=False, out_dtype=torch.float32,
           body=None):
    """``fused_predict``'s CUDA branch, on whatever device the tensors
    are on; ``body`` as ``infer_kernel._fused_predict_body`` takes it."""
    infer_kernel._check_args(params, flux, error, zabs, mask, loglam,
                             derive_zabs)
    return infer_kernel._launch(
        params, mu, flux.contiguous(), error.contiguous(), zabs, mask,
        law=tau_law_abc("becker"), stats_only=stats_only, loglam=loglam,
        derive_zabs=derive_zabs, out_dtype=out_dtype, body=body)


def tc_body(planes):
    return planes["flux"].dtype is torch.bfloat16 and \
        planes["error"].dtype is torch.bfloat16


def witness(params, mu, planes, mode, stats_only=False):
    """The exact witness of a kernel call on ``planes``: the same body on
    the planes upcast (exact): predict_tc.cu's float32 instantiation when
    flux and error are bfloat16, else predict.cu."""
    upcast = {k: v.float() for k, v in planes.items()}
    body = "tc" if tc_body(planes) else "warp"
    return call(functools.partial(kernel, body=body), params, mu, upcast,
                mode, stats_only)


def counts():
    return {k: getattr(infer_kernel, k) for k in COUNTS}


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
        assert (a is None and b is None) or torch.equal(a, b[rows]), name


def moved(data):
    """The same planes one element further into their storage: every row
    starts at another offset mod 16 bytes."""
    out = {}
    for k, v in data.items():
        buf = torch.empty(v.numel() + 1, dtype=v.dtype)
        out[k] = buf[1:].view(v.shape).copy_(v)
    return out


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
@pytest.mark.parametrize("case", list(BF16_CASES))
def test_emulated_kernel_plane_and_out_dtypes(emulated, case, mode):
    """27 spectra with the case's planes stored as bfloat16, full output
    and stats_only: (a) within TOL of the plain version on the same
    planes; (b) bitwise the same body's float32 kernel on the planes
    upcast (predict_tc.cu's float32 instantiation for bf16 flux/error,
    predict.cu otherwise); (c) rows alone, and the planes moved one
    element in memory, bitwise the batch. With out_dtype=bfloat16 the
    planes are the float32 call's cast, and the stats are float32 and
    bitwise unchanged. Every call on the case's planes runs the body its
    flux/error type picks."""
    bf = torch.bfloat16
    params, mu, data = problem(8, 27, 21)
    planes = {k: v.to(bf) if k in BF16_CASES[case] else v
              for k, v in data.items()}
    bf16_launches = infer_kernel.BF16_LAUNCHES
    before = counts()
    for stats_only in (False, True):
        got = call(kernel, params, mu, planes, mode, stats_only)
        assert_close(got, call(fused_predict_plain, params, mu, planes, mode,
                               stats_only), stats_only)
        assert_equal(got, witness(params, mu, planes, mode, stats_only))
    batch = call(kernel, params, mu, planes, mode)
    for rows in (slice(0, 1), slice(5, 6), slice(13, 18)):
        assert_equal(call(kernel, params, mu, planes, mode, rows=rows), batch,
                     rows)
    assert_equal(call(kernel, params, mu, moved(planes), mode), batch)
    out = call(kernel, params, mu, planes, mode, out_dtype=bf)
    for name in TOL:
        a, b = getattr(out, name), getattr(batch, name)
        want = b.to(bf) if name.startswith("continuum") else b
        assert a.dtype == want.dtype and torch.equal(a, want), name
    # every call on these planes read a bf16 plane if the mode has one of
    # the case's planes (flux and error count together: a mixed pair is
    # read as float32); the upcast calls did not; the bf16 out call did
    case = set(BF16_CASES[case])
    own = {"mask"} if mode.startswith("mask plane") else set()
    own |= {"zabs"} if "zabs plane" in mode else set()
    read_bf16 = {"flux", "error"} <= case or bool(own & case)
    assert infer_kernel.BF16_LAUNCHES == bf16_launches + 7 * read_bf16 + 1
    # 8 calls on the case's planes and 2 witnesses, each of the body the
    # flux/error type picks
    body = "TC_LAUNCHES" if {"flux", "error"} <= case else "WARP_LAUNCHES"
    after = counts()
    assert after["LAUNCHES"] - before["LAUNCHES"] == 10
    assert after[body] - before[body] == 10


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
