"""What ``test_torch_predict_emulation.py`` (``csrc/predict.cu`` on
planes read as float32) and ``test_torch_predict_bf16_emulation.py``
(planes read as bfloat16, on both bodies, and ``csrc/predict_tc.cu``)
share: the emulated library of both sources, the seeded problem, the
calls, the comparisons, and the plane and output dtype cases that both
files run. Each file builds its own library (a module-scoped fixture).

Tolerances are ``chip_smoke.py``'s ``TOL`` (those of the CPU parity
tests): ll rtol 2e-5; hmean rtol 1e-4 atol 1e-6; hcov rtol 1e-4 atol 1e-7;
continuum rtol 1e-4 atol 1e-5; std rtol 1e-3 atol 1e-5; n_obs exact. The
kernel and the plain version take their float32 sums in different orders.
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


#: the cases whose planes are all read as float32 (a bf16 flux beside a
#: float32 error is read as float32): test_torch_predict_emulation.py's
FLOAT32_READ_CASES = ("float32", "bf16 flux")
#: the bf16 cases whose flux and error are both bfloat16: the tc body's
TC_CASES = [k for k, v in BF16_CASES.items() if {"flux", "error"} <= set(v)]
COUNTS = ("LAUNCHES", "BF16_LAUNCHES", "TC_LAUNCHES", "WARP_LAUNCHES",
          "TC_F32_LAUNCHES")


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


def plane_and_out_dtypes(case, mode):
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
