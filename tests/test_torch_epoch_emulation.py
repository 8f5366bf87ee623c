"""The CUDA epoch kernel's own source (``csrc/epoch.cu``), compiled for the
CPU by g++ (``qfa_tpu_torch.tools.emulate``: one thread per CUDA thread),
run through the CUDA wrapper ``_launch`` on CPU tensors and held against
the plain version, which the other files hold against the JAX kernel.

This checks the kernel's tiling, ragged edges, reductions and arrival
counters here, where there is no card: nh 3 and 8, both layouts, float32
and bfloat16 planes and operands, batches whose row and pixel tiles are
ragged, several epochs per call. Tolerances: per-batch loss sums rtol
2e-6 and n_real exact; params, m and v norm-wise 1e-4 (5e-3 with bf16
operands: an operand within one rounding of a bf16 boundary rounds
differently in two summation orders), the kernel's and the plain
version's float32 sums being taken in different orders. And, bitwise:
three epochs in one call equal three chained calls, and a zero tile
after each batch changes nothing.
"""

import numpy as np
import pytest
import torch

from qfa_tpu_torch.models.params import PARAM_NAMES, QFAParams
from qfa_tpu_torch.ops import epoch_kernel
from qfa_tpu_torch.ops.common import loglam_row, tau_law_abc, zq_column
from qfa_tpu_torch.tools import emulate
from qfa_tpu_torch.train import adam

NHS = (3, 8)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = emulate.load(emulate.build(tmp_path_factory.mktemp("emu"), NHS))
    before = epoch_kernel.LAUNCHES
    with emulate.installed(lib):
        yield lib
    # these calls went through the CUDA wrapper on CPU tensors; other
    # files check that CPU calls never count
    epoch_kernel.LAUNCHES = before


def kernel_epoch(params, m, v, delta, error, zabs, perm, mask=None,
                 loglam=None, derive_zabs=False, tile_batch=8, **kw):
    """``fused_train_epoch``'s CUDA branch, on whatever device the
    tensors are on."""
    kw = {"n_epochs": 1, "learning_rate": 1e-2, "weight_decay": 0.01,
          "decay_alpha": 0.9, "decay_step": 10, "b1": 0.9, "b2": 0.999,
          "eps": 1e-8, "reference_norm": True, "mxu_bf16": False, **kw}
    from qfa_tpu_torch.models.params import ParamBounds

    geo = epoch_kernel._check_args(
        params, m, v, delta, error, zabs, perm, mask, loglam, derive_zabs,
        kw["n_batches"], kw["n_epochs"], tile_batch, False, None, None)
    return epoch_kernel._launch(
        params, m, v, delta, error, zabs, mask, loglam, geo,
        derive_zabs=derive_zabs, bounds=ParamBounds(),
        law=tau_law_abc("becker"), **kw)


def plain_epoch(params, m, v, delta, error, zabs, perm, mask=None,
                tile_batch=8, **kw):
    kw = {"learning_rate": 1e-2, "weight_decay": 0.01, **kw}
    return epoch_kernel.fused_train_epoch_plain(
        params, m, v, delta, error, zabs, perm, mask, tile_batch=tile_batch,
        **kw)


def problem(npix, nb, nh, n, seed):
    """Seeded parameters and n spectra (10 % of pixels masked, row 3
    fully masked), as torch tensors."""
    g = np.random.default_rng(seed)
    f32 = np.float32
    params = QFAParams(
        F=torch.tensor(g.uniform(-0.5, 0.5, (npix, nh)).astype(f32)),
        Psi=torch.tensor(g.uniform(0.3, 0.6, npix).astype(f32)),
        omega=torch.tensor(g.uniform(0.3, 0.8, nb).astype(f32)),
        tau0=torch.tensor(0.12), c0=torch.tensor(0.2),
        beta=torch.tensor(2.4))
    mask = (g.uniform(size=(n, npix)) > 0.1).astype(f32)
    mask[3] = 0.0
    err = g.uniform(0.05, 0.15, (n, npix)).astype(f32) * mask
    delta = (0.3 * g.normal(size=(n, npix))).astype(f32) * mask
    zq = g.uniform(2.0, 3.5, n).astype(f32)
    lam = np.exp(np.log(1030.0) + 1e-3 * np.arange(npix))
    zabs = ((1 + zq[:, None]) * lam[None, :nb] / 1215.67 - 1).astype(f32)
    data = {"delta": torch.tensor(delta), "error": torch.tensor(err),
            "mask": torch.tensor(mask), "zabs": torch.tensor(zabs),
            "zq": zq_column(torch.tensor(zq)),
            "loglam": loglam_row(lam)}
    return params, data


def layout(data, name, planes):
    dt = torch.bfloat16 if planes == "bf16" else torch.float32
    args = [data["delta"].to(dt), data["error"].to(dt)]
    if name == "derived":
        return args + [data["zq"]], dict(derive_zabs=True,
                                           loglam=data["loglam"])
    return args + [data["zabs"]], dict(mask=data["mask"])


def assert_close(got, want, mxu):
    np.testing.assert_allclose(got.loss_sums.numpy(),
                               want.loss_sums.numpy(), rtol=2e-6)
    assert torch.equal(got.n_real, want.n_real)
    lim = 5e-3 if mxu else 1e-4
    for part in ("params", "m", "v"):
        for k in PARAM_NAMES:
            a = getattr(getattr(got, part), k).detach()
            b = getattr(getattr(want, part), k).detach()
            rel = float((a - b).norm() / b.norm().clamp(min=1e-30))
            assert rel <= lim, (part, k, rel)


# (npix, nb, nh, spectra, tile, batches, epochs/call, layout, planes,
# mxu_bf16, reference_norm): pixel counts that leave ragged forward
# (256), backward (32) and update (16) tiles; batches of 40 rows (row
# tiles of 8 and a chunk of 8 of 32) and of 100 rows
CASES = [
    (54, 25, 3, 80, 8, 2, 1, "plane", "f32", False, True),
    (300, 120, 8, 80, 8, 2, 2, "derived", "f32", True, True),
    (130, 130, 8, 100, 4, 1, 1, "derived", "bf16", False, False),
    (70, 30, 3, 80, 8, 2, 1, "plane", "bf16", True, True),
]


@pytest.mark.parametrize(
    "npix,nb,nh,n,tb,n_batches,n_epochs,name,planes,mxu,refnorm", CASES)
def test_emulated_kernel_matches_plain(emulated, npix, nb, nh, n, tb,
                                       n_batches, n_epochs, name, planes,
                                       mxu, refnorm):
    params, data = problem(npix, nb, nh, n, npix + nh)
    st = adam.init(params)
    g = np.random.default_rng(1)
    perm = torch.tensor(np.stack([g.permutation(n // tb)
                                  for _ in range(n_epochs)]))
    args, extra = layout(data, name, planes)
    kw = dict(extra, epoch=3, n_batches=n_batches, n_epochs=n_epochs,
              tile_batch=tb, mxu_bf16=mxu, reference_norm=refnorm)
    got = kernel_epoch(params, st.m, st.v, *args, perm, **kw)
    want = plain_epoch(params, st.m, st.v, *args, perm, **kw)
    assert_close(got, want, mxu)


def test_emulated_kernel_is_deterministic(emulated):
    """3 epochs in one call = 3 chained calls; one zero tile after each
    batch changes nothing; both bitwise."""
    params, data = problem(300, 120, 8, 64, 9)
    st = adam.init(params)
    launches = epoch_kernel.LAUNCHES
    g = np.random.default_rng(2)
    perm = torch.tensor(np.stack([g.permutation(8) for _ in range(3)]))
    args, extra = layout(data, "derived", "f32")
    kw = dict(extra, n_batches=2, tile_batch=8, mxu_bf16=True)
    one = kernel_epoch(params, st.m, st.v, *args, perm, epoch=5, n_epochs=3,
                       **kw)
    p, m, v, losses = params, st.m, st.v, []
    for e in range(3):
        out = kernel_epoch(p, m, v, *args, perm[e], epoch=5 + e, **kw)
        p, m, v = out.params, out.m, out.v
        losses.append(out.loss_sums)
    assert torch.equal(one.loss_sums, torch.stack(losses))
    for part, x in (("params", p), ("m", m), ("v", v)):
        for k in PARAM_NAMES:
            assert torch.equal(getattr(getattr(one, part), k),
                               getattr(x, k)), (part, k)
    padded = [torch.cat([t, t.new_zeros((16,) + t.shape[1:])]) for t in args]
    perm_pad = torch.cat([perm[0].reshape(2, -1),
                          torch.arange(8, 10)[:, None]], dim=1).reshape(-1)
    a = kernel_epoch(params, st.m, st.v, *args, perm[0], epoch=0, **kw)
    b = kernel_epoch(params, st.m, st.v, *padded, perm_pad, epoch=0, **kw)
    assert torch.equal(a.loss_sums, b.loss_sums)
    assert torch.equal(a.n_real, b.n_real)
    for part in ("params", "m", "v"):
        for k in PARAM_NAMES:
            assert torch.equal(getattr(getattr(a, part), k),
                               getattr(getattr(b, part), k)), (part, k)
    assert epoch_kernel.LAUNCHES == launches + 6  # one count per call
