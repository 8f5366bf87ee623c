"""The CUDA step kernels' own source (``csrc/step.cu``), compiled for the
CPU by g++ (``qfa_tpu_torch.tools.emulate``: one thread per CUDA thread,
the blocks of a launch one after another), run through the CUDA wrapper
``_launch`` on CPU tensors and held against ``fused_loss_grads_plain``,
which tests/test_torch_step.py holds against the JAX kernel.

Tolerances are those of tests/test_torch_step.py and of ``chip_smoke.py``'s
phase 10: the loss sum rtol 1e-5, counts exact, each gradient to atol
1e-4 * max|g|; the kernels and the plain version take their float32 sums
in different orders.

The shapes leave every edge ragged: 45 rows are five row tiles of 8 and a
part tile of 5, one chunk of 32 rows and a part chunk of 13; 301 pixels
are one forward block of 256 and a part block (so the per-row finish
sums two pixel tiles' partials), four backward blocks of 64 and a part
one, and 18 finish blocks of 16 and a part one; the blue side ends inside
a tile (117 pixels) or on a tile edge of every kernel (128, two of the
forward's 64-pixel sub-tiles), or covers every pixel. Row 3 is fully
masked and row 5 has weight 0. And, bitwise: two calls give the same bits
(with and without the early launch), and every arrival counter is zero
after a call, so the next call needs no clearing.
"""

import numpy as np
import pytest
import torch

from qfa_tpu_torch.data.batch import SpectraBatch
from qfa_tpu_torch.models.params import PARAM_NAMES, QFAParams
from qfa_tpu_torch.ops import fused_step
from qfa_tpu_torch.ops.common import TAU_LAW_ABC, tau_law_abc
from qfa_tpu_torch.ops.fused_step import fused_loss_grads_plain
from qfa_tpu_torch.tools import emulate

NHS = (1, 3, 8)
NPIX, ROWS = 301, 45
MASKED, WEIGHT0 = 3, 5
LOSS_RTOL, GRAD_REL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = emulate.load(emulate.build(tmp_path_factory.mktemp("emu"), NHS,
                                     source="step.cu"))
    before = fused_step.LAUNCHES
    with emulate.installed(lib):
        yield lib
    # these calls went through the CUDA wrapper on CPU tensors; other
    # files check that CPU calls never count
    fused_step.LAUNCHES = before
    fused_step._SCRATCH.clear()


def problem(nh, nb, rows=ROWS, seed=0, n_real=None):
    """Seeded parameters and a batch (10 % of pixels masked, row MASKED
    fully masked, row WEIGHT0 at weight 0); with ``n_real``, the rows past
    it are weight-0 copies of row 0, as the stream's tail batch."""
    g = np.random.default_rng(seed)
    f32 = np.float32
    params = QFAParams(
        F=torch.tensor(g.uniform(-0.5, 0.5, (NPIX, nh)).astype(f32)),
        Psi=torch.tensor(g.uniform(0.3, 0.6, NPIX).astype(f32)),
        omega=torch.tensor(g.uniform(0.3, 0.8, nb).astype(f32)),
        tau0=torch.tensor(0.12), c0=torch.tensor(0.2),
        beta=torch.tensor(2.4))
    mask = (g.uniform(size=(rows, NPIX)) > 0.1).astype(f32)
    error = g.uniform(0.05, 0.15, (rows, NPIX)).astype(f32)
    delta = (0.3 * g.normal(size=(rows, NPIX))).astype(f32) * mask
    zabs = g.uniform(1.8, 3.5, (rows, nb)).astype(f32)
    weight = np.ones(rows, f32)
    if rows > WEIGHT0:
        mask[MASKED] = 0.0
        weight[WEIGHT0] = 0.0
    planes = [delta, error, zabs, mask]
    if n_real is not None:
        idx = np.where(np.arange(rows) < n_real, np.arange(rows), 0)
        planes = [x[idx] for x in planes]
        weight[n_real:] = 0.0
    return params, SpectraBatch(*(torch.tensor(x) for x in planes),
                                weight=torch.tensor(weight))


def kernel(params, batch, law="becker"):
    return fused_step._launch(params, batch, tau_law_abc(law))


def assert_matches(got, want):
    lk, lp = float(got.loss_sum), float(want.loss_sum)
    assert np.isfinite(lk) and lk == pytest.approx(lp, rel=LOSS_RTOL)
    assert torch.equal(got.counts.pix, want.counts.pix)
    assert float(got.counts.scalar) == float(want.counts.scalar)
    for k in PARAM_NAMES:
        a, b = getattr(got.grads, k), getattr(want.grads, k)
        assert a.shape == b.shape, k
        scale = float(b.abs().max()) + 1e-12
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=GRAD_REL * scale, err_msg=k)


@pytest.mark.parametrize("nh", NHS)
@pytest.mark.parametrize("nb", [117, 128, NPIX])
def test_kernel_matches_plain(emulated, nh, nb):
    params, batch = problem(nh, nb, seed=nh + nb)
    before = fused_step.LAUNCHES
    got = kernel(params, batch)
    assert fused_step.LAUNCHES == before + 1
    want = fused_loss_grads_plain(params, batch)
    assert_matches(got, want)
    # the weight-0 row and the fully masked row are counted nowhere
    assert float(got.counts.scalar) <= ROWS - 2
    assert float(got.counts.pix.max()) <= ROWS - 2


@pytest.mark.parametrize("law", sorted(TAU_LAW_ABC))
def test_each_tau_law(emulated, law):
    params, batch = problem(3, 117, seed=7)
    assert_matches(kernel(params, batch, law),
                   fused_loss_grads_plain(params, batch, tau_which=law))


@pytest.mark.parametrize("rows", [1, 40])
def test_tail_batches_and_a_single_row(emulated, rows):
    """The stream's tail batch (real rows, then weight-0 copies of row 0)
    and a batch of one row."""
    params, batch = problem(8, 117, rows=rows, seed=11,
                            n_real=None if rows == 1 else 29)
    got = kernel(params, batch)
    assert_matches(got, fused_loss_grads_plain(params, batch))
    if rows > 1:  # 29 real rows, one fully masked, one at weight 0
        assert float(got.counts.pix.max()) <= 29 - 2


def test_bitwise_repeat_and_counters_at_zero(emulated, monkeypatch):
    """A second call, with each kernel launched when the one before it has
    ended (``EARLY_LAUNCH`` off), gives the first call's bits."""
    params, batch = problem(8, 117, seed=3)
    a = kernel(params, batch)
    counters = [v[2] for v in fused_step._SCRATCH.values()]
    assert counters and all(not bool(c.any()) for c in counters)
    monkeypatch.setattr(fused_step, "EARLY_LAUNCH", False)
    b = kernel(params, batch)
    # each call's outputs are its own (the wrapper allocates the next
    # call's buffer in advance)
    assert a.grads.F.data_ptr() != b.grads.F.data_ptr()
    assert torch.equal(a.loss_sum, b.loss_sum)
    assert torch.equal(a.counts.pix, b.counts.pix)
    for k in PARAM_NAMES:
        assert torch.equal(getattr(a.grads, k), getattr(b.grads, k)), k
    assert all(not bool(v[2].any()) for v in fused_step._SCRATCH.values())
