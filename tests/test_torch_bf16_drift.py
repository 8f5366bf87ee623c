"""The mechanics of ``chip_smoke.py``'s phase 22, bench.py's drift gate of
bf16 operands (``bench.py:796-834``), run on the CPU through the same
protocol function (``chip_smoke.bf16_drift``), where the epoch wrapper
takes its plain version.

Checked: the float32 arm is bitwise a hand-written loop of
``fused_train_epoch_plain`` over the same permutations; both arms receive
the same permutations; the bf16 arm's losses differ from the float32
arm's at every epoch (a rounding silently not applied would read 0); the
epoch counter advances by one per epoch; and nothing happens between the
epochs: each epoch starts from the previous epoch's outputs, the first
from the generating parameters and zero moments. The data are
bench.py's layout (``make_problem``): no mask plane, error 0 exactly on
the masked pixels, a zq column of weight 1.

The 1e-5 limit is not held here. It belongs to JAX's configuration of
65,536 SDSS spectra at batch 4096 (1913 pixels), which the card runs in
phase 22. On this narrow grid (255 pixels, 1024 spectra in 16 batches)
the mode itself reads 8e-6 to 3.9e-5 at epoch 55 with three seeds, and
the float32 arm on another shuffle up to 3.0e-5.
"""

import pytest
import torch

import chip_smoke
from qfa_tpu_torch.data.grid import make_grid
from qfa_tpu_torch.models.params import PARAM_NAMES
from qfa_tpu_torch.ops.epoch_kernel import (
    fused_train_epoch,
    fused_train_epoch_plain,
)
from qfa_tpu_torch.train import TrainConfig, adam

GRID = make_grid(1030.0, 1600.0, 7.5e-4)  # 255 pixels
N, BATCH, TILE, EPOCHS = 1024, 64, 8, 3  # 16 batches per epoch
SEED, PERM_SEED = 5, 6


@pytest.fixture(scope="module")
def run():
    """The protocol once, each epoch call recorded: its arm, counter,
    permutation, inputs and outputs."""
    calls = []

    def engine(params, m, v, *args, **kw):
        out = fused_train_epoch(params, m, v, *args, **kw)
        calls.append(dict(mxu=kw["mxu_bf16"], epoch=kw["epoch"],
                          perm=args[3].clone(), inputs=(params, m, v),
                          outputs=(out.params, out.m, out.v)))
        return out

    r = chip_smoke.bf16_drift(torch.device("cpu"), N, BATCH, TILE, EPOCHS,
                              SEED, PERM_SEED, grid=GRID, engine=engine)
    return r, calls


def arm_calls(calls, mxu):
    return [c for c in calls if c["mxu"] is mxu]


def equal(a, b):
    return all(torch.equal(getattr(a, k).detach(), getattr(b, k).detach())
               for k in PARAM_NAMES)


def test_problem_is_bench_layout(run):
    r, _ = run
    params, mu, data, loglam = r["problem"]
    assert params.F.shape == (GRID.npix, chip_smoke.NH)
    assert torch.equal(mu, torch.ones(GRID.npix))
    assert data.mask is None and data.size == N
    assert data.zabs.shape == (N, 2) and torch.equal(data.zabs[:, 1],
                                                     torch.ones(N))
    masked = data.error == 0
    # one contiguous chunk of int(0.1 * npix) pixels per spectrum
    assert torch.equal(masked.sum(dim=1),
                       torch.full((N,), int(0.1 * GRID.npix)))
    assert torch.equal(data.delta[masked], torch.zeros(int(masked.sum())))
    assert loglam.shape == (GRID.npix,)


def test_f32_arm_is_a_loop_of_the_plain_epoch(run):
    r, _ = run
    params, _, data, loglam = r["problem"]
    cfg = TrainConfig(batch_size=BATCH)
    st = adam.init(params)
    p, m, v = params, st.m, st.v
    losses = []
    for e, perm in enumerate(r["perms"]):
        out = fused_train_epoch_plain(
            p, m, v, data.delta, data.error, data.zabs, perm, None,
            epoch=e, n_batches=N // BATCH, loglam=loglam, derive_zabs=True,
            tile_batch=TILE, learning_rate=cfg.learning_rate,
            weight_decay=cfg.weight_decay, decay_alpha=cfg.decay_alpha,
            decay_step=cfg.decay_step, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
            bounds=cfg.bounds, reference_norm=cfg.reference_norm,
            mxu_bf16=False)
        p, m, v = out.params, out.m, out.v
        losses.append(float((out.loss_sums / out.n_real.clamp(min=1.0))
                            .sum() / (N // BATCH)))
    assert r["f32"]["losses"] == losses
    assert equal(r["f32"]["params"], p) and equal(r["f32"]["m"], m) \
        and equal(r["f32"]["v"], v)


def test_arms_take_the_same_permutations(run):
    r, calls = run
    assert len(r["perms"]) == EPOCHS
    for mxu in (True, False):
        got = [c["perm"] for c in arm_calls(calls, mxu)]
        assert len(got) == EPOCHS
        assert all(torch.equal(a, b) for a, b in zip(got, r["perms"]))
    # a new permutation every epoch, over every tile
    assert not torch.equal(r["perms"][0], r["perms"][1])
    assert torch.equal(r["perms"][0].sort().values, torch.arange(N // TILE))


def test_bf16_arm_drifts(run):
    r, calls = run
    assert len(r["drift"]) == EPOCHS
    assert all(d > 0 for d in r["drift"]), r["drift"]
    assert [c["mxu"] for c in calls] == [True] * EPOCHS + [False] * EPOCHS


def test_epoch_counter_advances(run):
    _, calls = run
    for mxu in (True, False):
        assert [c["epoch"] for c in arm_calls(calls, mxu)] == list(
            range(EPOCHS))


def test_no_smoothing_between_epochs(run):
    r, calls = run
    params = r["problem"][0]
    zero = adam.init(params)
    for mxu, arm in ((True, r["bf16"]), (False, r["f32"])):
        own = arm_calls(calls, mxu)
        p, m, v = own[0]["inputs"]
        assert equal(p, params) and equal(m, zero.m) and equal(v, zero.v)
        for before, after in zip(own, own[1:]):
            assert all(equal(a, b) for a, b in zip(after["inputs"],
                                                  before["outputs"]))
        assert equal(arm["params"], own[-1]["outputs"][0])
