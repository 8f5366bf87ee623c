"""``fit_fused``'s lookahead (``train.fused_engine``): on one device the
next chunk's shuffle and launch come before this chunk's read-back, and
the run's outputs stay bitwise those of the epochs chained by hand:
params, moments, loss history, held-out losses and checkpoint files,
through a rollback, a negative-loss stop, a metrics callback that raises
and a next chunk whose shuffle or launch raises; with a mesh each chunk
is read back before the next is drawn."""

from __future__ import annotations

import contextlib
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

import qfa_tpu_torch.parallel as parallel
from qfa_tpu_torch.data.loader import ResidualDataset
from qfa_tpu_torch.models.params import random_init, smooth_params
from qfa_tpu_torch.ops.epoch_kernel import fused_train_epoch_plain
from qfa_tpu_torch.parallel import make_mesh
from qfa_tpu_torch.train import (
    SeededShuffler,
    _run,
    TrainConfig,
    TrainState,
    adam,
    fit_fused,
    fused_engine,
)
from qfa_tpu_torch.train.loop import make_ckpt_saver, make_val_fn

NPIX, NB, NH, N, BATCH = 30, 10, 2, 40, 8
MU = np.ones(NPIX, np.float32)


def data():
    rng = np.random.default_rng(0)
    x = (0.1 * rng.normal(size=(N, NPIX))).astype(np.float32)
    err = rng.uniform(0.05, 0.2, (N, NPIX)).astype(np.float32)
    zabs = rng.uniform(2.0, 3.0, (N, NB)).astype(np.float32)
    return ResidualDataset(*(torch.tensor(a) for a in (
        x, err, zabs, np.ones((N, NPIX), np.float32))))


def params():
    return random_init(NPIX, NB, NH,
                       generator=torch.Generator().manual_seed(1))


def config(n_epochs, **kw):
    return TrainConfig(n_epochs=n_epochs, batch_size=BATCH,
                       learning_rate=1e-2, smooth_interval=5,
                       save_interval=5, **kw)


def faulty(monkeypatch, fault):
    """The plain engine with ``fault(epoch, loss_sums)`` applied to the
    loss sums it returns; records the epochs launched."""
    launched = []

    def engine(*args, **kw):
        launched.append(kw["epoch"])
        out = fused_train_epoch_plain(*args, **kw)
        return out._replace(loss_sums=fault(kw["epoch"], out.loss_sums))

    monkeypatch.setattr(fused_engine, "fused_train_epoch_plain", engine)
    return launched


def by_hand(cfg, out_dir, fault=lambda e, x: x, raise_at=None, val=None):
    """The epochs one ``fused_train_epoch_plain`` call each, the
    rollback, stop, smoothing and checkpoints done here: (state,
    history); with ``val`` (a held-out loss function, a list), the
    held-out loss of each kept epoch's state appended to the list."""
    d = data()
    tb = BATCH  # pick_tiling(8)
    shuffler = SeededShuffler(0)
    p = params()
    state = TrainState(p, adam.init(p))
    save = make_ckpt_saver(out_dir, MU, True)
    history = []
    for e in range(cfg.n_epochs):
        out = fused_train_epoch_plain(
            state.params, state.opt_state.m, state.opt_state.v, d.delta,
            d.error, d.zabs, shuffler.tiles(e, N // tb)[None], d.mask,
            epoch=e, n_batches=N // BATCH, n_epochs=1, tile_batch=tb,
            learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
            decay_alpha=cfg.decay_alpha, decay_step=cfg.decay_step,
            b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, bounds=cfg.bounds,
            tau_which=cfg.options.tau_which,
            reference_norm=cfg.reference_norm, mxu_bf16=cfg.mxu_bf16,
            bwd_wide=cfg.bwd_wide)
        sums = fault(e, out.loss_sums).reshape(1, -1)
        means = sums / torch.clamp(out.n_real.reshape(1, -1), min=1.0)
        loss = float((means.sum(dim=1) / max(N // BATCH, 1))[0])
        history.append(loss)
        if np.isfinite(loss):
            state = TrainState(out.params,
                               adam.AdamState(out.m, out.v, e + 1))
            if val is not None:
                val[1].append(val[0](state.params))
        else:
            state = TrainState(state.params, adam.AdamState(
                state.opt_state.m, state.opt_state.v, e + 1))
        if e == raise_at:
            break
        stop = loss < 0.0
        if stop or (e + 1) % 5 == 0:
            state.params = smooth_params(state.params)
            save(state, e + 1)
        if stop:
            break
    return state, history


def assert_same_run(got, want, got_dir, want_dir):
    (p, h), (state, g) = got, want
    np.testing.assert_array_equal(h, g)
    for k, x in state.params.as_dict().items():
        assert torch.equal(getattr(p, k).detach(), x.detach()), k
    return assert_same_files(got_dir, want_dir)


def assert_same_files(got_dir, want_dir):
    """Both runs wrote the same checkpoint files, array for array."""
    files = sorted(os.listdir(os.path.join(want_dir, "checkpoints")))
    assert sorted(os.listdir(os.path.join(got_dir, "checkpoints"))) == files
    for name in files:
        with np.load(os.path.join(got_dir, "checkpoints", name)) as a, \
                np.load(os.path.join(want_dir, "checkpoints", name)) as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in b.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=name + k)
    return files


def counts():
    return fused_engine.AHEAD, fused_engine.DISCARDED


def run(tmp_path, cfg, name="run", **kw):
    before = counts()
    out = fit_fused(params(), data(), MU, cfg,
                    output_dir=str(tmp_path / name), plain=True, **kw)
    return out, tuple(a - b for a, b in zip(counts(), before))


def test_twelve_epochs_are_bitwise_the_epochs_chained_by_hand(tmp_path):
    cfg = config(12)
    got, (ahead, dropped) = run(tmp_path, cfg)
    want = by_hand(cfg, str(tmp_path / "hand"))
    assert all(x > 0 for x in want[1])  # no stop
    files = assert_same_run(got, want, str(tmp_path / "run"),
                            str(tmp_path / "hand"))
    assert files == [f"{k}_epoch_{e:02d}.npz" for k in
                     ("model_parameters", "state") for e in (5, 10)]
    assert (ahead, dropped) == (11, 0)


def test_a_rejected_epoch_drops_the_epoch_launched_after_it(tmp_path,
                                                            monkeypatch):
    """Epoch 4 (checkpoint 5) reads NaN: epoch 5, launched from its
    smoothed state, is dropped and launched again from the restored,
    smoothed state; checkpoint 5 holds that state."""
    def fault(e, x):
        return x * float("nan") if e == 4 else x

    launched = faulty(monkeypatch, fault)
    cfg = config(8)
    got, (ahead, dropped) = run(tmp_path, cfg)
    assert launched == [0, 1, 2, 3, 4, 5, 5, 6, 7]
    assert (ahead, dropped) == (7, 1)
    want = by_hand(cfg, str(tmp_path / "hand"), fault)
    assert np.isnan(want[1][4])
    assert_same_run(got, want, str(tmp_path / "run"), str(tmp_path / "hand"))


def test_a_negative_loss_stops_with_the_epoch_launched_after_it_dropped(
        tmp_path, monkeypatch):
    def fault(e, x):
        return -x.abs() if e == 6 else x

    launched = faulty(monkeypatch, fault)
    cfg = config(12)
    got, (ahead, dropped) = run(tmp_path, cfg)
    assert launched == list(range(8))
    assert (ahead, dropped) == (7, 1)
    want = by_hand(cfg, str(tmp_path / "hand"), fault)
    assert len(want[1]) == 7
    files = assert_same_run(got, want, str(tmp_path / "run"),
                            str(tmp_path / "hand"))
    assert "state_epoch_07.npz" in files


class Closed(Exception):
    pass


@pytest.mark.parametrize("raise_at", [9, 10])
def test_a_raising_callback_leaves_every_reported_checkpoint_whole(
        tmp_path, raise_at):
    """The callback of epoch ``raise_at`` raises (as the benchmark's
    window closes): checkpoint 10 follows epoch 9's report, so it is on
    disk, whole, when epoch 10's callback raises and absent when epoch
    9's does."""
    seen = []

    def cb(epoch, loss, dt):
        seen.append(epoch)
        if epoch == raise_at:
            raise Closed

    cfg = config(20)
    with pytest.raises(Closed):
        run(tmp_path, cfg, metrics_cb=cb)
    assert seen == list(range(raise_at + 1))
    by_hand(cfg, str(tmp_path / "hand"), raise_at=raise_at)
    files = assert_same_files(str(tmp_path / "run"), str(tmp_path / "hand"))
    assert ("state_epoch_10.npz" in files) == (raise_at == 10)


class Failing(SeededShuffler):
    """Tile permutations that raise at epoch 5."""

    def tiles(self, epoch, n_tiles):
        if epoch == 5:
            raise Closed
        return super().tiles(epoch, n_tiles)


@pytest.mark.parametrize("where", ["shuffle", "launch"])
def test_a_failing_next_chunk_is_raised_once_this_chunk_is_saved(
        tmp_path, monkeypatch, where):
    """Epoch 5's shuffle or launch, enqueued before epoch 4 is read back,
    raises: epoch 4 is still read, reported and smoothed, checkpoint 5
    written whole, and then the error raised."""
    shuffler = None
    if where == "shuffle":
        shuffler = Failing(0)
    else:
        def fault(e, x):
            if e == 5:
                raise Closed
            return x

        faulty(monkeypatch, fault)
    seen = []
    with pytest.raises(Closed):
        run(tmp_path, config(12), shuffler=shuffler,
            metrics_cb=lambda e, loss, dt: seen.append(loss))
    _, want = by_hand(config(5), str(tmp_path / "hand"))
    assert seen == want
    files = assert_same_files(str(tmp_path / "run"), str(tmp_path / "hand"))
    assert files == ["model_parameters_epoch_05.npz", "state_epoch_05.npz"]


def test_a_held_out_set_is_taken_on_each_chunks_own_state(tmp_path,
                                                          monkeypatch):
    """With ``val_data`` the loop still looks ahead, and each held-out
    loss is that of the chunk's state before its smoothing, as when the
    next chunk launched only after it."""
    got_val = []

    def make_recording_val_fn(*args):
        fn = make_val_fn(*args)
        return lambda p: got_val.append(fn(p)) or got_val[-1]

    monkeypatch.setattr(_run, "make_val_fn", make_recording_val_fn)
    cfg = config(12)
    got, (ahead, dropped) = run(tmp_path, cfg, val_data=data())
    want_val: list = []
    want = by_hand(cfg, str(tmp_path / "hand"),
                   val=(make_val_fn(data(), cfg.options), want_val))
    assert len(want_val) == 12 and len(set(want_val)) == 12
    assert got_val == want_val
    assert_same_run(got, want, str(tmp_path / "run"), str(tmp_path / "hand"))
    assert (ahead, dropped) == (11, 0)


def recorder(monkeypatch):
    """Record the loop's host phases and the epochs launched, by the
    spans ``fit_fused`` opens and its plain engine's calls."""
    log = []

    def span(name):
        log.append(name.rsplit(".", 1)[-1])
        return contextlib.nullcontext()

    def engine(*args, **kw):
        log.append(f"launch {kw['epoch']}")
        return fused_train_epoch_plain(*args, **kw)

    monkeypatch.setattr(fused_engine, "span", span)
    monkeypatch.setattr(fused_engine, "fused_train_epoch_plain", engine)
    return log


READ = ["readback", "check", "report"]


@pytest.mark.parametrize("val", [False, True], ids=["train", "held_out"])
def test_the_next_epoch_is_shuffled_and_launched_before_the_read_back(
        monkeypatch, val):
    log = recorder(monkeypatch)
    fit_fused(params(), data(), MU, config(3), plain=True,
              val_data=data() if val else None)
    assert log == ["fit_fused", "shuffle", "launch 0", "shuffle", "launch 1",
                   *READ, "shuffle", "launch 2", *READ, *READ]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def mesh():
    """A one-rank gloo group in this process, and its CPU mesh."""
    dist.init_process_group("gloo", rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{_free_port()}")
    yield make_mesh(1, device="cpu")
    dist.destroy_process_group()


def test_a_mesh_keeps_the_order_without_lookahead(monkeypatch, mesh):
    log = recorder(monkeypatch)
    make = parallel.make_epoch_dp_fn

    def make_epoch_dp_fn(*args, **kw):
        fn = make(*args, **kw)

        def epoch_fn(state, data, perms):
            log.append(f"launch {state.opt_state.epoch}")
            return fn(state, data, perms)

        return epoch_fn

    monkeypatch.setattr(parallel, "make_epoch_dp_fn", make_epoch_dp_fn)
    before = counts()
    fit_fused(params(), data(), MU, config(3), plain=True, mesh=mesh)
    assert log == ["fit_fused", "shard"] + sum(
        (["shuffle", f"launch {e}", *READ] for e in range(3)), [])
    assert counts() == before
