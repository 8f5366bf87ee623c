"""The exact-DP windows kept across epochs (``ops.epoch_kernel.WindowCalls``
and ``parallel.sync_dp``'s kernel engines), on the CUDA epoch kernel's own
source compiled for the CPU by g++ (``qfa_tpu_torch.tools.emulate``).

On the card, ``sync_dp`` over NCCL captures an epoch's window calls, their
all-reduces and the flush into one CUDA graph and replays it every epoch:
the launches read their schedule from a device row that ``set_epoch``
rewrites, and the state, permutation and windows' vectors stay in buffers
set up once. A CPU has no graph, but the calls that the graph holds are
the ones checked here, issued from Python on the same kept buffers. All
bitwise:

* one ``WindowCalls`` over three epochs (0, 1 and 2 with ``decay_step``
  3, so the third crosses a decay boundary), at K 1 and at K 3 with a
  remainder window, equals a fresh ``WindowCalls`` per epoch and the
  wrapper's window calls; the arrival counters are zero after every call;
* ``sync_dp``'s kept-buffer engine over three epochs and a reshuffled
  dataset equals the windows as they ran before the buffers were kept (a
  fresh ``WindowCalls`` per epoch), and the state one epoch returns is
  unchanged by the next (``fit_fused``'s rollback anchor);
* the engine choice: a graph only on NCCL with CUDA planes, the eager loop
  on gloo, one call per window on the CPU; the epoch function goes when
  the caller drops it (its graph holds NCCL's captured collectives, which
  ``destroy_process_group`` would wait for).
"""

import socket
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist

from qfa_tpu_torch.data.loader import ResidualDataset
from qfa_tpu_torch.models.params import PARAM_NAMES, ParamBounds, QFAParams
from qfa_tpu_torch.ops import epoch_kernel
from qfa_tpu_torch.ops.common import loglam_row, tau_law_abc, zq_column
from qfa_tpu_torch.parallel import make_mesh, make_sync_dp_epoch_fn, sync_dp
from qfa_tpu_torch.parallel._common import epoch_loss
from qfa_tpu_torch.tools import emulate
from qfa_tpu_torch.train import TrainConfig, TrainState, adam

NPIX, NB, NH, N, TB, TPB = 130, 60, 3, 64, 8, 2
N_BATCHES = N // (TB * TPB)
HYPER = dict(learning_rate=1e-2, weight_decay=0.01, decay_alpha=0.5,
             decay_step=3, b1=0.9, b2=0.999, eps=1e-8, reference_norm=True,
             mxu_bf16=True)
EPOCHS = (0, 1, 2)  # (e + 1) // 3: the third epoch's rate is decayed


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = emulate.load(emulate.build(tmp_path_factory.mktemp("emu"), (NH,)))
    before = epoch_kernel.LAUNCHES, epoch_kernel.WINDOW_LAUNCHES
    with emulate.installed(lib):
        yield lib
    # these calls went through the CUDA wrapper on CPU tensors
    epoch_kernel.LAUNCHES, epoch_kernel.WINDOW_LAUNCHES = before


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo group in this process, and its CPU mesh."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{port}")
    yield make_mesh(1, device="cpu")
    dist.destroy_process_group()


def problem(seed):
    """Seeded parameters and N spectra in the derived layout (10 % of
    pixels masked, row 3 fully masked)."""
    g = np.random.default_rng(seed)
    f32 = np.float32
    params = QFAParams(
        F=torch.tensor(g.uniform(-0.5, 0.5, (NPIX, NH)).astype(f32)),
        Psi=torch.tensor(g.uniform(0.3, 0.6, NPIX).astype(f32)),
        omega=torch.tensor(g.uniform(0.3, 0.8, NB).astype(f32)),
        tau0=torch.tensor(0.12), c0=torch.tensor(0.2),
        beta=torch.tensor(2.4))
    mask = (g.uniform(size=(N, NPIX)) > 0.1).astype(f32)
    mask[3] = 0.0
    err = g.uniform(0.05, 0.15, (N, NPIX)).astype(f32) * mask
    delta = (0.3 * g.normal(size=(N, NPIX))).astype(f32) * mask
    zq = g.uniform(2.0, 3.5, N).astype(f32)
    lam = np.exp(np.log(1030.0) + 1e-3 * np.arange(NPIX))
    data = ResidualDataset(delta=torch.tensor(delta),
                           error=torch.tensor(err),
                           zabs=zq_column(torch.tensor(zq)), mask=None)
    return params, data, loglam_row(lam)


def perms(seed, n=len(EPOCHS)):
    g = np.random.default_rng(seed)
    return [torch.tensor(g.permutation(N // TB)) for _ in range(n)]


def leaves(state):
    """params, m, v of a (params, m, v) triple as one list of tensors."""
    return [getattr(t, k).detach() for t in state for k in PARAM_NAMES]


def assert_same(a, b, what):
    for i, (x, y) in enumerate(zip(leaves(a), leaves(b))):
        assert torch.equal(x, y), (what, i)


def wrapper_epoch(state, data, loglam, perm, epoch, K):
    """The epoch in ``fused_train_epoch``'s window calls (the CUDA
    wrapper, ``_launch``): (params, m, v), loss rows."""
    p, m, v = state
    pend, losses = None, []
    common = dict(derive_zabs=True, bounds=ParamBounds(),
                  law=tau_law_abc("becker"), n_epochs=1, epoch=epoch,
                  **HYPER)
    for lo in range(0, N_BATCHES, K):
        k = min(K, N_BATCHES - lo)
        sl = perm[lo * TPB:(lo + k) * TPB]
        geo = epoch_kernel._check_args(
            p, m, v, data.delta, data.error, data.zabs, sl, None, loglam,
            True, k, 1, TB, True, pend, int(pend is not None), TPB)
        out = epoch_kernel._launch(p, m, v, data.delta, data.error,
                                   data.zabs, None, loglam, geo, n_batches=k,
                                   pending=pend, **common)
        p, m, v, pend = out.params, out.m, out.v, out.pending
        losses.append(out.loss_sums)
    geo = epoch_kernel._check_args(
        p, m, v, data.delta, data.error, data.zabs, perm[:0], None, loglam,
        True, 0, 1, TB, True, pend, 1, TPB)
    out = epoch_kernel._launch(p, m, v, data.delta, data.error, data.zabs,
                               None, loglam, geo, n_batches=0, pending=pend,
                               **common)
    return (out.params, out.m, out.v), torch.cat(losses)


def fresh_epoch(state, data, loglam, perm, epoch, K, mesh=None):
    """The epoch as ``sync_dp`` ran it on the card before its buffers were
    kept: a new WindowCalls, each window's vector new, summed over the
    mesh if given: (params, m, v), loss rows, n_real."""
    run = epoch_kernel.WindowCalls(*state, data.delta, data.error, data.zabs,
                                   epoch=epoch, tiles_per_batch=TPB,
                                   tile_batch=TB, loglam=loglam,
                                   derive_zabs=True, **HYPER)
    n_p, perm32 = run.pending_len, perm.to(torch.int32)
    pend, losses, reals = None, [], []
    for lo in range(0, N_BATCHES, K):
        k = min(K, N_BATCHES - lo)
        vec = run.window(perm32[lo * TPB:(lo + k) * TPB], k, pend)
        if mesh is not None:
            mesh.all_reduce(vec)
        pend = vec[:n_p]
        losses.append(vec[n_p:n_p + k])
        reals.append(vec[n_p + k:n_p + 2 * k])
    run.flush(pend)
    return run.outputs(), torch.cat(losses), torch.cat(reals)


@pytest.mark.parametrize("K", [1, 3])
def test_kept_window_calls_over_three_epochs_bitwise(emulated, K):
    """One WindowCalls for three epochs, its permutation, schedule row and
    state rewritten before each and the windows' vectors one buffer,
    against a fresh WindowCalls per epoch and the wrapper's windows: every
    loss row and the state after each epoch bitwise; the arrival counters
    zero after every call."""
    params, data, loglam = problem(21)
    st = adam.init(params)
    ps = perms(22)
    start = (params, st.m, st.v)
    run = epoch_kernel.WindowCalls(params, st.m, st.v, data.delta,
                                   data.error, data.zabs, epoch=EPOCHS[0],
                                   tiles_per_batch=TPB, tile_batch=TB,
                                   loglam=loglam, derive_zabs=True, **HYPER)
    n_p = run.pending_len
    windows = [(lo, min(K, N_BATCHES - lo)) for lo in range(0, N_BATCHES, K)]
    stride = -(-(n_p + 2 * K) // 4) * 4
    buf = torch.full((len(windows) * stride,), float("nan"))
    kept = wrapped = fresh = start
    starts = []
    before = epoch_kernel.LAUNCHES, epoch_kernel.WINDOW_LAUNCHES
    for e, perm in zip(EPOCHS, ps):
        starts.append(kept)
        run.set_perm(perm)
        run.set_epoch(e)
        run.load(*kept)
        assert torch.equal(run._k.sched_dev, torch.from_numpy(
            epoch_kernel._schedule_rows(e, 1, 1e-2, 0.5, 3, 0.9, 0.999)[0]))
        pend, got = None, []
        for w, (lo, k) in enumerate(windows):
            vec = run.window(run.perm[lo * TPB:(lo + k) * TPB], k, pend,
                             out=buf[w * stride:w * stride + n_p + 2 * k])
            assert int(run._k.counters.abs().sum()) == 0
            pend = vec[:n_p]
            got.append(vec[n_p:n_p + k])
        run.flush(pend)
        assert int(run._k.counters.abs().sum()) == 0
        kept = run.snapshot()
        wrapped, want = wrapper_epoch(wrapped, data, loglam, perm, e, K)
        fresh, want2, _ = fresh_epoch(fresh, data, loglam, perm, e, K)
        assert torch.equal(torch.cat(got), want), e
        assert torch.equal(want2, want), e
        assert_same(kept, wrapped, ("wrapper", e))
        assert_same(kept, fresh, ("fresh", e))
    calls = len(EPOCHS) * (len(windows) + 1)
    assert (epoch_kernel.LAUNCHES - before[0],
            epoch_kernel.WINDOW_LAUNCHES - before[1]) == (calls * 3, calls * 3)
    # a schedule row left at the second epoch's would show: the last
    # epoch from its start state at counter 1 gives other bits
    stale = fresh_epoch(starts[-1], data, loglam, ps[-1], EPOCHS[1], K)[0]
    assert not torch.equal(stale[0].F, kept[0].F)


def test_sync_dp_kept_windows_equal_fresh_windows_bitwise(emulated, mesh,
                                                           monkeypatch):
    """sync_dp's kernel engine on kept buffers (the calls its CUDA graph
    holds, issued eagerly here) over three chained epochs and then a
    reshuffled dataset, against a fresh WindowCalls per epoch: state and
    loss bitwise; the state an epoch returned stays as it was through the
    next epochs."""
    monkeypatch.setattr(sync_dp, "window_engine", lambda *a: "eager")
    params, data, loglam = problem(31)
    st = adam.init(params)
    cfg = TrainConfig(batch_size=TB * TPB, n_epochs=len(EPOCHS) + 1,
                      **{k: HYPER[k] for k in ("learning_rate",
                                               "weight_decay", "decay_alpha",
                                               "decay_step", "b1", "b2",
                                               "eps", "reference_norm",
                                               "mxu_bf16")})
    ps = perms(32, len(EPOCHS) + 1)
    rows = torch.tensor(np.random.default_rng(33).permutation(N))
    shuffled = ResidualDataset(delta=data.delta[rows].contiguous(),
                               error=data.error[rows].contiguous(),
                               zabs=data.zabs[rows].contiguous(), mask=None)
    for K in (1, 3):
        fn = make_sync_dp_epoch_fn(cfg, mesh, batches_per_launch=K,
                                   tile_batch=TB, loglam=loglam)
        state = TrainState(params, st)
        ref = (params, st.m, st.v)
        anchors = []
        for e, perm in enumerate(ps):
            d = data if e < len(EPOCHS) else shuffled
            state, loss = fn(state, d, perm)
            assert fn.engine == "eager"
            ref, losses, reals = fresh_epoch(ref, d, loglam, perm, e, K,
                                             mesh)
            got = (state.params, state.opt_state.m, state.opt_state.v)
            assert_same(got, ref, (K, e))
            assert torch.equal(loss, epoch_loss(losses, reals, N, TB * TPB))
            assert state.opt_state.epoch == e + 1
            anchors.append((got, [x.clone() for x in leaves(got)]))
            for was, copy in anchors:  # no epoch wrote into an older state
                assert all(torch.equal(x, y) for x, y in
                           zip(leaves(was), copy)), (K, e)


def test_window_engine_choice(mesh, monkeypatch):
    """A CUDA graph only on NCCL with CUDA planes; the eager loop on any
    other backend with CUDA planes (gloo's collectives cannot be
    captured); one call per window on the CPU and with plain=True."""
    assert sync_dp.window_engine("nccl", "cuda", False) == "graph"
    assert sync_dp.window_engine("gloo", "cuda", False) == "eager"
    assert sync_dp.window_engine("gloo", "cpu", False) == "calls"
    assert sync_dp.window_engine("nccl", "cuda", True) == "calls"
    assert sync_dp.window_engine("nccl", "cpu", False) == "calls"
    assert mesh.backend == "gloo"
    params, data, loglam = problem(41)
    st = adam.init(params)
    fn = make_sync_dp_epoch_fn(TrainConfig(batch_size=TB * TPB), mesh,
                               tile_batch=TB, loglam=loglam)
    assert fn.engine is None
    seen = []
    real = sync_dp.window_engine
    monkeypatch.setattr(sync_dp, "window_engine",
                        lambda *a: seen.append(a) or real(*a))
    fn(TrainState(params, st), data, perms(42, 1)[0])
    assert seen == [("gloo", "cpu", False)] and fn.engine == "calls"
    # no reference cycle keeps the function, and on the card its graph of
    # NCCL collectives, alive once the caller drops it
    gone = weakref.ref(fn)
    del fn
    assert gone() is None
