"""The port's data-parallel engines (``qfa_tpu_torch.parallel``) at world
size 1, in this process over gloo, against the JAX package's engines on a
one-device mesh (``make_mesh(1)``, the Pallas kernels in interpret mode)
and against the port's own single-device paths.

The problem of ``tests/test_sync_dp.py``: grid 1030-1080 A, 128 spectra,
Nh 4, tile 8, batch 32. The JAX engines draw their permutations from
``jax.random`` (``fold_in(key, device)``); the port is handed the same
ones. Tolerances, and why:

* against JAX: loss rtol 1e-5, params rtol 5e-4 atol 1e-5 (the bound of
  ``tests/test_torch_train.py`` between the packages after several
  updates: float32 sums in different orders through Adam);
* against the port's own single-device epoch at one rank: bitwise (the
  window's pending buffer summed over one rank is the batch's own, and
  goes through the same update);
* ``fused_predict_dp`` against ``fused_predict``: bitwise (at one rank
  the rank's share is the whole batch, the same call; at more ranks on
  CUDA a rank's float32 share may be too small for the body the whole
  batch takes, ``ops.infer_kernel.TC_MIN_ROWS``, and differ from it in
  the last bits).
"""

import glob
import json
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import qfa_tpu
from qfa_tpu.data.loader import ResidualDataset as JaxResidualDataset
from qfa_tpu.data.synthetic import generate
from qfa_tpu.models import random_init as jax_random_init
from qfa_tpu.parallel import make_dp_epoch_fn as jax_make_dp_epoch_fn
from qfa_tpu.parallel import make_epoch_dp_fn as jax_make_epoch_dp_fn
from qfa_tpu.parallel import make_mesh as jax_make_mesh
from qfa_tpu.parallel import make_sync_dp_epoch_fn as jax_make_sync_dp_fn
from qfa_tpu.parallel import shard_dataset as jax_shard_dataset
from qfa_tpu.parallel import shard_epoch_indices as jax_shard_epoch_indices
from qfa_tpu.train import TrainConfig as JaxTrainConfig
from qfa_tpu.train import TrainState as JaxTrainState
from qfa_tpu.train import adam as jax_adam
from qfa_tpu_torch.data.loader import EpochIndices, ResidualDataset
from qfa_tpu_torch.models.params import PARAM_NAMES, QFAParams
from qfa_tpu_torch.ops import epoch_kernel
from qfa_tpu_torch.ops.infer_kernel import fused_predict
from qfa_tpu_torch.parallel import (
    fused_predict_dp,
    make_dp_epoch_fn,
    make_epoch_dp_fn,
    make_mesh,
    make_sync_dp_epoch_fn,
    replicated,
    shard_dataset,
    shard_epoch_indices,
)
from qfa_tpu_torch.parallel import epoch_dp
from qfa_tpu_torch.parallel import mesh as port_mesh
from qfa_tpu_torch.train import TrainConfig, TrainState, adam, fit_fused

N, NH, TB, BATCH = 128, 4, 8, 32
CFG = dict(batch_size=BATCH, learning_rate=1e-2, weight_decay=0.01)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo group in this process, and its CPU mesh."""
    dist.init_process_group("gloo", rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{_free_port()}")
    yield make_mesh(1, device="cpu")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def problem():
    grid = qfa_tpu.make_grid(1030.0, 1080.0, 1e-3)
    true = jax_random_init(jax.random.key(0), grid.npix, grid.nb, NH)
    mu = jnp.ones((grid.npix,), jnp.float32)
    syn = generate(jax.random.key(1), true, mu, grid, N, mask_frac=0.15)
    b = syn.to_batch(mu)
    data = {k: np.asarray(getattr(b, k), np.float32)
            for k in ("delta", "error", "zabs", "mask")}
    p0 = jax_random_init(jax.random.key(2), grid.npix, grid.nb, NH)
    return grid, data, {k: np.asarray(v) for k, v in p0.as_dict().items()}


def jax_state(p0):
    p = qfa_tpu.models.QFAParams(**{k: jnp.asarray(v) for k, v in p0.items()})
    return JaxTrainState(p, jax_adam.init(p))


def port_state(p0):
    p = QFAParams.from_numpy(p0)
    return TrainState(p, adam.init(p))


def jax_data(data):
    return JaxResidualDataset(**{k: jnp.asarray(v) for k, v in data.items()})


def port_data(data):
    return ResidualDataset(**{k: torch.tensor(v) for k, v in data.items()})


def dev_perm(key, dev, n):
    """The JAX engines' per-device permutation."""
    return np.asarray(jax.random.permutation(
        jax.random.fold_in(key, jnp.asarray(dev, jnp.uint32)), n))


def assert_params_close(port, ref, rtol=5e-4, atol=1e-5):
    for k in PARAM_NAMES:
        np.testing.assert_allclose(getattr(port, k).detach().numpy(),
                                   np.asarray(getattr(ref, k)), rtol=rtol,
                                   atol=atol, err_msg=k)


def assert_states_equal(a, b):
    for part in ("params", "m", "v"):
        for k in PARAM_NAMES:
            x = getattr(a.params if part == "params" else
                        getattr(a.opt_state, part), k)
            y = getattr(b.params if part == "params" else
                        getattr(b.opt_state, part), k)
            assert torch.equal(x.detach(), y.detach()), (part, k)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_sync_dp_matches_jax_and_the_plain_epoch(mesh, problem, k):
    """K batches per window (3: a remainder window): the epoch matches
    JAX's sync_dp on a one-device mesh, and equals the port's own plain
    epoch on the same permutation bit for bit."""
    grid, data, p0 = problem
    key = jax.random.key(7)
    jmesh = jax_make_mesh(1)
    ref_st, ref_loss = jax_make_sync_dp_fn(
        JaxTrainConfig(**CFG), jmesh, batches_per_launch=k, tile_batch=TB,
        interpret=True)(jax_state(p0), jax_shard_dataset(jax_data(data),
                                                         jmesh), key)
    perm = dev_perm(key, 0, N // TB)
    fn = make_sync_dp_epoch_fn(TrainConfig(**CFG), mesh,
                               batches_per_launch=k, tile_batch=TB)
    st, loss = fn(port_state(p0), shard_dataset(port_data(data), mesh),
                  torch.tensor(perm))
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    assert_params_close(st.params, ref_st.params)
    assert st.opt_state.epoch == 1
    # the port's plain epoch on the same permutation
    s0 = port_state(p0)
    d = port_data(data)
    out = epoch_kernel.fused_train_epoch(
        s0.params, s0.opt_state.m, s0.opt_state.v, d.delta, d.error, d.zabs,
        torch.tensor(perm), d.mask, epoch=0, n_batches=N // BATCH,
        tile_batch=TB, **{k_: v for k_, v in CFG.items()
                          if k_ != "batch_size"})
    plain = TrainState(out.params, adam.AdamState(out.m, out.v, 1))
    assert_states_equal(st, plain)
    plain_loss = float((out.loss_sums / out.n_real.clamp(min=1)).sum()
                       / (N // BATCH))
    assert float(loss) == pytest.approx(plain_loss, rel=1e-7)


@pytest.mark.parametrize("epl", [1, 2])
def test_epoch_dp_matches_jax(mesh, problem, epl):
    """Local SGD with per-call averaging, one epoch per call and a chunk
    of two (the JAX chunk derives epoch e's permutation from
    fold_in(fold_in(base, e), device))."""
    grid, data, p0 = problem
    key = jax.random.key(5)
    jmesh = jax_make_mesh(1)
    ref_st, ref_loss = jax_make_epoch_dp_fn(
        JaxTrainConfig(**CFG), jmesh, tile_batch=TB, epochs_per_launch=epl,
        interpret=True)(jax_state(p0), jax_shard_dataset(jax_data(data),
                                                         jmesh), key)
    if epl == 1:
        perm = dev_perm(key, 0, N // TB)[None]
    else:
        perm = np.stack([dev_perm(jax.random.fold_in(key, e), 0, N // TB)
                         for e in range(epl)])
    calls, nbytes = epoch_dp.ALL_REDUCES, epoch_dp.REDUCED_BYTES
    st, loss = make_epoch_dp_fn(TrainConfig(**CFG), mesh, tile_batch=TB,
                                epochs_per_launch=epl)(
        port_state(p0), shard_dataset(port_data(data), mesh),
        torch.tensor(perm))
    np.testing.assert_allclose(np.asarray(loss), np.asarray(ref_loss),
                               rtol=1e-5)
    assert_params_close(st.params, ref_st.params)
    assert st.opt_state.epoch == epl
    # one all-reduce per call, of the packed state (params and both
    # moments) and each epoch's loss sums and real rows per batch
    n_state = sum(v.size for v in p0.values())
    assert epoch_dp.ALL_REDUCES - calls == 1
    assert epoch_dp.REDUCED_BYTES - nbytes == 4 * (
        3 * n_state + 2 * epl * (N // BATCH))


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_dp_matches_jax(mesh, problem, engine):
    """Per-batch exact DP, both engines, on JAX's epoch indices; the
    port's shard_epoch_indices gives the same ones from the same
    permutation."""
    grid, data, p0 = problem
    key = jax.random.key(3)
    jmesh = jax_make_mesh(1)
    ei = jax_shard_epoch_indices(key, N, BATCH, jmesh)
    ref_st, ref_loss = jax_make_dp_epoch_fn(
        JaxTrainConfig(**CFG), jmesh, engine=engine, tile_batch=TB,
        interpret=True)(jax_state(p0), jax_shard_dataset(jax_data(data),
                                                         jmesh), ei)
    idx = np.asarray(ei.idx)[0]
    mine = shard_epoch_indices(None, N, BATCH, mesh, perm=idx.reshape(-1))
    np.testing.assert_array_equal(mine.idx.numpy(), idx)
    np.testing.assert_array_equal(mine.weight.numpy(),
                                  np.asarray(ei.weight)[0])
    st, loss = make_dp_epoch_fn(TrainConfig(**CFG), mesh, engine=engine,
                                tile_batch=TB)(
        port_state(p0), shard_dataset(port_data(data), mesh),
        EpochIndices(idx=mine.idx, weight=mine.weight))
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    assert_params_close(st.params, ref_st.params)
    assert st.opt_state.epoch == 1


def test_fused_predict_dp_matches_fused_predict(mesh, problem):
    grid, data, p0 = problem
    params = QFAParams.from_numpy(p0)
    mu = torch.ones(grid.npix)
    t = {k: torch.tensor(v) for k, v in data.items()}
    ref = fused_predict(params, mu, t["delta"], t["error"], t["zabs"],
                        t["mask"])
    got = fused_predict_dp(params, mu, data["delta"], data["error"],
                           data["zabs"], data["mask"], mesh=mesh,
                           tile_batch=TB)
    for f in ref._fields:
        if getattr(ref, f) is not None:
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
    with pytest.raises(ValueError, match="tile_batch"):
        fused_predict_dp(params, mu, data["delta"][:12], data["error"][:12],
                         data["zabs"][:12], data["mask"][:12], mesh=mesh,
                         tile_batch=TB)


def test_fit_fused_mesh_guards_and_world_size_one(mesh, problem):
    """fit_fused(mesh=) at one rank: local SGD and exact DP at K 1 and 3
    give the mesh-free run's history and parameters bit for bit (rank 0
    shuffles as one device does); its guards raise."""
    grid, data, p0 = problem
    cfg = TrainConfig(n_epochs=2, smooth_interval=2, save_interval=2, **CFG)
    ref_p, ref_h = fit_fused(QFAParams.from_numpy(p0), port_data(data), None,
                             cfg, seed=4, tile_batch=TB)
    for kw in (dict(), dict(dp_exact=True),
               dict(dp_exact=True, batches_per_launch=3)):
        p, h = fit_fused(QFAParams.from_numpy(p0), port_data(data), None,
                         cfg, seed=4, tile_batch=TB, mesh=mesh, **kw)
        assert h == ref_h, kw
        for k in PARAM_NAMES:
            assert torch.equal(getattr(p, k).detach(),
                               getattr(ref_p, k).detach()), (kw, k)
    with pytest.raises(ValueError, match="requires a mesh"):
        fit_fused(QFAParams.from_numpy(p0), port_data(data), None, cfg,
                  dp_exact=True)
    with pytest.raises(ValueError, match="epochs_per_launch"):
        fit_fused(QFAParams.from_numpy(p0), port_data(data), None, cfg,
                  mesh=mesh, dp_exact=True, epochs_per_launch=2)
    with pytest.raises(ValueError, match="reshuffle_interval"):
        fit_fused(QFAParams.from_numpy(p0), port_data(data), None, cfg,
                  mesh=mesh, reshuffle_interval=2)
    with pytest.raises(ValueError, match="not divisible"):
        fit_fused(QFAParams.from_numpy(p0), port_data(data), None,
                  TrainConfig(n_epochs=1, batch_size=30), mesh=mesh._replace(
                      size=4))


def test_mesh_spans_in_a_cpu_trace(mesh, problem, tmp_path):
    """A ``trace`` of ``fit_fused(mesh=)`` holds its shard step once and
    the local-SGD all-reduce once per epoch, as ``cpu_op`` events (no
    device row: a CPU trace has none, and a span is never an
    annotation)."""
    from qfa_tpu_torch.utils.profiling import trace

    grid, data, p0 = problem
    cfg = TrainConfig(n_epochs=3, smooth_interval=2, **CFG)
    with trace(str(tmp_path), device="cpu"):
        fit_fused(QFAParams.from_numpy(p0), port_data(data), None, cfg,
                  seed=4, tile_batch=TB, mesh=mesh)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("name", "") in ("qfa.fit_fused.shard",
                                          "qfa.epoch_dp.all_reduce")]
    names = [e["name"] for e in spans]
    assert names.count("qfa.fit_fused.shard") == 1
    assert names.count("qfa.epoch_dp.all_reduce") == 3
    assert {e["cat"] for e in spans} == {"cpu_op"}


def test_mesh_helpers(mesh, monkeypatch):
    """Row slices as JAX's data sharding gives device d; one broadcast
    replicates a state; initialize_distributed tolerates an initialized
    group and raises every other failure."""
    two = mesh._replace(rank=1, size=2)
    x = np.arange(12.0).reshape(6, 2)
    assert port_mesh.data_sharding(two, 6) == slice(3, 6)
    np.testing.assert_array_equal(port_mesh.shard_leaves({"a": x}, two)["a"],
                                  x[3:])
    with pytest.raises(ValueError, match="not divisible"):
        port_mesh.local_shard_size(5, two)
    with pytest.raises(ValueError, match="one process per device"):
        make_mesh(2, device="cpu")
    st = port_state({k: np.asarray(v) for k, v in QFAParams(
        torch.ones(3, 2), torch.ones(3), torch.ones(1), torch.tensor(1.0),
        torch.tensor(2.0), torch.tensor(3.0)).to_numpy().items()})
    rep = replicated(st, mesh)
    assert_states_equal(rep, st)
    port_mesh.initialize_distributed()  # already initialized: a no-op

    calls = []

    def already(**kw):
        calls.append(kw)
        raise RuntimeError("trying to initialize the default process group "
                           "twice: already initialized")

    monkeypatch.setattr(port_mesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(port_mesh.dist, "init_process_group", already)
    port_mesh.initialize_distributed(backend="gloo")  # swallowed
    assert calls

    def bad(**kw):
        raise RuntimeError("connection to the store failed")

    monkeypatch.setattr(port_mesh.dist, "init_process_group", bad)
    with pytest.raises(RuntimeError, match="store failed"):
        port_mesh.initialize_distributed(backend="gloo")
