"""The port's profiler spans (``qfa_tpu_torch.utils.profiling.span``): the
host phases of ``fit_fused``'s epoch loop, the epoch kernel's launch and
``fused_predict`` in a ``torch.profiler`` trace, in loop order, as
``cpu_op`` events (never a ``record_function`` annotation, which the
profiler mirrors onto the card's rows), leaving the outputs bitwise as
they are; with the profiler off, ``span`` is one shared no-op."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qfa_tpu_torch.data.loader import ResidualDataset
from qfa_tpu_torch.models.params import random_init
from qfa_tpu_torch.ops import _build, epoch_kernel, infer_kernel
from qfa_tpu_torch.ops.common import tau_law_abc
from qfa_tpu_torch.train import TrainConfig, fit_fused, fused_engine
from qfa_tpu_torch.utils import profiling
from qfa_tpu_torch.utils.profiling import span

NPIX, NB, NH, N = 30, 10, 2, 40
LAUNCH = ["qfa.fit_fused.shuffle", "qfa.epoch_kernel.launch"]
READ = ["qfa.fit_fused.readback", "qfa.fit_fused.check",
        "qfa.fit_fused.report"]
CHECKPOINT = ["qfa.fit_fused.smooth", "qfa.fit_fused.save"]


def planes():
    rng = np.random.default_rng(0)
    x = (0.1 * rng.normal(size=(N, NPIX))).astype(np.float32)
    err = rng.uniform(0.05, 0.2, (N, NPIX)).astype(np.float32)
    zabs = rng.uniform(2.0, 3.0, (N, NB)).astype(np.float32)
    return x, err, zabs, np.ones((N, NPIX), np.float32)


def params():
    return random_init(NPIX, NB, NH,
                       generator=torch.Generator().manual_seed(1))


def train(out_dir, epochs_per_launch=1):
    cfg = TrainConfig(n_epochs=4, batch_size=8, learning_rate=1e-2,
                      smooth_interval=2, save_interval=2)
    data = ResidualDataset(*(torch.tensor(x) for x in planes()))
    return fit_fused(params(), data, np.ones(NPIX, np.float32), cfg,
                     output_dir=str(out_dir), plain=True,
                     epochs_per_launch=epochs_per_launch)


def predict():
    flux, err, zabs, _ = (torch.tensor(x) for x in planes())
    return infer_kernel.fused_predict(params().requires_grad_(False),
                                      torch.ones(NPIX), flux + 1.0, err, zabs)


def events(prof, prefix="qfa."):
    """(name, start ns, end ns, is_user_annotation) of the trace's events
    whose names start with ``prefix``, by start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
            e.is_user_annotation())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(prefix)]
    return sorted(out, key=lambda x: (x[1], -x[2]))


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One traced training, one traced prediction and their untraced
    twins."""
    root = tmp_path_factory.mktemp("spans")
    fit, fit_prof = profiled(lambda: train(root / "traced"))
    pred, pred_prof = profiled(predict)
    return SimpleNamespace(fit=fit, fit_events=events(fit_prof),
                           pred=pred, pred_events=events(pred_prof),
                           fit_plain=train(root / "plain"),
                           pred_plain=predict())


def test_span_is_one_shared_noop_with_the_profiler_off():
    assert not torch.autograd._profiler_enabled()
    assert span("qfa.a") is span("qfa.b") is profiling._NO_SPAN
    with span("qfa.a"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("qfa.a") is not profiling._NO_SPAN
    assert "span" in profiling.__all__


@pytest.mark.parametrize("epochs_per_launch", [1, 2])
def test_fit_fused_records_its_phases_in_loop_order(tmp_path, monkeypatch,
                                                    epochs_per_launch):
    """Four epochs, smoothing and checkpoints every two, the plain engine
    in a launch span as the CUDA wrapper's: each chunk's phases once, in
    loop order, inside one ``qfa.fit_fused``; the next chunk's shuffle
    and launch (and this chunk's smoothing) come before this chunk's
    read-back, its checkpoint after its report."""
    plain = fused_engine.fused_train_epoch_plain

    def engine(*args, **kw):
        with span("qfa.epoch_kernel.launch"):
            return plain(*args, **kw)

    monkeypatch.setattr(fused_engine, "fused_train_epoch_plain", engine)
    _, prof = profiled(lambda: train(tmp_path, epochs_per_launch))
    ev = events(prof)
    assert [e[0] for e in ev if e[0] == "qfa.fit_fused"] == ["qfa.fit_fused"]
    _, lo, hi, _ = ev[0]
    assert ev[0][0] == "qfa.fit_fused"
    assert all(lo <= s and e <= hi for _, s, e, _ in ev)
    smooth, save = ([x] for x in CHECKPOINT)
    per_chunk = {1: [LAUNCH, LAUNCH, READ, smooth, LAUNCH, READ, save,
                     LAUNCH, READ, smooth, READ, save],
                 2: [LAUNCH, smooth, LAUNCH, READ, save, smooth, READ,
                     save]}[epochs_per_launch]
    assert [e[0] for e in ev[1:]] == sum(per_chunk, [])
    # siblings: each phase ends before the next starts
    assert all(a[2] <= b[1] for a, b in zip(ev[1:], ev[2:]))


def test_fused_predict_records_its_call(traced):
    assert [e[0] for e in traced.pred_events] == ["qfa.fused_predict"]


def test_spans_are_cpu_ops_not_annotations(traced):
    ev = traced.fit_events + traced.pred_events
    assert ev and not any(e[3] for e in ev)


def test_outputs_are_bitwise_the_same_traced(traced):
    (p, h), (q, g) = traced.fit, traced.fit_plain
    assert h == g
    for k, v in p.as_dict().items():
        assert torch.equal(v, q.as_dict()[k]), k
    for k in ("ll", "hmean", "hcov", "continuum", "continuum_std", "n_obs"):
        assert torch.equal(getattr(traced.pred, k),
                           getattr(traced.pred_plain, k)), k


def test_epoch_kernel_launch_span_covers_the_cuda_wrapper(monkeypatch):
    """The CUDA path of ``fused_train_epoch``, its checks and launch
    stood in for: ``qfa.epoch_kernel.launch`` holds both."""
    monkeypatch.setattr(epoch_kernel, "_check_args",
                        lambda *a: torch.zeros(1))
    monkeypatch.setattr(epoch_kernel, "_launch",
                        lambda *a, **k: torch.ones(1))
    card = SimpleNamespace(device=torch.device("cuda"))
    p = params()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = epoch_kernel.fused_train_epoch(p, p, p, card, None, None,
                                             None, epoch=0, n_batches=1)
    assert torch.equal(out, torch.ones(1))
    (name, lo, hi, ann), = events(prof)
    assert name == "qfa.epoch_kernel.launch" and not ann
    inner = [e for e in events(prof, "aten::") if lo <= e[1] and e[2] <= hi]
    assert {"aten::zeros", "aten::ones"} <= {e[0] for e in inner}


def test_fused_predict_launch_span_covers_the_c_call(monkeypatch):
    """``_launch`` on a stand-in library: ``qfa.fused_predict.launch``
    holds the C call and not the outputs' allocation before it."""
    calls = []

    def c_call(*args):
        calls.append(torch.full((1,), 2.0))
        return 0

    lib = SimpleNamespace(qfa_predict_f32=c_call)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "device_and_stream", lambda dev: (0, None))
    flux, err, zabs, mask = (torch.tensor(x) for x in planes())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        infer_kernel._launch(
            params().requires_grad_(False), torch.ones(NPIX), flux, err,
            zabs, mask, law=tau_law_abc("becker"), stats_only=False,
            loglam=None, derive_zabs=False, out_dtype=torch.float32)
    assert len(calls) == 1
    (name, lo, hi, ann), = events(prof)
    assert name == "qfa.fused_predict.launch" and not ann
    aten = events(prof, "aten::")
    inside = [e[0] for e in aten if lo <= e[1] and e[2] <= hi]
    assert inside[0] == "aten::full"  # with its own children
    assert any(e[0] == "aten::empty" and e[2] <= lo for e in aten)
