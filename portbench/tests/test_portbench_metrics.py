"""The metric arithmetic on made-up timings: window rates, the tail from
due times, both roofline bounds, mfu, and the trace's reduction."""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import roofline, spec as spec_mod
from portbench.tests.conftest import ROOT
from portbench.trace import Summary

SPEC = spec_mod.Spec()
SDSS = json.loads((ROOT / "portbench/configs/qfa-sdss.json").read_text())
DESI = json.loads((ROOT / "portbench/configs/qfa-desi.json").read_text())


def ctx(stats, config=SDSS, traffic=None, trace=None, chips=1):
    traffic = traffic or {"batch_size": 500, "stats_only": False}
    return SimpleNamespace(stats=stats, trace=trace, chips=chips, setup_s=12.5,
                           card="test", say=lambda m: None,
                           cell=SimpleNamespace(config=config,
                                                traffic=traffic))


def summary(intervals, window=(0, 10_000_000_000), host=()):
    names = [n for n, _, _ in intervals]
    s = np.array([a for _, a, _ in intervals], np.int64)
    e = np.array([b for _, _, b in intervals], np.int64)
    hn = [n for n, _, _ in host]
    return Summary(names, s, e, (hn, np.array([a for _, a, _ in host],
                                              np.int64),
                                 np.array([b for _, _, b in host], np.int64)),
                   window, (window[1] - window[0]) * 1e-9)


def test_rates_are_all_the_work_over_all_the_window():
    c = ctx({"rows": 262144, "epochs": 300, "window_s": 10.0})
    assert SPEC.reader("train_spectra_per_s")(c) == 262144 * 300 / 10.0
    c = ctx({"rows": 1000, "sweeps": 7, "window_s": 2.0})
    assert SPEC.reader("predict_spectra_per_s")(c) == 3500.0
    assert SPEC.reader("train_spectra_per_s")(c) is None
    assert SPEC.reader("setup_s")(c) == 12.5


def test_bounds_name_which_binds():
    # SDSS epoch: 4.02 GB of planes at 3.35 TB/s against 0.13 ms of bf16
    rows, n_b = 262500, 525
    t, which = roofline.bound_s(
        roofline.epoch_flops(rows, 1913, 8),
        roofline.epoch_bytes(rows, 1913, 720, 8, 4, n_b), "bf16")
    assert which == "bytes" and t == pytest.approx(1.2e-3, rel=0.01)
    t, which = roofline.bound_s(1e15, 1.0, "bf16")
    assert which == "operations" and t == pytest.approx(1e15 / 989e12)
    assert roofline.peak_flops("fp32") == pytest.approx(165e12)
    assert roofline.epoch_flops(1, 1, 8) == 2 * 3 * (36 + 8)
    assert roofline.predict_flops(1, 1, 8) == 2 * 44 * 2
    assert roofline.roofline_pct(1.0, 0) is None


def test_mfu_and_rooflines_on_a_made_up_trace():
    epochs, per_epoch = 10, 0.030
    iv = []
    for k in range(epochs):
        t0 = int(k * per_epoch * 1e9)
        iv += [("void forward_kernel<8>(EpochArgs)", t0, t0 + 15_000_000),
               ("void backward_kernel<8>(EpochArgs)", t0 + 14_000_000,
                t0 + 25_000_000),
               ("Memcpy DtoH", t0 + 26_000_000, t0 + 26_500_000)]
    tr = summary(iv, window=(0, int(epochs * per_epoch * 1e9)))
    stats = {"rows": 262144, "epochs": epochs, "window_s": epochs * per_epoch}
    c = ctx(stats, traffic={"batch_size": 500}, trace=tr)
    mfu = SPEC.reader("train.mfu")(c)
    flops = roofline.epoch_flops(262144, 1913, 8)
    assert mfu == pytest.approx(100 * flops / per_epoch / 989e12)
    roof = SPEC.reader("epoch_kernel_roofline")(c)
    bound = roofline.epoch_bytes(262500, 1913, 720, 8, 4, 525) / 3.35e12
    # overlapping kernels count once: 25 ms per epoch
    assert roof == pytest.approx(100 * bound / 0.025)
    idle = SPEC.reader("train.idle_share")(c)
    assert idle == pytest.approx(100 * (1 - 25.5 / 30))


def test_predict_readers():
    tr = summary([("Memcpy HtoD", 0, 1_000_000),
                  ("void predict_kernel<8,float,0>(PredictArgs)", 1_000_000,
                   3_000_000)], window=(0, 10_000_000))
    stats = {"rows": 1000, "sweeps": 2, "window_s": 0.01}
    c = ctx(stats, config=DESI, trace=tr,
            traffic={"stats_only": False, "batch_size": 1})
    b = roofline.predict_bytes(1000, 9243, 2238, 8) / 3.35e12
    assert SPEC.reader("predict_kernel_roofline")(c) == pytest.approx(
        100 * 2 * b / 2e-3)
    assert SPEC.reader("predict.mfu")(c) == pytest.approx(
        100 * 2 * roofline.predict_flops(1000, 9243, 8) / 0.01 / 165e12)


def test_readers_find_nothing_without_a_trace():
    c = ctx({"rows": 1, "epochs": 1, "window_s": 1.0})
    for m in ("epoch_kernel_roofline", "train.idle_share",
              "predict.idle_share", "predict_kernel_roofline"):
        assert SPEC.reader(m)(c) is None


def test_breakdown_names_gaps_by_host_event():
    tr = summary([("k1", 100, 200), ("k2", 500, 600), ("k1", 650, 700)],
                 window=(0, 1000),
                 host=[("portbench.train.fit_fused", 0, 1000),
                       ("cudaStreamSynchronize", 250, 450)])
    assert tr.busy_s == pytest.approx(250e-9)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(150e-9)]
    assert b["idle_gaps"][0] == ["cudaStreamSynchronize",
                                 pytest.approx(300e-9)]
    assert b["idle_gaps"][1][0] == "portbench.train.fit_fused"
