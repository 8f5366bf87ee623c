"""Device-idle time charged to the program's spans (``portbench/idle.py``
and the ``train.idle_*_ms`` / ``predict.idle_call_ms`` readers) on
made-up traces."""

from __future__ import annotations

import pytest

from portbench import idle
from portbench.tests.test_portbench_metrics import SPEC, ctx, summary

TRAIN = ("train.idle_shuffle_ms", "train.idle_launch_ms",
         "train.idle_epoch_end_ms", "train.idle_checkpoint_ms",
         "train.idle_other_ms")


def epoch_trace(epochs=2, per=100):
    """``epochs`` epochs of ``per`` ns: the host in shuffle 0-20, launch
    20-30 (the kernel 25-80), readback 30-85, check 85-88, report 88-90,
    unspanned Python 90-95 and save 95-100 in the last epoch; an aten op
    and a benchmark span cover parts of it."""
    dev, host = [], [("qfa.fit_fused", 0, epochs * per),
                     ("portbench.train.fit_fused", 0, epochs * per)]
    for k in range(epochs):
        t = k * per
        dev.append(("forward_kernel", t + 25, t + 80))
        host += [("qfa.fit_fused.shuffle", t, t + 20),
                 ("aten::randperm", t + 2, t + 18),
                 ("qfa.epoch_kernel.launch", t + 20, t + 30),
                 ("cudaMemcpyAsync", t + 21, t + 24),
                 ("qfa.fit_fused.readback", t + 30, t + 85),
                 ("cudaStreamSynchronize", t + 31, t + 84),
                 ("qfa.fit_fused.check", t + 85, t + 88),
                 ("qfa.fit_fused.report", t + 88, t + 90)]
    host.append(("qfa.fit_fused.save", epochs * per - 5, epochs * per))
    return summary(dev, window=(0, epochs * per), host=host)


def without(tr, drop):
    """``tr`` with the host events that ``drop(name)`` accepts taken out."""
    names, s, e = tr.host
    keep = [i for i, n in enumerate(names) if not drop(n)]
    return tr._replace(host=([names[i] for i in keep], s[keep], e[keep]))


def test_idle_goes_to_the_innermost_program_span():
    c = idle.charge(epoch_trace())
    # the aten op and the benchmark's span inside are passed over
    assert c["qfa.fit_fused.shuffle"] == 2 * 20
    assert c["qfa.epoch_kernel.launch"] == 2 * 5
    assert c["qfa.fit_fused.readback"] == 2 * 5
    assert c["qfa.fit_fused.check"] == 2 * 3
    assert c["qfa.fit_fused.report"] == 2 * 2
    assert c["qfa.fit_fused.save"] == 5
    assert c["qfa.fit_fused"] == 5 + 10  # own time, both epochs' 90-95
    assert None not in c


def test_nested_spans_and_idle_outside_every_span():
    tr = summary([("k", 40, 60)], window=(0, 100),
                 host=[("qfa.a", 10, 90), ("qfa.a.b", 20, 70),
                       ("qfa.a.b.c", 30, 50), ("aten::mm", 0, 100),
                       ("portbench.x", 0, 100)])
    assert idle.charge(tr) == {None: 10 + 10, "qfa.a": 10 + 20,
                               "qfa.a.b": 10 + 10, "qfa.a.b.c": 10}


def test_gaps_are_the_complement_of_the_busy_union():
    tr = summary([("k1", 10, 30), ("k2", 20, 40), ("k3", 40, 50),
                  ("k4", 70, 120)], window=(0, 100))
    starts, ends = idle.idle_gaps(tr)
    assert list(zip(starts, ends)) == [(0, 10), (50, 70)]
    assert sum(ends - starts) * 1e-9 == pytest.approx(
        1e-7 - tr.busy_s, abs=1e-15)


def test_train_readers_split_the_idle_per_epoch():
    tr = epoch_trace(epochs=2)
    c = ctx({"rows": 10, "epochs": 2, "window_s": 2e-7}, trace=tr)
    got = {m: SPEC.reader(m)(c) for m in TRAIN}
    assert got["train.idle_shuffle_ms"] == pytest.approx(20e-6)
    assert got["train.idle_launch_ms"] == pytest.approx(5e-6)
    assert got["train.idle_epoch_end_ms"] == pytest.approx(10e-6)
    assert got["train.idle_checkpoint_ms"] == pytest.approx(2.5e-6)
    assert got["train.idle_other_ms"] == pytest.approx(7.5e-6)
    # the five sum to the idle per epoch that train.idle_share reads
    share = SPEC.reader("train.idle_share")(c)
    per_epoch = share / 100 * 200 * 1e-6 / 2
    assert sum(got.values()) == pytest.approx(per_epoch, rel=1e-12)


def test_unspanned_idle_is_other():
    tr = without(epoch_trace(epochs=1), lambda n: n.endswith(".shuffle"))
    c = ctx({"rows": 10, "epochs": 1, "window_s": 1e-7}, trace=tr)
    assert SPEC.reader("train.idle_shuffle_ms")(c) == 0.0
    assert SPEC.reader("train.idle_other_ms")(c) == pytest.approx(
        (20 + 5) * 1e-6)


def test_predict_reader_charges_the_call_and_its_launch():
    tr = summary([("predict_kernel", 12, 90), ("predict_kernel", 112, 190)],
                 window=(0, 200),
                 host=[("portbench.predict.sweep", 0, 100),
                       ("aten::slice", 0, 2),
                       ("qfa.fused_predict", 2, 12),
                       ("qfa.fused_predict.launch", 9, 11),
                       ("portbench.predict.sweep", 100, 200),
                       ("qfa.fused_predict", 101, 110),
                       ("qfa.fused_predict.launch", 108, 110)])
    c = ctx({"rows": 10, "sweeps": 2, "window_s": 2e-7}, trace=tr)
    # per sweep: (10 + 9) ns under the calls; the slice, the launch's
    # latency and the ends of the sweeps are no call's
    assert SPEC.reader("predict.idle_call_ms")(c) == pytest.approx(9.5e-6)


@pytest.mark.parametrize("metric", TRAIN + ("predict.idle_call_ms",))
def test_readers_find_nothing_without_spans_trace_or_units(metric):
    tr = epoch_trace()
    per = "sweeps" if metric.startswith("predict") else "epochs"
    assert SPEC.reader(metric)(ctx({"rows": 1, per: 2, "window_s": 1.0})) \
        is None
    assert SPEC.reader(metric)(ctx({"rows": 1, "window_s": 1.0}, trace=tr)) \
        is None
    # a program without the spans (an older tree): nothing, no raise
    bare = without(tr, lambda n: n.startswith("qfa."))
    assert SPEC.reader(metric)(ctx({"rows": 1, per: 2, "window_s": 1.0},
                                   trace=bare)) is None
