"""Device-idle time charged to the phase the program's host was in.

The port marks its host phases with ``qfa.*`` spans
(``qfa_tpu_torch.utils.profiling.span``: ``cpu_op`` events on the device
events' clock). Every instant of the traced window at which no operation
ran on the device is charged to the innermost ``qfa.*`` span covering it
on the host, or to None where none covers it. Other host events (aten
operators, runtime calls, the benchmark's own spans) are passed over:
they say what the host called, not in which phase. The charges sum to
the window's idle time, the complement of ``Summary.busy_s``.

The readers in ``metrics/`` give the charges per epoch or per sweep, in
ms; they find nothing (None) in a trace without the program's spans.
"""

from __future__ import annotations

import numpy as np

PREFIX = "qfa."

#: the spans of fit_fused's epoch loop whose idle each training metric
#: reads; ``train.idle_other_ms`` reads the rest of the idle time (no
#: span, or ``qfa.fit_fused``'s own time)
TRAIN_PHASES = {
    "train.idle_shuffle_ms": ("qfa.fit_fused.shuffle",),
    "train.idle_launch_ms": ("qfa.epoch_kernel.launch",),
    "train.idle_epoch_end_ms": ("qfa.fit_fused.readback",
                                "qfa.fit_fused.check",
                                "qfa.fit_fused.report"),
    "train.idle_checkpoint_ms": ("qfa.fit_fused.smooth",
                                 "qfa.fit_fused.save"),
}
PREDICT_CALL = ("qfa.fused_predict", "qfa.fused_predict.launch")


def idle_gaps(trace) -> tuple[np.ndarray, np.ndarray]:
    """Starts and ends (ns) of the window's intervals in which no device
    operation ran."""
    lo, hi = trace.window
    s = np.clip(trace.starts, lo, hi)
    e = np.clip(trace.ends, lo, hi)
    keep = e > s
    order = np.argsort(s[keep], kind="stable")
    s, e = s[keep][order], e[keep][order]
    reach = np.maximum.accumulate(e) if len(e) else e
    starts = np.concatenate([[lo], reach]).astype(np.int64)
    ends = np.concatenate([s, [hi]]).astype(np.int64)
    gap = ends > starts
    return starts[gap], ends[gap]


def _spans(trace):
    """Names, starts and ends (ns, clipped to the window) of the
    program's spans."""
    lo, hi = trace.window
    names, s, e = trace.host
    idx = [i for i, n in enumerate(names) if n.startswith(PREFIX)]
    return ([names[i] for i in idx], np.clip(s[idx], lo, hi),
            np.clip(e[idx], lo, hi))


def charge(trace) -> dict:
    """Idle ns of the window by the innermost program span covering it
    (None: no span)."""
    gs, ge = idle_gaps(trace)
    names, ss, se = _spans(trace)
    cuts = np.unique(np.concatenate([gs, ge, ss, se]))
    if len(cuts) < 2:
        return {}
    label = np.full(len(cuts) - 1, -1, np.int64)
    # outer spans first (by start, the longer first), so that each inner
    # span paints over its parent
    for i in np.lexsort((-se, ss)):
        label[np.searchsorted(cuts, ss[i]):np.searchsorted(cuts, se[i])] = i
    seg = cuts[:-1]
    j = np.searchsorted(gs, seg, side="right") - 1
    idle = (j >= 0) & (seg < ge[np.maximum(j, 0)])
    ns = np.bincount(label + 1, weights=np.diff(cuts) * idle,
                     minlength=len(names) + 1)
    out: dict = {None: int(ns[0])} if ns[0] else {}
    for name, v in zip(names, ns[1:]):
        if v:
            out[name] = out.get(name, 0) + int(v)
    return out


def span_ms(trace, name: str) -> tuple[int, float]:
    """Calls of the span ``name`` in the window and their mean host ms."""
    names, ss, se = _spans(trace)
    d = [b - a for n, a, b in zip(names, ss, se) if n == name]
    return len(d), (1e-6 * float(np.mean(d)) if d else 0.0)


def _charges(ctx, per: str, root: str):
    """(charges, units) of a traced run whose program recorded ``root``,
    ``units`` the window's count of ``per``; None otherwise."""
    if ctx.trace is None or not ctx.stats.get(per):
        return None
    if root not in ctx.trace.host[0]:
        return None
    return charge(ctx.trace), ctx.stats[per]


def _say_spans(ctx, metric: str, spans, charges: dict, per: str) -> None:
    for name in spans:
        calls, mean = span_ms(ctx.trace, name)
        idle = 1e-6 * charges.get(name, 0) / max(calls, 1)
        ctx.say(f"{metric}: {name} {calls} calls, {mean:.4f} ms each on "
                f"the host, {idle:.4f} ms of it with the device idle "
                f"({ctx.stats[per]} {per})")


def train_phase(ctx, metric: str):
    """Device-idle ms per epoch charged to the spans of ``metric`` in
    :data:`TRAIN_PHASES`, or, for ``train.idle_other_ms``, to none of
    them."""
    got = _charges(ctx, "epochs", "qfa.fit_fused")
    if got is None:
        return None
    charges, epochs = got
    if metric in TRAIN_PHASES:
        spans = TRAIN_PHASES[metric]
        _say_spans(ctx, metric, spans, charges, "epochs")
        ns = sum(charges.get(n, 0) for n in spans)
    else:
        named = {n for spans in TRAIN_PHASES.values() for n in spans}
        ns = sum(v for k, v in charges.items() if k not in named)

        def ms(v):
            return f"{1e-6 * v / epochs:.4f} ms"

        ctx.say(f"{metric}: {ms(ns)} per epoch outside the named phases, "
                f"of {ms(sum(charges.values()))} idle per epoch; no span "
                f"{ms(charges.get(None, 0))}, qfa.fit_fused's own "
                f"{ms(charges.get('qfa.fit_fused', 0))}")
    return 1e-6 * ns / epochs


def predict_call(ctx):
    """Device-idle ms per sweep charged to ``fused_predict``'s spans."""
    got = _charges(ctx, "sweeps", PREDICT_CALL[0])
    if got is None:
        return None
    charges, sweeps = got
    _say_spans(ctx, "predict.idle_call_ms", PREDICT_CALL, charges, "sweeps")
    return 1e-6 * sum(charges.get(n, 0) for n in PREDICT_CALL) / sweeps
