"""The traced window: ``torch.profiler`` around the window, reduced to
device intervals, busy time, the device operations that took the most
time, and the longest idle gaps named by what the host was doing.

The benchmark's own spans (``span``) are ``record_function`` ranges, so
they sit in the trace on the device events' clock.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

WINDOW_SPAN = "portbench.window"


def span(name: str):
    """A benchmark span in the trace (no cost beyond the profiler's)."""
    return torch.profiler.record_function(name)


class Summary(NamedTuple):
    names: list  #: device op name of each interval
    starts: np.ndarray  #: ns
    ends: np.ndarray  #: ns
    host: tuple  #: (names, start ns, end ns) of host events and spans
    window: tuple  #: (start ns, end ns) of the window span
    window_s: float  #: host clock of the traced window

    def union_s(self, keep=None) -> float:
        """Seconds in which a device op (one that ``keep(name)`` accepts)
        ran, overlaps counted once, inside the window."""
        idx = [i for i, n in enumerate(self.names) if keep is None or keep(n)]
        if not idx:
            return 0.0
        return _union(self.starts[idx], self.ends[idx], *self.window) * 1e-9

    @property
    def busy_s(self) -> float:
        return self.union_s()

    def breakdown(self, k: int = 10) -> dict:
        lo, hi = self.window
        by = {}
        for n, s, e in zip(self.names, self.starts, self.ends):
            if e > lo and s < hi:
                by[n] = by.get(n, 0.0) + (min(e, hi) - max(s, lo)) * 1e-9
        ops = sorted(by.items(), key=lambda x: -x[1])[:k]
        gaps = []
        order = np.argsort(self.starts, kind="stable")
        cur = lo
        for i in order:
            s, e = int(self.starts[i]), int(self.ends[i])
            if e <= lo or s >= hi:
                continue
            if s > cur:
                gaps.append((cur, min(s, hi)))
            cur = max(cur, e)
        if cur < hi:
            gaps.append((cur, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:k]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[self.host_at((a + b) // 2), (b - a) * 1e-9]
                              for a, b in gaps]}

    def host_at(self, t: int) -> str:
        """The innermost host event or span running at ``t`` (ns)."""
        names, s, e = self.host
        hit = np.flatnonzero((s <= t) & (t < e))
        if not len(hit):
            return "host (no event)"
        return names[hit[np.argmax(s[hit])]]


def _union(starts, ends, lo, hi) -> int:
    s = np.clip(starts, lo, hi)
    e = np.clip(ends, lo, hi)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    total, cur_s, cur_e = 0, None, None
    for a, b in zip(s.tolist(), e.tolist()):
        if b <= a:
            continue
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class Tracer:
    """``with Tracer() as t: ...`` profiles the block; ``t.summary`` holds
    the reduction. A first profiler step traces a little warm-up work and
    is dropped: a trace started right before a run can lose its first
    launches' device events."""

    def __init__(self):
        self.summary: Summary | None = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, schedule

        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self.prof.__enter__()
        warm = torch.zeros(256, device="cuda")
        for _ in range(8):
            warm.add_(1.0)
        torch.cuda.synchronize()
        self.prof.step()
        self._span = span(WINDOW_SPAN)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        try:
            self._span.__exit__(None, None, None)
            self.prof.step()
        finally:
            self.prof.__exit__(None, None, None)
        if exc[0] is None:
            self.summary = reduce(self.prof, window_s)
        return False


def reduce(prof, window_s: float) -> Summary:
    """Device intervals and host events of a finished profile."""
    from torch.autograd import DeviceType

    names, starts, ends = [], [], []
    hn, hs, he = [], [], []
    window = None
    for ev in prof.profiler.kineto_results.events():
        n = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            # a span's range also shows on the device's rows: not work
            if not n.startswith(("ProfilerStep", "portbench")):
                names.append(n)
                starts.append(s)
                ends.append(e)
        else:
            if n == WINDOW_SPAN:
                window = (s, e)
            elif not n.startswith("ProfilerStep"):
                hn.append(n)
                hs.append(s)
                he.append(e)
    if window is None:
        raise RuntimeError("the traced window's span is not in the trace")
    return Summary(names, np.asarray(starts, np.int64),
                   np.asarray(ends, np.int64),
                   (hn, np.asarray(hs, np.int64), np.asarray(he, np.int64)),
                   window, window_s)
