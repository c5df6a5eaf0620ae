"""A profiled slice of the traced run: torch.profiler over a few seconds
of the window, read into device intervals.

From the slice: the union of the device's activity (busy seconds), each
device operation's total time, every launch of a named kernel, and the
idle gaps between device work, each named by the innermost span of the
program's tracer that was open at the gap's middle (the two clocks meet
at a mark put into both at the slice's start).
"""

from __future__ import annotations

import bisect
import time

MARK = "mcts_bench-mark"


class Slice:
    def __init__(self, tracer=None):
        self.tracer = tracer
        self.prof = None
        self.t0 = self.t1 = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        if self.tracer is not None:
            self.tracer.instant(MARK)
        with record_function(MARK):
            pass

    def stop(self) -> dict:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        evs = self.prof.events()
        mark = min(e.time_range.start for e in evs
                   if e.name == MARK and e.device_type == DeviceType.CPU)
        lo = mark
        hi = mark + 1e6 * (self.t1 - self.t0)
        dev = sorted((e.name, max(lo, e.time_range.start),
                      min(hi, e.time_range.end)) for e in evs
                     if e.device_type == DeviceType.CUDA
                     and e.time_range.end > lo and e.time_range.start < hi)
        dev.sort(key=lambda x: x[1])
        self.prof = None
        return read_slice(dev, lo, hi, self._spans(lo))

    def _spans(self, lo: float) -> list:
        """The tracer's complete spans as (start, end, name) on the
        profiler's clock."""
        if self.tracer is None:
            return []
        events = self.tracer.events()
        marks = [e["ts"] for e in events if e.get("name") == MARK]
        if not marks:
            return []
        shift = lo - marks[-1]
        return [(e["ts"] + shift, e["ts"] + e["dur"] + shift, e["name"])
                for e in events if e.get("ph") == "X"]


def read_slice(dev: list, lo: float, hi: float, spans: list) -> dict:
    """`dev`: (name, start, end) device operations in microseconds,
    clipped to [lo, hi] and sorted by start."""
    union, busy, end = [], 0.0, lo
    for _, a, b in dev:
        if b <= end:
            continue
        a = max(a, end)
        busy += b - a
        if union and a <= union[-1][1]:
            union[-1][1] = b
        else:
            union.append([a, b])
        end = b
    ops: dict = {}
    for name, a, b in dev:
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
    gaps, prev = [], lo
    for a, b in union + [[hi, hi]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    # spans nest (a tick holds its pool's phases), so the innermost span
    # open at a time is the latest-started one that has not ended
    spans = sorted(s for s in spans if s[1] > lo and s[0] < hi)
    starts = [s[0] for s in spans]
    named: dict = {}
    for a, b in gaps:
        mid, name = 0.5 * (a + b), "between ticks"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 64, -1), -1):
            if spans[j][1] > mid:
                name = spans[j][2]
                break
        named.setdefault(name, []).append((b - a) / 1e6)
    longest = sorted(((n, d) for n, v in named.items() for d in v),
                     key=lambda x: -x[1])[:10]
    idle_by_span = sorted(((n, sum(v)) for n, v in named.items()),
                          key=lambda x: -x[1])
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy / 1e6,
        "launches": dev,
        "device_ops": sorted(ops.items(), key=lambda x: -x[1]),
        "idle_gaps": longest,
        "idle_by_span": idle_by_span,
    }
