"""Tracer — nested spans over a lock-free ring buffer, Chrome-trace out.

The port's copy of repro.obs.trace (pure Python), with two changes: on a
card the fence is ``torch.cuda.synchronize``, and the tracer keeps each
span name's totals (below).

The paper's 35x in-tree and 3x system numbers rest on Fig. 8-style phase
breakdowns: knowing, per superstep, where the time went on each side of
the CPU/accelerator boundary.  This module is the measurement substrate
for the serving stack — zero dependencies (stdlib only), cheap enough to
stay wired into every layer, and exportable to the trace viewers people
actually use:

  Tracer      records four event kinds into a fixed-capacity ring
              (drop-oldest, no locks — a single writer index is the whole
              synchronization story, which is all the single-threaded
              serving loop needs while staying safe under the GIL):

                * complete spans   — begin()/end() or the span() context
                  manager; per-track LIFO nesting is enforced, so a
                  malformed instrumentation site fails loudly instead of
                  exporting garbage;
                * instants         — point events (admit / move-commit /
                  cancel / retire);
                * async spans      — async_begin()/async_end() pairs keyed
                  by (cat, name, id): request lifecycles that span many
                  ticks and interleave arbitrarily;
                * track metadata   — track() names a timeline (scheduler,
                  one per arena pool) and returns its tid.

  totals      every complete span that ends adds, under its name, its
              duration, its self time (the duration less what its child
              spans on the same track cover) and a count of one to three
              counters, kept whether or not the ring drops events:

                trace_span_seconds_total{span=<name>}
                trace_span_self_seconds_total{span=<name>}
                trace_spans_total{span=<name>}

              ``bind_metrics(registry)`` moves them into a registry, so
              they render with the rest (``SearchClient(trace=True,
              metrics=True)`` binds its own: ``client.metrics()``).
              Async spans and instants are not counted.

  export()    Chrome-trace / Perfetto JSON ({"traceEvents": [...]}):
              load the file at ui.perfetto.dev or chrome://tracing.
              Timestamps are microseconds relative to Tracer creation.

  NULL_TRACER the disabled path: same surface, every method a no-op,
              `enabled` False so call sites can gate explicit
              device fences on tracing being live.  Layers
              default to it, which keeps the disabled-path overhead at
              a handful of no-op calls per superstep.

The spans of a serving pool (service/pool.py), on its track:

  superstep | fused-dispatch     one tick of the pool (phase path | fused)
    admission                    requests into free slots: fresh trees
    select, expand, simulate,    the superstep's phases (expand and
      backup                     simulate also inside a fused escape)
    finalize-build               the host scatter of the finalize rows
    fused-submit                 a fused dispatch's upload and queueing
    fused-collect                the host waiting for its one read-back
    fused-finish                 device rows into the state tables,
                                 accounting, the escape, the commits
    commits                      the move boundary of every dispatched slot
      commit                     one committed move, holding:
        snapshot                 the root's row read (the whole tree, for
                                 a request that keeps it, or on the numpy
                                 oracle's host path)
        reroot                   the re-root's kernels and the kept ids
                                 read back (the oracle: core.reroot)
        write-back               the slot written from the re-root's
                                 scratch tree (or a fresh tree uploaded)
        st-write                 the state table compacted (or flushed)
    compact-gather, compact-scatter   the compaction session's copies

The three `fused-*` spans open and close with the ServiceStats timers
of the same names (`t_fused_submit`, ...).  Traced, `admission` and
`write-back` end with a device fence, so the
device work they queue (uploads, the re-root's write) is charged to them.  The overlap path's gangs share
one device stream: there the fence (and an upload from pageable host
memory, traced or not) also waits for the other gang's bodies in
flight, which these two spans, and `commit`, then hold.

The clock is injectable (``clock_ns``) so tests can pin nesting and
ordering deterministically.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["Span", "Tracer", "NullTracer", "NULL_TRACER"]


class Span:
    """An open span: the token begin() hands out and end() consumes.
    Carries everything the eventual "X" record needs except duration,
    and the microseconds its ended children on its track have covered."""

    __slots__ = ("name", "cat", "tid", "ts", "args", "depth", "child")

    def __init__(self, name, cat, tid, ts, args, depth):
        self.name, self.cat, self.tid = name, cat, tid
        self.ts, self.args, self.depth = ts, args, depth
        self.child = 0.0


class _SpanCtx:
    """``with tracer.span(...)`` — allocation-light begin/end pairing."""

    __slots__ = ("_tracer", "_name", "_cat", "_tid", "_args", "_tok")

    def __init__(self, tracer, name, cat, tid, args):
        self._tracer, self._name, self._cat = tracer, name, cat
        self._tid, self._args = tid, args

    def __enter__(self):
        self._tok = self._tracer.begin(self._name, cat=self._cat,
                                       tid=self._tid, **self._args)
        return self._tok

    def __exit__(self, *exc):
        self._tracer.end(self._tok)


def _jsonable(v):
    """Coerce an args value to something json.dumps accepts (numpy
    scalars arrive from metric sites; stringify anything exotic)."""
    if isinstance(v, (bool, str)):
        return v
    if isinstance(v, float):
        return v
    try:
        return int(v)
    except (TypeError, ValueError):
        pass
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class Tracer:
    """Nested-span tracer over a fixed-capacity drop-oldest ring."""

    enabled = True

    def __init__(self, capacity: int = 1 << 16,
                 clock_ns: Optional[Callable[[], int]] = None, pid: int = 0):
        if capacity <= 0:
            raise ValueError(f"tracer capacity must be positive: {capacity}")
        self.capacity = capacity
        self.pid = pid
        self._clock = time.perf_counter_ns if clock_ns is None else clock_ns
        self._t0 = self._clock()
        # the ring: one preallocated slot list + a single monotonically
        # increasing write index (lock-free single-writer discipline)
        self._ring: list = [None] * capacity
        self._n = 0
        self._stacks: dict[int, list] = {}   # tid -> open-span stack
        self._tracks: dict[str, int] = {}    # track name -> tid
        self._next_tid = 0
        # metadata events (process/track names): tiny, never dropped
        self._meta: list[dict] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "search-service"},
        }]
        # span totals: a registry of the tracer's own until bind_metrics,
        # and each name's three counters looked up once
        self._registry = MetricsRegistry()
        self._totals: dict[str, tuple] = {}

    # ---- clock / buffer ----
    def _now_us(self) -> float:
        return (self._clock() - self._t0) / 1e3

    def _push(self, ev: dict):
        self._ring[self._n % self.capacity] = ev
        self._n += 1

    @property
    def dropped(self) -> int:
        """Events evicted by the ring (oldest-first)."""
        return max(0, self._n - self.capacity)

    # ---- tracks ----
    def track(self, name: str) -> int:
        """Get-or-create a named timeline; returns its tid.  Tracks keep
        each pool's phase spans properly nested even when a gang tick
        interleaves several pools' begin/finish halves."""
        tid = self._tracks.get(name)
        if tid is None:
            tid = self._tracks[name] = self._next_tid
            self._next_tid += 1
            self._meta.append({
                "ph": "M", "name": "thread_name", "pid": self.pid,
                "tid": tid, "args": {"name": name}})
            self._meta.append({
                "ph": "M", "name": "thread_sort_index", "pid": self.pid,
                "tid": tid, "args": {"sort_index": tid}})
        return tid

    # ---- span totals ----
    def _totals_of(self, name: str) -> tuple:
        totals = self._totals[name] = (
            self._registry.counter(
                "trace_span_seconds_total",
                "seconds inside complete spans, by span name", span=name),
            self._registry.counter(
                "trace_span_self_seconds_total",
                "seconds inside complete spans less their child spans on "
                "the same track, by span name", span=name),
            self._registry.counter(
                "trace_spans_total", "complete spans ended, by span name",
                span=name))
        return totals

    def bind_metrics(self, registry) -> None:
        """Keep the span totals in `registry` from now on, carrying over
        what they hold (a disabled registry binds nothing)."""
        if not registry.enabled or registry is self._registry:
            return
        old, self._totals = self._totals, {}
        self._registry = registry
        for name, counters in old.items():
            for was, now in zip(counters, self._totals_of(name)):
                now.inc(was.value)

    # ---- complete spans ----
    def begin(self, name: str, cat: str = "", tid: int = 0, **args) -> Span:
        stack = self._stacks.setdefault(tid, [])
        tok = Span(name, cat, tid, self._now_us(), args, len(stack))
        stack.append(tok)
        return tok

    def end(self, tok: Span):
        stack = self._stacks.get(tok.tid)
        assert stack and stack[-1] is tok, (
            f"span end out of order on track {tok.tid}: ending "
            f"{tok.name!r} but "
            f"{stack[-1].name if stack else '<empty>'!r} is open")
        stack.pop()
        dur = self._now_us() - tok.ts
        if stack:
            stack[-1].child += dur
        total, own, count = (self._totals.get(tok.name)
                             or self._totals_of(tok.name))
        total.inc(1e-6 * dur)
        own.inc(1e-6 * (dur - tok.child))
        count.inc()
        self._push({
            "ph": "X", "name": tok.name, "cat": tok.cat, "pid": self.pid,
            "tid": tok.tid, "ts": tok.ts, "dur": dur, "args": tok.args})

    def span(self, name: str, cat: str = "", tid: int = 0,
             **args) -> _SpanCtx:
        return _SpanCtx(self, name, cat, tid, args)

    def open_depth(self, tid: int = 0) -> int:
        """How many spans are currently open on a track (tests)."""
        return len(self._stacks.get(tid, ()))

    # ---- instants ----
    def instant(self, name: str, cat: str = "", tid: int = 0, **args):
        self._push({
            "ph": "i", "s": "t", "name": name, "cat": cat, "pid": self.pid,
            "tid": tid, "ts": self._now_us(), "args": args})

    # ---- async spans (request lifecycles spanning many ticks) ----
    def async_begin(self, name: str, aid, cat: str = "", tid: int = 0,
                    **args):
        self._push({
            "ph": "b", "id": int(aid), "name": name, "cat": cat,
            "pid": self.pid, "tid": tid, "ts": self._now_us(),
            "args": args})

    def async_end(self, name: str, aid, cat: str = "", tid: int = 0,
                  **args):
        self._push({
            "ph": "e", "id": int(aid), "name": name, "cat": cat,
            "pid": self.pid, "tid": tid, "ts": self._now_us(),
            "args": args})

    # ---- read-out ----
    def events(self) -> list[dict]:
        """Retained events, oldest first (metadata excluded)."""
        if self._n <= self.capacity:
            return [e for e in self._ring[: self._n]]
        cut = self._n % self.capacity
        return self._ring[cut:] + self._ring[:cut]

    def clear(self):
        self._ring = [None] * self.capacity
        self._n = 0
        self._stacks.clear()

    def export(self, path=None) -> dict:
        """Chrome-trace JSON: ``{"traceEvents": [...]}``.  Open the file
        (or a json.dump of the returned dict) at https://ui.perfetto.dev
        or chrome://tracing.  With ``path`` the JSON is also written
        there."""
        events = []
        for ev in self._meta + self.events():
            ev = dict(ev)
            if ev.get("args"):
                ev["args"] = {k: _jsonable(v) for k, v in ev["args"].items()}
            events.append(ev)
        out = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(out, f)
        return out


class _NullSpanCtx:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        pass


_NULL_SPAN_CTX = _NullSpanCtx()


class NullTracer:
    """The disabled path: the Tracer surface with every method a no-op.
    Layers hold one of these (the shared NULL_TRACER) when tracing is
    off, so instrumentation sites stay unconditional and the per-
    superstep cost is a handful of attribute lookups."""

    enabled = False
    capacity = 0
    dropped = 0

    def track(self, name: str) -> int:
        return 0

    def bind_metrics(self, registry) -> None:
        pass

    def begin(self, name, cat="", tid=0, **args):
        return None

    def end(self, tok):
        pass

    def span(self, name, cat="", tid=0, **args) -> _NullSpanCtx:
        return _NULL_SPAN_CTX

    def open_depth(self, tid: int = 0) -> int:
        return 0

    def instant(self, name, cat="", tid=0, **args):
        pass

    def async_begin(self, name, aid, cat="", tid=0, **args):
        pass

    def async_end(self, name, aid, cat="", tid=0, **args):
        pass

    def events(self) -> list:
        return []

    def clear(self):
        pass

    def export(self, path=None) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}


NULL_TRACER = NullTracer()
