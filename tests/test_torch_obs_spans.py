"""The tracer's span totals and the serving pool's spans (repro_torch.obs,
repro_torch.service.pool).

  * self time and total time under an injected clock, over two tracks
    and three levels of nesting; the totals outlive the ring's drops and
    carry over when the tracer is bound to a registry;
  * the three counters bind_metrics gives, and how render() shows them;
  * the disabled path (NULL_TRACER, NULL_REGISTRY) stays inert;
  * SearchClient(trace=True, metrics=True) over BanditTreeEnv on the
    phase path (re-root and flush) and on the fused K>1 path with expand
    escapes (alone, over overlapped gangs and over shards): every pool
    span appears, one `commit` span per committed
    move, the commit's pieces nest inside a `commit`, and the moves and
    visits are those of the same run untraced.

Everything runs on the CPU.
"""

import numpy as np
import pytest

from repro_torch.core import TreeConfig
from repro_torch.envs import BanditTreeEnv, BanditValueBackend
from repro_torch.obs import (
    NULL_REGISTRY, NULL_TRACER, MetricsRegistry, NullTracer, Tracer,
)
from repro_torch.service import SearchClient, SearchRequest

TOTALS = ("trace_span_seconds_total", "trace_span_self_seconds_total",
          "trace_spans_total")


class Clock:
    """A nanosecond clock the test sets by hand (in microseconds)."""

    def __init__(self):
        self.us = 0

    def __call__(self) -> int:
        return self.us * 1000

    def at(self, us: int) -> "Clock":
        self.us = us
        return self


def totals(reg, span: str) -> tuple:
    return tuple(reg.get(name, span=span).value for name in TOTALS)


def nested_run(tracer: Tracer, clock: Clock) -> None:
    """Track A: outer [0, 100] > mid [10, 70] > inner [20, 50], and a
    second inner [75, 85] right under outer.  Track B, interleaved in
    time: other [5, 95] > inner [30, 40]."""
    a, b = tracer.track("A"), tracer.track("B")
    outer = tracer.begin("outer", tid=a)
    clock.at(5)
    other = tracer.begin("other", tid=b)
    clock.at(10)
    mid = tracer.begin("mid", tid=a)
    clock.at(20)
    inner = tracer.begin("inner", tid=a)
    clock.at(30)
    inner_b = tracer.begin("inner", tid=b)
    clock.at(40)
    tracer.end(inner_b)
    clock.at(50)
    tracer.end(inner)
    clock.at(70)
    tracer.end(mid)
    clock.at(75)
    with tracer.span("inner", tid=a):
        clock.at(85)
    clock.at(95)
    tracer.end(other)
    clock.at(100)
    tracer.end(outer)


def test_self_and_total_time_over_two_tracks_and_three_levels():
    clock = Clock()
    tracer = Tracer(clock_ns=clock)
    reg = MetricsRegistry()
    tracer.bind_metrics(reg)
    nested_run(tracer, clock)
    want = {   # (total, self) microseconds, count
        "outer": (100, 100 - 60 - 10, 1),
        "mid": (60, 60 - 30, 1),
        "inner": (30 + 10 + 10, 30 + 10 + 10, 3),
        "other": (90, 90 - 10, 1),
    }
    for name, (total, own, n) in want.items():
        got = totals(reg, name)
        assert got[0] == pytest.approx(1e-6 * total, abs=1e-12), name
        assert got[1] == pytest.approx(1e-6 * own, abs=1e-12), name
        assert got[2] == n, name
    # the ring keeps the same spans the totals count
    durs = {}
    for ev in tracer.events():
        durs[ev["name"]] = durs.get(ev["name"], 0) + ev["dur"]
    assert durs == pytest.approx({k: v[0] for k, v in want.items()})


def test_totals_outlive_drops_and_carry_over_when_bound():
    clock = Clock()
    tracer = Tracer(capacity=2, clock_ns=clock)
    for i in range(5):
        with tracer.span("step"):
            clock.at(clock.us + 3)
        tracer.instant("tick")
        tracer.async_begin("request", i)
    assert tracer.dropped > 0
    reg = MetricsRegistry()
    tracer.bind_metrics(reg)
    assert totals(reg, "step") == pytest.approx((15e-6, 15e-6, 5))
    with tracer.span("step"):
        clock.at(clock.us + 3)
    assert totals(reg, "step") == pytest.approx((18e-6, 18e-6, 6))
    # instants and async spans are not counted
    assert set(reg.snapshot()) == set(TOTALS)
    assert all(c.labels == {"span": "step"}
               for name in TOTALS for c in reg._metrics[name].values())


def test_bound_counters_render():
    clock = Clock()
    tracer = Tracer(clock_ns=clock)
    reg = MetricsRegistry()
    tracer.bind_metrics(reg)
    nested_run(tracer, clock)
    text = reg.render()
    for name in TOTALS:
        assert f"# TYPE {name} counter" in text
        assert f"# HELP {name} " in text
    assert 'trace_spans_total{span="inner"} 3' in text
    assert 'trace_span_seconds_total{span="outer"} 0.0001' in text
    assert 'trace_span_self_seconds_total{span="mid"} 3e-05' in text


def test_null_tracer_and_null_registry_stay_inert():
    reg = MetricsRegistry()
    NULL_TRACER.bind_metrics(reg)
    assert isinstance(NULL_TRACER, NullTracer) and not NULL_TRACER.enabled
    with NULL_TRACER.span("x"):
        NULL_TRACER.end(NULL_TRACER.begin("y"))
    assert reg.snapshot() == {} and NULL_TRACER.events() == []
    # a tracer bound to the disabled registry keeps its totals itself
    clock = Clock()
    tracer = Tracer(clock_ns=clock)
    tracer.bind_metrics(NULL_REGISTRY)
    with tracer.span("x"):
        clock.at(7)
    assert NULL_REGISTRY.snapshot() == {}
    tracer.bind_metrics(reg)
    assert totals(reg, "x") == pytest.approx((7e-6, 7e-6, 1))


# ---------------------------------------------------------------------------
# the serving pool's spans
# ---------------------------------------------------------------------------

class PartialEnv(BanditTreeEnv):
    """The device twin refuses transitions from depth >= 2: fused
    dispatches then escape to the host for expansion now and then."""

    def resolvable_device(self, states, actions):
        return states[..., 0] < 2


COMMIT_PARTS = {"snapshot", "reroot", "st-write", "write-back"}
PHASE_SPANS = {"admission", "commits", "commit", "finalize-build"}
FUSED_SPANS = {"fused-dispatch", "fused-submit", "fused-collect",
               "fused-finish", "simulate", "expand"}
RUNS = {   # name: (env class, client options, spans it must show)
    "phase": (BanditTreeEnv, dict(), PHASE_SPANS | COMMIT_PARTS),
    "phase-flush": (BanditTreeEnv, dict(reuse_subtree=False),
                    PHASE_SPANS | COMMIT_PARTS - {"reroot"}),
    "fused": (PartialEnv, dict(supersteps_per_dispatch=4),
              PHASE_SPANS | COMMIT_PARTS | FUSED_SPANS),
    "fused-overlap": (PartialEnv, dict(supersteps_per_dispatch=4,
                                       overlap=True, n_gangs=2),
                      PHASE_SPANS | COMMIT_PARTS | FUSED_SPANS),
    "fused-sharded": (PartialEnv, dict(supersteps_per_dispatch=4,
                                       n_shards=3),
                      PHASE_SPANS | COMMIT_PARTS | FUSED_SPANS),
}


def serve(run: str, traced: bool):
    env_cls, kw, _ = RUNS[run]
    cl = SearchClient(env_cls(fanout=4, terminal_depth=10),
                      BanditValueBackend(), G=3, p=4, executor="faithful",
                      device="cpu", default_cfg=TreeConfig(X=160, F=4, D=6),
                      trace=traced, metrics=traced, **kw)
    try:
        handles = [cl.submit(SearchRequest(uid=i, seed=30 + i,
                                           budget=3 + i % 4, moves=2 + i % 3))
                   for i in range(7)]
        results = {h.uid: h.result() for h in handles}
        return cl, results
    finally:
        cl.close()


@pytest.mark.parametrize("run", list(RUNS))
def test_client_run_shows_the_pool_spans(run):
    cl, got = serve(run, traced=True)
    _, want = serve(run, traced=False)
    for uid, res in want.items():
        assert got[uid].actions == res.actions, uid
        assert got[uid].supersteps == res.supersteps, uid
        for a, b in zip(got[uid].visit_counts, res.visit_counts):
            np.testing.assert_array_equal(a, b)
    events = [e for e in cl.tracer.events() if e.get("ph") == "X"]
    names = {e["name"] for e in events}
    missing = RUNS[run][2] - names
    assert not missing, missing
    if run.startswith("fused"):
        assert cl.stats.fused_escape_expand > 0
    moves = sum(len(r.actions) for r in got.values())
    reg = cl.registry
    assert reg.get("trace_spans_total", span="commit").value == moves
    for name in names:
        total, own, n = totals(reg, name)
        assert n == sum(e["name"] == name for e in events), name
        assert 0 <= own <= total + 1e-12, name
    commits = [e for e in events if e["name"] == "commit"]
    for e in events:
        if e["name"] in COMMIT_PARTS:
            assert any(c["tid"] == e["tid"] and c["ts"] <= e["ts"]
                       and e["ts"] + e["dur"] <= c["ts"] + c["dur"] + 1e-6
                       for c in commits), e
    assert 'trace_spans_total{span="commit"}' in cl.metrics()
