"""SearchClient — opaque request handles over the global scheduler.

The port of repro.service.client: the serving entry point of
repro_torch.  It runs on CUDA with the hand-written tree kernels
(executor="cuda") unless the caller passes another `device` / `executor`,
and raises when there is no card and no ``device="cpu"``.

The public serving API.  The paper's CPU workers interact with the FPGA
accelerator through a narrow request/response interface and never touch
tree internals; this module gives the serving stack the same shape: a
caller submits a SearchRequest and gets back a SearchHandle — never a
pool, never an arena — and drives progress with poll()/run_until()
instead of draining a run() loop to completion.

  client = SearchClient(env, sim, G=8, p=8, policy="weighted-queue-depth")
                                  # device="cpu" runs the plain torch ops
  h = client.submit(SearchRequest(uid=0, seed=0, budget=8, moves=4,
                                  cfg=my_cfg),
                    priority=1, deadline_supersteps=64)
  for ev in h.moves():            # streamed per-move events, as each
      print(ev.action)            # reroot commits — no terminal drain
  result = h.result()             # the terminal SearchResult (same data)

Handles:
  done()    — has the request's SearchResult been emitted (completion,
              cancel, or deadline eviction)?
  result()  — the SearchResult; with wait=True (default) the client is
              polled until it exists.
  cancel()  — evict the request now (queued or mid-flight); the partial
              result keeps any committed moves.  False once completed.
  moves()   — generator of MoveEvents in commit order, bit-identical to
              the terminal result's action/visit-distribution trace; it
              polls the scheduler lazily while the request is live, so
              iterating IS serving.

The client itself is a thin veneer: routing, policies, cross-bucket
admission, deadline eviction, cold-pool retirement and the cross-pool
fused Simulation batch all live in scheduler_core.SchedulerCore; the
superstep body lives in pool.ArenaPool.  ServiceFrontend and
SearchService remain as compatibility adapters over this stack.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Union

from repro_torch.core.mcts import Environment, SimulationBackend
from repro_torch.core.tree import TreeConfig
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.service.pool import MoveEvent, SearchRequest, SearchResult
from repro_torch.service.scheduler_core import SchedulePolicy, SchedulerCore

__all__ = ["SearchClient", "SearchHandle"]


class SearchHandle:
    """Opaque handle to one submitted search.  Everything a caller may do
    with an in-flight request goes through here — tree slots, arenas and
    pools stay scheduler-internal."""

    def __init__(self, client: "SearchClient", uid: int, key: tuple):
        self._client = client
        self.uid = uid
        self._key = key          # bucket key (routing detail; not API)

    def __repr__(self):
        return f"SearchHandle(uid={self.uid}, status={self.status()!r})"

    # ---- state ----
    def done(self) -> bool:
        """True once the terminal SearchResult exists — by completion,
        cancel() or deadline eviction — even if the result has since
        been dropped by the retired-pool result TTL (status "expired")."""
        core = self._client.core
        return self.uid in core.results or self.uid in core.expired_uids

    def status(self) -> str:
        """'queued' | 'active' | 'done' | 'cancelled' | 'evicted' |
        'expired' (result dropped by the retired-pool TTL)."""
        res = self._client.core.results.get(self.uid)
        if res is not None:
            if res.deadline_evicted:
                return "evicted"
            if res.cancelled:
                return "cancelled"
            return "done"
        if self.uid in self._client.core.expired_uids:
            return "expired"
        pool = self._client.core.pools.get(self._key)
        # holds() is retired-safe: a retired pool's slot list is released
        # with its arena, so probing pool.slots directly here would read
        # freed state on a pool awaiting resurrection
        if pool is not None and pool.holds(self.uid):
            return "active"
        return "queued"

    # ---- terminal result ----
    def result(self, wait: bool = True,
               max_ticks: int = 100_000) -> SearchResult:
        """The request's SearchResult.  With wait=True the client is
        polled until the result exists; raises RuntimeError if the
        scheduler drains without producing it (never happens for a
        submitted uid unless max_ticks is exhausted).  `max_ticks`
        bounds the CLOCK, not poll() calls."""
        core = self._client.core
        start = core.ticks
        while (wait and self.uid not in core.results
               and core.ticks - start < max_ticks):
            if not self._client.poll(1):
                break
        if wait and self.uid not in core.results:
            # clock budget spent (or drained) with an overlap gang
            # possibly still in flight: finish it without advancing the
            # clock — its commits may be this request's result
            core.drain_inflight()
        res = core.results.get(self.uid)
        if res is None:
            if self.uid in core.expired_uids:
                raise RuntimeError(
                    f"request uid={self.uid} result expired: it outlived "
                    f"result_ttl_ticks={core.result_ttl_ticks} on a "
                    f"retired pool and was dropped")
            raise RuntimeError(
                f"request uid={self.uid} has no result yet "
                f"(status={self.status()!r}); poll() the client or call "
                f"result(wait=True)")
        return res

    def cancel(self) -> bool:
        """Evict the request now.  The emitted result keeps any committed
        moves and is flagged cancelled; False once already completed."""
        return self._client.core.cancel(self.uid, self._key)

    # ---- streaming ----
    def moves(self) -> Iterator[MoveEvent]:
        """Yield MoveEvents in commit order, polling the scheduler lazily
        while the request is live — the streamed trace is bit-identical
        to the terminal result's actions/visit_counts (pinned in
        tests/test_client.py).  Iteration ends when the request's last
        move commits, or early when it is cancelled/evicted or the
        scheduler drains."""
        core = self._client.core
        emitted = 0
        live = True
        log = None
        while live:
            # a final flush still runs after done()/drain ends the loop
            live = not self.done() and self._client.poll(1) > 0
            # hold the FIRST list object resolved for this uid: the pool
            # listener appends to it in place, while the retired-pool
            # result TTL may pop the dict entry mid-iteration — re-fetching
            # would then silently truncate the tail of the stream
            if log is None:
                log = core.move_log.get(self.uid)
            cur = () if log is None else log
            while emitted < len(cur):
                yield cur[emitted]
                emitted += 1


class SearchClient:
    """Submit searches, get handles, drive progress — the one public
    entry point of the serving stack.

    Construction mirrors the historical frontends (env + sim + G slots x
    p workers per bucket, executor/compaction/expansion knobs) and adds
    the scheduler levers: `policy` (round-robin | weighted-queue-depth |
    deadline-aware, or a SchedulePolicy instance), `fuse_across_pools`
    (one evaluate() batch spanning every advancing pool on gang ticks;
    default: whenever the policy gangs), and `retire_after_ticks` (cold
    pools release their arena after this many idle global ticks and are
    resurrected on demand).

    Observability: `trace=True` (or a Tracer instance) records phase and
    request-lifecycle spans, exported with `trace_export()` as
    Chrome-trace JSON for ui.perfetto.dev; `metrics=True` (or a
    MetricsRegistry) collects scheduler/pool telemetry rendered by
    `metrics()` in Prometheus exposition format.  `result_ttl_ticks`
    drops completed results of retired pools after that many global
    ticks (their handles report status "expired").  All three are off by
    default; traced runs are bit-identical to untraced ones
    (tests/test_torch_service.py).

    Fused dispatch: `supersteps_per_dispatch=K > 1` runs each pool's
    supersteps K at a time on the device (core.fused; on the ``cuda``
    executor, replays of one captured CUDA graph of the superstep body)
    when its env and sim backend have device twins, escaping to the host
    at move commits and unresolvable expansions; per-request results are
    unchanged, and the clock advances by the supersteps a tick ran.

    Multi-device serving: `n_shards=D` partitions every bucket's G slots
    into D per-device shard arenas (G must be a multiple of D); each
    admission lands on the least-loaded shard and runs there, while
    results stay bit-identical to n_shards=1 for every request.
    `shard_devices` pins the shard->device map (default:
    launch.mesh.serving_devices, ``cuda:(d % device_count)``).

    Overlap serving: `overlap=True` pipelines each pool's supersteps over
    `n_gangs` double-buffered slot gangs — one gang's host expansion and
    simulation run while another's device phases are queued (service.pool,
    "Overlap mode").  Per-request results are unchanged; clock-budget
    exits (result/run_until/drain) finish any in-flight gang without
    advancing the clock past the budget.  Incompatible with
    `compact_threshold > 0`.
    """

    def __init__(
        self,
        env: Environment,
        sim: Optional[SimulationBackend] = None,
        G: int = 4,
        p: int = 8,
        executor: str = "cuda",
        default_cfg: Optional[TreeConfig] = None,
        policy: Union[str, SchedulePolicy] = "round-robin",
        fuse_across_pools: Optional[bool] = None,
        retire_after_ticks: Optional[int] = None,
        alternating_signs: bool = False,
        reuse_subtree: bool = True,
        compact_threshold: float = 0.0,
        compact_exit_threshold: Optional[float] = None,
        persistent_compaction: bool = True,
        expansion: str = "loop",
        pool_workers: int = 2,
        supersteps_per_dispatch: int = 1,
        trace: Union[bool, Tracer] = False,
        metrics: Union[bool, MetricsRegistry] = False,
        trace_capacity: int = 1 << 16,
        result_ttl_ticks: Optional[int] = None,
        n_shards: int = 1,
        shard_devices: Optional[list] = None,
        overlap: bool = False,
        n_gangs: int = 2,
        sim_backend: Optional[SimulationBackend] = None,
        device=None,
    ):
        # `sim_backend` is the serving-subsystem spelling (for example
        # repro_torch.sim.LMContinuationBackend); `sim` the historical
        # positional.  One of them, never both.
        if sim_backend is not None:
            if sim is not None:
                raise ValueError(
                    "pass the simulation backend as `sim` OR "
                    "`sim_backend`, not both")
            sim = sim_backend
        if sim is None:
            raise ValueError("SearchClient needs a simulation backend: "
                             "pass `sim` or `sim_backend`")
        self.tracer: Optional[Tracer] = (
            trace if isinstance(trace, Tracer)
            else Tracer(capacity=trace_capacity) if trace else None)
        self.registry: Optional[MetricsRegistry] = (
            metrics if isinstance(metrics, MetricsRegistry)
            else MetricsRegistry() if metrics else None)
        # serving backends carry their own telemetry (sim_server_*,
        # sim_cache_*, serving_*), and the tracer its span totals
        # (trace_span_*): rebind them onto this client's registry so
        # metrics() renders one coherent snapshot
        # the LM path's env and backend keep spans and counters of their
        # own (sim.lm): they join the client's tracer and registry too
        for part, bind, on in ((sim, "bind_metrics", self.registry),
                               (env, "bind_metrics", self.registry),
                               (sim, "bind_tracer", self.tracer),
                               (env, "bind_tracer", self.tracer)):
            if on is not None and hasattr(part, bind):
                getattr(part, bind)(on)
        if self.registry is not None and self.tracer is not None:
            self.tracer.bind_metrics(self.registry)
        self.core = SchedulerCore(
            env, sim, G, p, executor=executor, default_cfg=default_cfg,
            policy=policy, fuse_across_pools=fuse_across_pools,
            retire_after_ticks=retire_after_ticks,
            alternating_signs=alternating_signs,
            reuse_subtree=reuse_subtree,
            compact_threshold=compact_threshold,
            compact_exit_threshold=compact_exit_threshold,
            persistent_compaction=persistent_compaction,
            expansion=expansion, pool_workers=pool_workers,
            supersteps_per_dispatch=supersteps_per_dispatch,
            tracer=self.tracer, metrics=self.registry,
            result_ttl_ticks=result_ttl_ticks,
            n_shards=n_shards, shard_devices=shard_devices,
            overlap=overlap, n_gangs=n_gangs, device=device)
        self._handles: dict[int, SearchHandle] = {}

    # ---- submission ----
    def submit(self, req: SearchRequest, priority: Optional[int] = None,
               deadline_supersteps: Optional[int] = None) -> SearchHandle:
        """Queue a search and return its handle.  `priority` and
        `deadline_supersteps` override the request's own fields when
        given (higher priority admits first; the deadline is a global-
        tick budget after which the scheduler evicts the request with
        whatever moves it committed)."""
        if priority is not None:
            req.priority = int(priority)
        if deadline_supersteps is not None:
            req.deadline_supersteps = int(deadline_supersteps)
        _, key = self.core.submit(req)
        handle = SearchHandle(self, req.uid, key)
        self._handles[req.uid] = handle
        return handle

    def handle(self, uid: int) -> SearchHandle:
        return self._handles[uid]

    # ---- progress ----
    def poll(self, budget: int = 1) -> int:
        """Advance up to `budget` scheduler ticks; returns how many did
        work (0 = fully drained).  The non-blocking replacement for the
        old drain-only run()."""
        n = 0
        for _ in range(max(0, int(budget))):
            if not self.core.tick():
                break
            n += 1
        return n

    def run_until(self, pred: Callable[["SearchClient"], bool],
                  max_ticks: int = 100_000) -> bool:
        """Tick until `pred(client)` holds (True) or the scheduler drains
        / max_ticks pass without it (returns pred's final value).  Like
        result(), the bound is against the clock."""
        start = self.core.ticks
        while not pred(self):
            if (self.core.ticks - start >= max_ticks
                    or not self.core.tick()):
                # budget/drain exit: complete any in-flight overlap gang
                # (no clock advance) before the final predicate check
                self.core.drain_inflight()
                return bool(pred(self))
        return True

    def drain(self, max_ticks: int = 100_000) -> list[SearchResult]:
        """Run every queued/in-flight request to its terminal result and
        return them all (submission-bucket order) — the compatibility
        path the frontend adapters drain through."""
        return self.core.run(max_ticks)

    # ---- views ----
    @property
    def stats(self):
        return self.core.stats

    def pool_summaries(self) -> list[dict]:
        return self.core.pool_summaries()

    # ---- observability ----
    def metrics(self) -> str:
        """One Prometheus-exposition-format snapshot of every metric, or
        "" when the client was built without `metrics=True`."""
        return "" if self.registry is None else self.registry.render()

    def trace_export(self, path=None) -> dict:
        """The recorded trace as Chrome-trace JSON (open at
        https://ui.perfetto.dev); with `path` the JSON is also written
        there.  Requires `trace=True` (or a Tracer) at construction."""
        if self.tracer is None:
            raise RuntimeError(
                "tracing is off: build the client with trace=True (or "
                "pass a repro_torch.obs.Tracer) to record spans")
        return self.tracer.export(path)

    def close(self):
        self.core.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
