"""SchedulerCore — global cross-pool scheduling behind the SearchClient.

The port of repro.service.scheduler_core.

Mirsoleimani et al.'s *Structured Parallel Programming for MCTS* argues
the scheduler, not the tree ops, should own parallel structure; the
paper's own CPU workers talk to the accelerator through a narrow
request/response interface and never see tree internals.  This module is
that split made literal for the serving layer: ArenaPool owns one shape
class's BSP superstep body, and everything that spans buckets lives here

  * routing      — requests are bucketed by shape class
                   (core.tree.bucket_key: exact X/D/semantics, fanout
                   padded to the shared Fp lane width) into lazily
                   created ArenaPools, all sharing ONE host-expansion
                   engine;
  * admission    — a pluggable SchedulePolicy decides which pools advance
                   each global tick and how many slots each bucket may
                   fill (per-bucket G sizing from queue depth — the
                   cross-bucket fairness lever the ROADMAP named);
  * simulation   — sim-state shapes are env-, not config-, dependent, so
                   a gang tick concatenates every advancing pool's
                   pending rows into ONE SimulationBackend.evaluate call
                   and splits the results back per pool (the cross-pool
                   fusion that used to stop at pool boundaries);
  * deadlines    — requests carrying deadline_supersteps are evicted (via
                   ArenaPool.cancel) at the first tick past their budget,
                   keeping whatever moves they committed;
  * retirement   — a pool idle for `retire_after_ticks` global ticks
                   closes its CompactionSession and releases its arena
                   (executor.release()); the next submit to its bucket
                   resurrects it.  Bounds arena memory under config churn.

Policies:

  round-robin          — one pool per tick, rotating: bit-identical to
                         the historical ServiceFrontend loop (the
                         compatibility default).
  weighted-queue-depth — a gang tick: every pool with work advances,
                         deepest queue first, with per-bucket admission
                         caps proportional to queue-depth share; the
                         cross-pool fused evaluate batch comes from here.
  deadline-aware       — the pool holding the most urgent deadline
                         advances first each tick, and its admission
                         order prefers earlier deadlines within a
                         priority class.

Scheduling never changes what a request computes — per-slot tree
evolution is schedule-independent (tests/test_executor_matrix.py), so
every policy, fused or not, returns bit-identical per-request results;
policies only move WHEN work happens (fairness, deadlines, batch shape).

Multi-device serving: with ``n_shards=D`` every pool partitions its G
slots into D per-device shard arenas (core/sharded.py) and the POOL does
cross-device placement (ArenaPool._place_slot: the least-loaded enabled
shard).  The core stays device-agnostic: cross-pool fused evaluate
batching, the policies, deadlines and retirement all operate on whole
pools, and the clock advances by the deepest fused dispatch — the max
over per-shard dispatches.

Overlap serving: with ``overlap=True`` every pool pipelines its
supersteps over ``n_gangs`` double-buffered gangs (service.pool,
"Overlap mode"); tick() is unchanged, and a clock-budget exit calls
``drain_inflight`` so that no gang stays in flight past the budget.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Union

import numpy as np

from repro_torch.core.expand import ExpansionEngine
from repro_torch.core.mcts import Environment, SimulationBackend
from repro_torch.core.tree import (
    TreeConfig, bucket_key, canonical_config, resolve_device,
)
from repro_torch.envs.device import has_async_sim
from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.service.pool import (
    ArenaPool, MoveEvent, SearchRequest, SearchResult, ServiceStats,
    bucket_label,
)

__all__ = [
    "POLICY_NAMES", "SchedulePolicy", "RoundRobinPolicy",
    "WeightedQueueDepthPolicy", "DeadlineAwarePolicy", "SchedulerCore",
    "make_policy",
]


def _depth(pool: ArenaPool) -> int:
    """A pool's backlog: queued plus in-flight requests."""
    return len(pool.queue) + pool.load()


class SchedulePolicy:
    """Which pools advance on a tick, in what order, and how many slots
    each may fill.  Stateless except where noted; one instance serves one
    SchedulerCore (round-robin keeps a cursor)."""

    name = "base"
    #: gang=False advances the FIRST pool in `order` that yields work
    #: (one superstep per tick — the historical frontend cadence);
    #: gang=True advances EVERY pool with work in one tick, which is what
    #: the cross-pool fused evaluate batches over.
    gang = False
    #: pools admit earliest-deadline-first within a priority class
    deadline_first = False

    def order(self, core: "SchedulerCore") -> list:
        """Bucket keys in the order the core should try them this tick."""
        return list(core._order)

    def admit_limits(self, core: "SchedulerCore") -> dict:
        """Per-bucket active-slot caps ({} = every pool may fill to G)."""
        return {}

    def advanced(self, core: "SchedulerCore", key) -> None:
        """Notification that `key`'s pool advanced this tick."""


class RoundRobinPolicy(SchedulePolicy):
    """One pool per tick, rotating — today's ServiceFrontend behavior."""

    name = "round-robin"

    def __init__(self):
        self._rr = 0

    def order(self, core):
        n = len(core._order)
        return [core._order[(self._rr + i) % n] for i in range(n)]

    def advanced(self, core, key):
        self._rr = (core._order.index(key) + 1) % len(core._order)


class WeightedQueueDepthPolicy(SchedulePolicy):
    """Gang tick, deepest backlog first, admission caps proportional to
    queue-depth share (per-bucket G sizing: a bucket with 80% of the
    backlog may fill 80% of its slots; every bucket keeps at least 1).

    The share is computed on EWMA-smoothed depths, not instantaneous
    ones: a one-tick burst into one bucket no longer slams every other
    bucket's cap to 1 and back (the carried-forward ROADMAP limit).
    ``ewma_alpha`` is the usual smoothing weight on the newest sample —
    1.0 recovers the unsmoothed behavior.  A bucket's EWMA is seeded
    with its first observed depth, so the first tick a bucket has work
    behaves exactly as before smoothing existed.  The smoothed load is
    exported per bucket as the `service_smoothed_load` gauge.

    ``fairness_floor`` hardens the "every bucket keeps at least 1"
    guarantee into at least one ADMISSION: a share-of-backlog cap of 1
    is satisfied by a bucket's single long-running active request, so
    its queued requests could starve behind a bucket that dominates the
    depth share.  With the floor on, any bucket with queued work gets a
    cap of at least ``min(G, load + 1)`` — room for one fresh admission
    per gang tick, regardless of share."""

    name = "weighted-queue-depth"
    gang = True

    def __init__(self, ewma_alpha: float = 0.5,
                 fairness_floor: bool = True):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1]: {ewma_alpha}")
        self.ewma_alpha = ewma_alpha
        self.fairness_floor = fairness_floor
        self._ewma: dict = {}
        self._last_tick = None

    def order(self, core):
        keys = [k for k in core._order if core.pools[k].has_work()]
        return sorted(
            keys, key=lambda k: (-_depth(core.pools[k]),
                                 core._order.index(k)))

    def _smoothed_depths(self, core) -> dict:
        """EWMA over each with-work bucket's backlog, advanced at most
        once per core tick (admit_limits may be probed more often).

        Entries for buckets with no work — drained or retired — are
        PRUNED, not kept: a retired bucket that resurrects later must
        reseed its EWMA from its fresh backlog, or the stale smoothed
        depth from its previous life would skew every bucket's
        admission share for ticks after resurrection."""
        depths = {k: _depth(core.pools[k]) for k in core._order
                  if core.pools[k].has_work()}
        if core.ticks != self._last_tick:
            self._last_tick = core.ticks
            a = self.ewma_alpha
            reg = getattr(core, "registry", NULL_REGISTRY)
            for k in [k for k in self._ewma if k not in depths]:
                del self._ewma[k]
            for k, d in depths.items():
                prev = self._ewma.get(k)
                self._ewma[k] = d if prev is None else a * d + (1 - a) * prev
                reg.gauge(
                    "service_smoothed_load",
                    "EWMA-smoothed backlog (queued + in-flight) per bucket",
                    bucket=bucket_label(core.pools[k].cfg),
                ).set(round(self._ewma[k], 4))
        return {k: self._ewma[k] for k in depths}

    def admit_limits(self, core):
        depths = self._smoothed_depths(core)
        total = sum(depths.values())
        if total == 0:
            return {}
        caps = {k: max(1, min(core.pools[k].G,
                              math.ceil(core.pools[k].G * d / total)))
                for k, d in depths.items()}
        if self.fairness_floor:
            for k in caps:
                pool = core.pools[k]
                if pool.queue:
                    caps[k] = max(caps[k], min(pool.G, pool.load() + 1))
        return caps


class DeadlineAwarePolicy(SchedulePolicy):
    """The pool holding the most urgent deadline advances first; its
    admission prefers earlier deadlines within a priority class.  Pools
    with no deadlines fall back to backlog order."""

    name = "deadline-aware"
    deadline_first = True

    def _slack(self, core, key) -> float:
        # deadline_ticks() is retired-safe: a retired pool's slot list
        # is released with its arena, so probing pool.slots here would
        # read freed state (queued deadlines still count — queued work
        # on a retired pool is what triggers resurrection)
        deadlines = core.pools[key].deadline_ticks()
        return (min(deadlines) - core.ticks) if deadlines else math.inf

    def order(self, core):
        keys = [k for k in core._order if core.pools[k].has_work()]
        return sorted(
            keys, key=lambda k: (self._slack(core, k),
                                 -_depth(core.pools[k]),
                                 core._order.index(k)))


POLICY_NAMES = ("round-robin", "weighted-queue-depth", "deadline-aware")

_POLICIES = {
    "round-robin": RoundRobinPolicy,
    "weighted-queue-depth": WeightedQueueDepthPolicy,
    "deadline-aware": DeadlineAwarePolicy,
}


def make_policy(policy: Union[str, SchedulePolicy]) -> SchedulePolicy:
    if isinstance(policy, SchedulePolicy):
        return policy
    if policy not in _POLICIES:
        raise ValueError(f"unknown schedule policy {policy!r}: one of "
                         f"{POLICY_NAMES} (or a SchedulePolicy instance)")
    return _POLICIES[policy]()


class SchedulerCore:
    """Config-bucketed arena pools under one global tick clock.

    The engine room of SearchClient (and, through it, the ServiceFrontend
    / SearchService compatibility adapters).  Owns the pools dict, the
    policy, the deadline ledger, cold-pool retirement, and the cross-pool
    fused Simulation batch.
    """

    def __init__(
        self,
        env: Environment,
        sim: SimulationBackend,
        G: int,
        p: int,
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
        tracer=None,
        metrics=None,
        result_ttl_ticks: Optional[int] = None,
        n_shards: int = 1,
        shard_devices: Optional[list] = None,
        overlap: bool = False,
        n_gangs: int = 2,
        device=None,
    ):
        self.env, self.sim = env, sim
        self.G, self.p = G, p
        self.executor = executor
        self.device = resolve_device(device)
        self.default_cfg = default_cfg
        self.policy = make_policy(policy)
        # observability: the scheduler claims trace track 0; each pool
        # gets its own track as it is created (pool.py).  No-op defaults.
        self.trace = NULL_TRACER if tracer is None else tracer
        self.registry = NULL_REGISTRY if metrics is None else metrics
        self._track = self.trace.track("scheduler")
        self._m_ticks = self.registry.counter(
            "service_ticks_total", "global scheduler ticks")
        self._m_xpool = self.registry.counter(
            "service_xpool_batches_total",
            "fused evaluate() calls spanning >1 pool")
        self._m_fused_rows = self.registry.histogram(
            "service_fused_batch_rows",
            "rows per cross-pool fused simulation batch")
        self._m_expired = self.registry.counter(
            "service_expired_results_total",
            "retired-pool results dropped by the result TTL")
        # results of retired pools older than this many ticks are dropped
        # (handles report status "expired"); None keeps them forever
        self.result_ttl_ticks = result_ttl_ticks
        self.expired_uids: set[int] = set()
        # fuse the gang tick's Simulation rows across pools into ONE
        # evaluate() call; None = whenever the policy gangs.  False keeps
        # gang ticks but evaluates per pool (the bit-identity control).
        self.fuse = self.policy.gang if fuse_across_pools is None \
            else fuse_across_pools
        self.retire_after_ticks = retire_after_ticks
        # fused K-superstep device dispatch (core.fused): K > 1 moves
        # every fused-capable pool onto it; the clock then advances by
        # the supersteps each tick ran (see tick)
        self.supersteps_per_dispatch = max(1, int(supersteps_per_dispatch))
        # D-sharded serving: every bucket's pool partitions its G slots
        # across n_shards per-device arenas; the pool owns the placement
        self.n_shards = max(1, int(n_shards))
        self.shard_devices = shard_devices
        # overlap serving: every pool pipelines its supersteps over
        # n_gangs double-buffered gangs; drain_inflight completes the
        # gangs in flight when a clock budget stops the loop
        self.overlap = bool(overlap)
        self.n_gangs = max(1, int(n_gangs))
        self._pool_kw = dict(
            supersteps_per_dispatch=self.supersteps_per_dispatch,
            alternating_signs=alternating_signs,
            reuse_subtree=reuse_subtree,
            compact_threshold=compact_threshold,
            compact_exit_threshold=compact_exit_threshold,
            persistent_compaction=persistent_compaction,
            n_shards=self.n_shards,
            shard_devices=shard_devices,
            overlap=self.overlap,
            n_gangs=self.n_gangs,
            device=self.device,
        )
        # ONE host-expansion engine (and process pool, in "pool" mode)
        # shared by every bucket
        self.expander = ExpansionEngine(env, expansion,
                                        pool_workers=pool_workers,
                                        tracer=tracer, metrics=metrics)
        self.pools: dict = {}
        self._order: list = []          # bucket keys in creation order
        self.last_key = None            # bucket of the latest superstep
        self.ticks = 0                  # monotonic global tick clock
        # handle surface: per-request results and streamed move events,
        # fed by the pool listeners (non-draining — readable mid-flight)
        self.results: dict[int, SearchResult] = {}
        self.move_log: dict[int, list[MoveEvent]] = {}
        self._seen_uids: set[int] = set()   # O(1) duplicate-submit guard
        self._deadlines: list[tuple[int, int, tuple]] = []  # (tick, uid, key)
        # cross-pool fusion counters
        self.xpool_batches = 0          # fused evaluate() calls spanning >1 pool
        self.xpool_rows_max = 0         # largest fused cross-pool batch
        self.xpool_pool_rows_max = 0    # largest single-pool share inside one

    # ---- routing ----
    def _pool_for(self, cfg: TreeConfig) -> ArenaPool:
        key = bucket_key(cfg)
        pool = self.pools.get(key)
        if pool is None:
            pool = ArenaPool(
                canonical_config(cfg), self.env, self.sim, self.G, self.p,
                executor=self.executor, expander=self.expander,
                tracer=self.trace, metrics=self.registry,
                **self._pool_kw)
            pool.clock = lambda: self.ticks
            pool.move_listener = self._on_move
            pool.result_listener = self._on_result
            self.pools[key] = pool
            self._order.append(key)
        return pool

    def submit(self, req: SearchRequest) -> tuple:
        """Route a request to its bucket's pool (created or resurrected on
        demand); returns (pool, bucket_key)."""
        cfg = req.cfg if req.cfg is not None else self.default_cfg
        if cfg is None:
            raise ValueError(
                f"request uid={req.uid} carries no TreeConfig and the "
                f"scheduler has no default_cfg")
        if req.cfg is None:
            req.cfg = cfg
        if req.uid in self._seen_uids:
            raise ValueError(f"request uid={req.uid} already submitted — "
                             f"uids are the handle identity and must be "
                             f"unique per client")
        self._seen_uids.add(req.uid)
        key = bucket_key(cfg)
        pool = self._pool_for(cfg)
        req.submit_tick = self.ticks
        if req.deadline_supersteps is not None:
            req.deadline_tick = self.ticks + int(req.deadline_supersteps)
            self._deadlines.append((req.deadline_tick, req.uid, key))
        pool.submit(req)
        pool.idle_ticks = 0
        return pool, key

    # ---- listener plumbing (the handle surface) ----
    def _on_move(self, ev: MoveEvent):
        self.move_log.setdefault(ev.uid, []).append(ev)

    def _on_result(self, res: SearchResult):
        self.results[res.uid] = res

    def cancel(self, uid: int, key=None, reason: str = "cancel") -> bool:
        """Evict a queued or in-flight request; False once it completed
        (results are immutable after eviction)."""
        if uid in self.results:
            return False
        pools = [self.pools[key]] if key in self.pools else \
            list(self.pools.values())
        return any(pool.cancel(uid, reason) for pool in pools)

    def _expire_deadlines(self):
        if not self._deadlines:
            return
        due = [d for d in self._deadlines if d[0] <= self.ticks]
        if not due:
            return
        self._deadlines = [d for d in self._deadlines if d[0] > self.ticks]
        for _, uid, key in due:
            self.cancel(uid, key, reason="deadline")

    def _fused_cap(self) -> Optional[int]:
        """Superstep cap for fused dispatches this tick: never run past
        the most urgent outstanding deadline, so deadline eviction keeps
        its per-tick granularity (the clock advances by the largest
        fused run, and the cap guarantees that advance stops at the
        nearest deadline).  None = no deadline pending, run the full K."""
        if not self._deadlines:
            return None
        return max(1, min(t for t, _, _ in self._deadlines) - self.ticks)

    # ---- the global tick ----
    def tick(self) -> bool:
        """One scheduler tick: expire deadlines, apply the policy's
        admission caps, advance the policy's pool choice (one pool, or a
        fused gang), then sweep idle pools toward retirement.  False when
        no pool had work."""
        self.ticks += 1
        self._m_ticks.inc()
        tok = self.trace.begin("tick", cat="sched", tid=self._track,
                               tick=self.ticks)
        self._expire_deadlines()
        limits = self.policy.admit_limits(self)
        for key, pool in self.pools.items():
            pool.admit_limit = limits.get(key)
            pool.deadline_first = self.policy.deadline_first
        pending = []
        fused_ns = []            # supersteps each fused pool ran this tick
        advanced_ids: set = set()
        cap = self._fused_cap()
        for key in self.policy.order(self):
            pool = self.pools[key]
            if pool.retired or not pool.has_work():
                continue
            if self.supersteps_per_dispatch > 1 and pool.fused_capable():
                # fused K-superstep device dispatch: admission, simulation
                # and move commits all happen inside; the deadline cap
                # keeps eviction granularity intact
                n = pool.fused_dispatch(max_supersteps=cap)
                if n == 0:
                    continue
                fused_ns.append(n)
            else:
                pend = pool.begin_superstep()
                if pend is None:
                    continue
                pending.append((pool, pend))
            advanced_ids.add(id(pool))
            self.last_key = key
            self.policy.advanced(self, key)
            if not self.policy.gang:
                break
        if pending:
            self._evaluate_and_finish(pending)
        if fused_ns:
            # the global clock counts supersteps of service time: a tick
            # whose deepest fused dispatch ran n supersteps advances the
            # clock by n (the +1 at tick entry already paid the first)
            self.ticks += max(fused_ns) - 1
        self._sweep_retirement(advanced=advanced_ids)
        if tok is not None:
            self.trace.end(tok)
        return bool(pending) or bool(fused_ns)

    def _evaluate_and_finish(self, pending):
        """ONE SimulationBackend.evaluate spanning every advancing pool
        (sim-state shapes are config-independent), results scattered back
        per pool — or per-pool evaluate when fusion is off / trivial."""
        if self.fuse and len(pending) > 1:
            rows = [len(pend.sim_states) for _, pend in pending]
            fused = np.concatenate(
                [pend.sim_states for _, pend in pending])
            t0 = time.perf_counter()
            with self.trace.span("simulate", cat="phase", tid=self._track,
                                 rows=len(fused), pools=len(pending)):
                values, priors = self.sim.evaluate(fused)
            t_sim = time.perf_counter() - t0
            self._m_xpool.inc()
            self._m_fused_rows.observe(len(fused))
            self.xpool_batches += 1
            self.xpool_rows_max = max(self.xpool_rows_max, len(fused))
            self.xpool_pool_rows_max = max(self.xpool_pool_rows_max,
                                           max(rows))
            off = 0
            for (pool, pend), r in zip(pending, rows):
                pr = None if priors is None else priors[off:off + r]
                pool.finish_superstep(
                    pend, values[off:off + r], pr,
                    t_sim=t_sim * r / max(len(fused), 1), own_batch=False)
                off += r
        elif has_async_sim(self.sim) and len(pending) > 1:
            # microbatching backend, fusion off: submit EVERY pool's rows
            # first, then collect — the server's admission window packs
            # rows from different pools into shared fixed-shape
            # microbatches (and dispatch-capable backends already have
            # device programs in flight while later submits assemble).
            # Per-row results are batch-composition independent
            # (sim.server padding), so this is bit-identical to the
            # per-pool evaluate loop below.
            tickets = [(pool, pend, self.sim.submit(pend.sim_states))
                       for pool, pend in pending]
            for pool, pend, ticket in tickets:
                t0 = time.perf_counter()
                with pool.trace.span("simulate", cat="phase",
                                     tid=pool._track,
                                     rows=len(pend.sim_states)):
                    values, priors = self.sim.collect(ticket)
                t_sim = time.perf_counter() - t0
                pool.finish_superstep(pend, values, priors, t_sim=t_sim)
        else:
            for pool, pend in pending:
                t0 = time.perf_counter()
                with pool.trace.span("simulate", cat="phase",
                                     tid=pool._track,
                                     rows=len(pend.sim_states)):
                    values, priors = self.sim.evaluate(pend.sim_states)
                t_sim = time.perf_counter() - t0
                pool.finish_superstep(pend, values, priors, t_sim=t_sim)

    def _sweep_retirement(self, advanced: set):
        ttl = self.retire_after_ticks
        for pool in self.pools.values():
            if id(pool) in advanced or pool.has_work():
                pool.idle_ticks = 0
            elif not pool.retired:
                pool.idle_ticks += 1
                if ttl is not None and pool.idle_ticks >= ttl:
                    pool.retire()
            if pool.retired:
                self._expire_results(pool)

    def _expire_results(self, pool: ArenaPool):
        """Result TTL (retired pools only): completed results older than
        `result_ttl_ticks` global ticks are dropped from the pool, the
        handle surface and the move log — retirement bounds arena memory,
        this bounds the host-side result ledger.  Expired uids stay in
        `expired_uids` so their handles report status "expired" instead
        of reverting to "unknown".

        Popping `move_log[uid]` only unlinks the LIST from the dict; the
        list object itself is never mutated here.  SearchHandle.moves()
        relies on that: a live iterator holds the list reference it
        first resolved, so expiry mid-iteration stops growth but never
        truncates events the iterator hasn't yielded yet."""
        if self.result_ttl_ticks is None or not pool.completed:
            return
        keep = []
        for res in pool.completed:
            if 0 <= res.done_tick <= self.ticks - self.result_ttl_ticks:
                self.expired_uids.add(res.uid)
                self.results.pop(res.uid, None)
                self.move_log.pop(res.uid, None)
                self._m_expired.inc()
                self.trace.instant("expire", cat="request",
                                   tid=self._track, uid=res.uid)
            else:
                keep.append(res)
        pool.completed[:] = keep

    def run(self, max_ticks: int = 100_000) -> list[SearchResult]:
        """Drain every pool (compatibility surface for the adapters; new
        code drives poll/run_until on the client), bounded by `max_ticks`
        of the clock."""
        start = self.ticks
        while self.ticks - start < max_ticks and self.tick():
            pass
        # a clock-budget exit can leave overlap gangs in flight; finish
        # them WITHOUT advancing the clock past the budget
        self.drain_inflight()
        return self.completed

    def drain_inflight(self) -> int:
        """Complete every pool's in-flight overlap gang without advancing
        the global clock (the budget-bound contract of run/result/
        run_until, extended to pipelined gangs).  Returns the number of
        drained supersteps; 0 when overlap is off or nothing is in
        flight."""
        if not self.overlap:
            return 0
        return sum(pool.drain_overlap() for pool in self.pools.values()
                   if not pool.retired)

    # ---- aggregate views ----
    @property
    def completed(self) -> list[SearchResult]:
        done: list[SearchResult] = []
        for key in self._order:
            done.extend(self.pools[key].completed)
        return done

    @property
    def stats(self) -> ServiceStats:
        """Scheduler-wide aggregate of every pool's counters.  `ticks` is
        the core's own monotonic clock (NOT the sum of per-pool attempt
        counters — the per-tick information merge() used to lose), and
        `sim_batches` adds the cross-pool fused evaluate calls the core
        issued itself."""
        total = ServiceStats()
        for pool in self.pools.values():
            total = total.merge(pool.stats)
        total.ticks = self.ticks
        total.sim_batches += self.xpool_batches
        total.max_fused_rows = max(total.max_fused_rows, self.xpool_rows_max)
        return total

    def pool_summaries(self) -> list[dict]:
        """Per-bucket one-liners: shape class, load, session counters."""
        out = []
        for key in self._order:
            pool = self.pools[key]
            s = pool.stats
            out.append({
                "bucket": key, "cfg": pool.cfg, "G": pool.G,
                "queued": len(pool.queue),
                "active": pool.load(),
                "retired": pool.retired,
                "idle_ticks": pool.idle_ticks,
                "supersteps": s.supersteps, "completed": s.completed,
                "session_gathers": s.session_gathers,
                "session_scatters": s.session_scatters,
                "session_reuses": s.session_reuses,
            })
        return out

    def close(self):
        for pool in self.pools.values():
            pool.close()          # flushes sessions; engine is shared
        self.expander.close()     # ... so the core closes it once
