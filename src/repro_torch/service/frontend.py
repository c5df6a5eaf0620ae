"""ServiceFrontend — compatibility adapter over the SearchClient stack
(the port of repro.service.frontend).

Historical surface: one submit() returning the routed ArenaPool, a
superstep()/run() drain loop, and aggregate stats/pool_summaries views.
Since the SearchClient redesign the frontend owns none of that logic —
it is a thin veneer over client.SearchClient / scheduler_core
.SchedulerCore, which carry the routing, the SchedulePolicy (round-robin
here by default, preserving the historical one-pool-per-tick cadence bit
for bit), deadline eviction, cold-pool retirement and the cross-pool
fused Simulation batch.  New code should hold SearchHandles from
SearchClient.submit instead of pools; this adapter exists so every
pre-redesign caller (tests, benches, examples) keeps working unchanged.

The layer map lives in service/client.py; the scheduling design in
service/scheduler_core.py.
"""

from __future__ import annotations

from typing import Optional, Union

from repro_torch.core.mcts import Environment, SimulationBackend
from repro_torch.core.tree import TreeConfig
from repro_torch.service.client import SearchClient
from repro_torch.service.pool import ArenaPool, SearchRequest, SearchResult
from repro_torch.service.scheduler_core import SchedulePolicy

__all__ = ["ServiceFrontend"]


class ServiceFrontend:
    """Multi-config MCTS serving frontend: one submit(), N arena pools.

    Pools are created lazily, one per request-config bucket, each with
    `G` slots and the frontend-wide executor / compaction / expansion
    settings.  `default_cfg` (optional) serves requests that carry no
    config of their own.  `policy` / `retire_after_ticks` pass through to
    the scheduler core (round-robin and no retirement by default — the
    historical behavior).
    """

    def __init__(
        self,
        env: Environment,
        sim: SimulationBackend,
        G: int,
        p: int,
        executor: str = "cuda",
        default_cfg: Optional[TreeConfig] = None,
        alternating_signs: bool = False,
        reuse_subtree: bool = True,
        compact_threshold: float = 0.0,
        compact_exit_threshold: Optional[float] = None,
        persistent_compaction: bool = True,
        expansion: str = "loop",
        pool_workers: int = 2,
        supersteps_per_dispatch: int = 1,
        policy: Union[str, SchedulePolicy] = "round-robin",
        retire_after_ticks: Optional[int] = None,
        tracer=None,
        metrics=None,
        n_shards: int = 1,
        shard_devices: Optional[list] = None,
        overlap: bool = False,
        n_gangs: int = 2,
        device=None,
    ):
        self.client = SearchClient(
            env, sim, G=G, p=p, executor=executor, default_cfg=default_cfg,
            policy=policy, retire_after_ticks=retire_after_ticks,
            alternating_signs=alternating_signs, reuse_subtree=reuse_subtree,
            compact_threshold=compact_threshold,
            compact_exit_threshold=compact_exit_threshold,
            persistent_compaction=persistent_compaction,
            expansion=expansion, pool_workers=pool_workers,
            supersteps_per_dispatch=supersteps_per_dispatch,
            trace=tracer if tracer is not None else False,
            metrics=metrics if metrics is not None else False,
            n_shards=n_shards, shard_devices=shard_devices,
            overlap=overlap, n_gangs=n_gangs, device=device)
        self.core = self.client.core

    # ---- historical attribute surface (delegated) ----
    @property
    def env(self):
        return self.core.env

    @property
    def sim(self):
        return self.core.sim

    @property
    def G(self):
        return self.core.G

    @property
    def p(self):
        return self.core.p

    @property
    def executor(self):
        return self.core.executor

    @property
    def default_cfg(self):
        return self.core.default_cfg

    @property
    def expander(self):
        return self.core.expander

    @property
    def pools(self) -> dict:
        return self.core.pools

    @property
    def last_key(self):
        return self.core.last_key

    # ---- routing ----
    def submit(self, req: SearchRequest) -> ArenaPool:
        """Route a request to the ArenaPool serving its config bucket
        (created on first use).  Returns the pool for compatibility;
        callers that want a handle should use SearchClient.submit."""
        handle = self.client.submit(req)
        return self.core.pools[handle._key]

    # ---- scheduler ticks ----
    def superstep(self) -> bool:
        """One global scheduler tick (round-robin default: advance the
        next pool with work).  False when every pool is drained."""
        return self.core.tick()

    def run(self, max_supersteps: int = 100_000) -> list[SearchResult]:
        return self.core.run(max_supersteps)

    # ---- aggregate views ----
    @property
    def completed(self) -> list[SearchResult]:
        return self.core.completed

    @property
    def stats(self):
        """Frontend-wide aggregate of every pool's counters."""
        return self.core.stats

    def pool_summaries(self) -> list[dict]:
        """Per-bucket one-liners: shape class, load (via the public
        ArenaPool.load accessor), session counters."""
        return self.core.pool_summaries()

    def close(self):
        self.client.close()
