"""SearchService — deprecated single-bucket wrapper over ArenaPool (the
port of repro.service.scheduler).

The service stack is client-first now (see service/client.py for the
layer map):

  client.py          SearchClient / SearchHandle — the public API:
                     opaque handles (done/result/cancel/moves), poll and
                     run_until instead of a drain-only run().
  scheduler_core.py  SchedulerCore + SchedulePolicy — global admission
                     across config buckets, deadline eviction, cold-pool
                     retirement, cross-pool fused Simulation batches.
  pool.py            ArenaPool — one bucket's G-slot arena + StateTables
                     + admission queue; the BSP superstep body
                     (Selection / Insertion / host expansion / fused
                     Simulation / BackUp) split at the Simulation
                     boundary so the core can batch across pools.
  frontend.py        ServiceFrontend — the pre-handle compatibility
                     adapter (submit returns the routed pool).
  this module        SearchService — ArenaPool under its historical name
                     and signature: the one-config service every legacy
                     test, bench and example was written against.  It
                     emits a one-time DeprecationWarning pointing at
                     SearchClient; the scheduler surface — submit/
                     superstep/run, stats, last_decision, exec — is
                     otherwise unchanged.

Mirrors serving/batcher.py's slot pattern one level up the stack: the
pool is a TreeArena of G slots instead of a KV-cache pool, a request is a
whole search instead of a prompt, and the decode tick is a BSP superstep
advancing EVERY occupied slot together, with all slots' simulation states
fused into ONE SimulationBackend.evaluate batch (the cross-request
analogue of the within-tree worker batching the paper's Fig. 5 measures).
See pool.py for the lifecycle and compaction details.
"""

from __future__ import annotations

import warnings

from repro_torch.service.pool import (
    ArenaPool, SearchRequest, SearchResult, ServiceStats,
)

__all__ = ["ArenaPool", "SearchRequest", "SearchResult", "SearchService",
           "ServiceStats"]


class SearchService(ArenaPool):
    """G-slot multi-tree MCTS server for ONE TreeConfig — the deprecated
    single-bucket special case of the client/scheduler/pool stack.  New
    code should submit through service.client.SearchClient, which routes
    heterogeneous request configs, returns opaque SearchHandles, and
    schedules across buckets (policies, deadlines, retirement, cross-pool
    fused simulation)."""

    _warned = False      # one-time deprecation notice per process

    def __init__(self, *args, **kwargs):
        if not SearchService._warned:
            SearchService._warned = True
            warnings.warn(
                "SearchService is deprecated: use "
                "repro_torch.service.client.SearchClient (opaque SearchHandles, "
                "poll/run_until, schedule policies) — SearchService remains "
                "as a single-bucket compatibility wrapper only",
                DeprecationWarning, stacklevel=2)
        super().__init__(*args, **kwargs)
