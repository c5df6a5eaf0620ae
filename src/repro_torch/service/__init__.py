"""Multi-tree search service: handles, global scheduler, arena pools (the
port of repro.service; the serving entry point of repro_torch).

The public API is client-first (new names exported first):

  SearchClient / SearchHandle    (client.py)   submit() -> opaque handle
      with done()/result()/cancel()/moves() streaming, poll()/run_until()
      progress — callers never touch pools or arenas.
  SchedulerCore / SchedulePolicy (scheduler_core.py)   global admission
      across config buckets (round-robin | weighted-queue-depth |
      deadline-aware), deadline eviction, cold-pool retirement, and the
      cross-pool fused SimulationBackend.evaluate batch.
  ArenaPool                      (pool.py)     one bucket's G-slot arena,
      StateTables, queue, and the BSP superstep body (split at the
      Simulation boundary for cross-pool fusion).

Compatibility adapters (deprecated surface, kept working):

  ServiceFrontend (frontend.py)  pre-handle multi-bucket frontend —
      submit() returns the routed pool; a thin veneer over SearchClient.
  SearchService   (scheduler.py) the single-bucket service under its
      historical name (one-time DeprecationWarning).
  arena-executor aliases         re-exported from core.executor; the
      repro_torch.service.arena module itself is a lazy deprecation shim.

Everything runs on CUDA with the hand-written tree kernels unless the
caller passes ``device="cpu"`` (or another executor);
``supersteps_per_dispatch=K > 1`` moves the pools onto the fused
K-superstep device dispatch (core.fused); ``n_shards=D`` spreads each
pool's slots over D per-device shard arenas (core.sharded), and
``overlap=True`` pipelines each pool's supersteps over ``n_gangs``
double-buffered gangs.
"""

from repro_torch.service.client import SearchClient, SearchHandle
from repro_torch.service.scheduler_core import (
    POLICY_NAMES, DeadlineAwarePolicy, RoundRobinPolicy, SchedulePolicy,
    SchedulerCore, WeightedQueueDepthPolicy, make_policy,
)
from repro_torch.service.pool import (
    ArenaPool, MoveEvent, SearchRequest, SearchResult, ServiceStats,
)
from repro_torch.service.frontend import ServiceFrontend
from repro_torch.service.scheduler import SearchService
from repro_torch.core.executor import (
    CudaExecutor as CudaArenaExecutor,
    InTreeExecutor,
    ReferenceExecutor as ReferenceArenaExecutor,
    TorchExecutor as TorchArenaExecutor,
    make_intree_executor as make_arena_executor,
)

__all__ = [
    # new serving API first
    "SearchClient", "SearchHandle",
    "SchedulerCore", "SchedulePolicy", "POLICY_NAMES", "make_policy",
    "RoundRobinPolicy", "WeightedQueueDepthPolicy", "DeadlineAwarePolicy",
    "ArenaPool", "MoveEvent", "SearchRequest", "SearchResult",
    "ServiceStats",
    # compatibility surface
    "ServiceFrontend", "SearchService",
    "InTreeExecutor", "TorchArenaExecutor", "CudaArenaExecutor",
    "ReferenceArenaExecutor", "make_arena_executor",
]
