"""ArenaPool — one config bucket's arena, state tables and superstep body.

The port of repro.service.pool (lock-step serving).  Middle layer of the
service stack (client.py has the map):

  client.py          SearchClient / SearchHandle — the public serving API.
  scheduler_core.py  SchedulerCore + SchedulePolicy — global admission
                     across buckets, cold-pool retirement, and the
                     cross-pool fused Simulation batch.
  this module        ArenaPool — one TreeConfig shape class: a G-slot tree
                     arena on one InTreeExecutor, the per-slot
                     StateTables, admission queue, and the BSP superstep
                     body (Selection / Insertion / host expansion / fused
                     Simulation / BackUp, one device program per phase:
                     on the ``cuda`` executor one launch of each
                     hand-written tree kernel per superstep for all slots).

Lifecycle of a request:
  queued -> admitted into a free slot (fresh tree + ST, root = seed state)
         -> superstepped until its per-move budget / node cap / saturation
         -> move committed (robust child) and emitted as a MoveEvent to
            the pool's move listener, then either
              * evicted with its action trace + root visit distributions, or
              * advanced in place: the executor re-roots the slot on the
                chosen child's subtree (statistics preserved; on a device
                arena in place, kernels.reroot) and the search continues
                on the same slot for its next move.
  A request can also leave early: `cancel(uid)` removes it from the queue
  or frees its slot mid-flight (partial moves are kept on the result),
  and the scheduler core uses the same path for deadline eviction.

The superstep body is split so a scheduler can fuse Simulation across
pools: `begin_superstep()` runs admission, Selection, Insertion and host
expansion and returns the pending step with its simulation rows;
`finish_superstep(pending, values, priors)` scatters the evaluated
values back through finalize / BackUp / move commit.  `superstep()` is
begin + this pool's own `sim.evaluate` + finish.

Requests may carry their own TreeConfig: any config in the pool's bucket
(core.tree.bucket_key — same X/D/semantics, fanout padded to the shared
Fp lane width) is accepted, and host-side readouts (visit distributions)
use the request's own F.

Active-slot compaction: below the enter threshold the pool opens a
persistent CompactionSession (core.executor): ONE gather copies the A
active slots into a dense pow2-padded sub-arena that stays resident on
the device across supersteps, with the scatter back deferred to session
close or snapshot reads.  The session ends on membership changes
(admission, eviction, cancellation, or a reroot rewriting a member
slot).  A separate exit threshold (hysteresis) keeps occupancy
oscillating around the enter threshold from thrashing gather/scatter.
Per-slot arithmetic is position-independent, so masked, per-superstep
compacted and session execution are all bit-identical.

Cold pools retire: an idle pool's `retire()` closes its session and
releases the arena and StateTables (executor.release(): on a card the
arena's memory goes back to the allocator), keeping only
queue/stat/result state; the next submit resurrects it with a fresh
arena.

Timing honesty: the phase timers and the spans on the pool's trace track
(obs.trace lists them) fence the device (executor.block(),
torch.cuda.synchronize on a card) only when tracing is on; untraced, the
select phase's host reads are the only waits, as in the reference.

Fused K-superstep dispatch (``supersteps_per_dispatch = K > 1``,
core.fused): `fused_dispatch()` runs admission, then up to K supersteps
on the device in one dispatch (on the ``cuda`` executor: K replays of
one captured CUDA graph of the superstep body, no host read between
them), escaping at a move-commit boundary or at an expansion the env's
device twin cannot resolve (that superstep is completed through the
ordinary host path), then commits moves.  It needs a device executor,
an env and a sim backend with device twins, and no expand-all.

Multi-device serving (D x G_shard): `n_shards=D` partitions the G slots
into D contiguous runs of G_shard = G // D, one child arena per device
each (core/sharded.py; shard d on launch.mesh.serving_devices(D)[d],
``cuda:(d % device_count)``, or `shard_devices`).  Admission fills the
LEAST-LOADED enabled shard first (ties break toward the lowest shard id,
then the lowest free slot, so D=1 is exactly the lowest-free-slot
order); `set_shard_enabled(d, False)` drains a shard — live requests
finish, new admissions route around it.  The superstep body is
unchanged: the sharded executor fans every phase out per device, host
expansion and the (cross-pool fused) Simulation batch span all shards,
and fused K-dispatches run per shard, each to its own escape
(`fused_dispatch`).  Per-request results are bit-identical at any D.

Overlap mode (`overlap=True`): pipelined supersteps over double-buffered
gangs, the paper's CPU/accelerator stage pipelining.  The lock-step
superstep serializes host and device: while the expansion engine, the
env workers and the Simulation run, the device is idle, and vice versa.
Overlap splits the slots into `n_gangs` fixed gangs (GangSchedule;
gangs partition WITHIN each shard, so sharding composes) and each
`begin_superstep` tick (1) stages the NEXT gang's device half
(Selection + Node Insertion queued on the device, no host read), (2)
promotes it — its one blocking read, then the `expand_submit` post to
the env workers — and (3) collects the IN-FLIGHT gang's expansion batch
and hands it back, so the promoted gang's workers step while the caller
evaluates and finishes the collected gang.  Every device phase is
masked per slot and gangs are disjoint, so one device stream in order
computes each slot's trajectory bit-identically to lock-step.  The clock
ticks when a gang superstep begins; `drain_overlap()` completes an
in-flight gang WITHOUT advancing the clock, and runs before any
cancel or eviction frees an active slot.  Overlap refuses active-slot
compaction (two gangs in flight would race the session sub-arena), and
composes with the fused K-dispatch: per tick one gang's fused programs
are submitted (`run_supersteps_submit`, each gang on its own
FusedProgram) before the previous gang's are collected and accounted.

Determinism: with a deterministic SimulationBackend the per-slot tree
evolution is bit-identical to a single-tree TreeParallelMCTS run of the
same request — scheduling changes WHEN a tree's supersteps happen, never
what they compute.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core import fixedpoint as fx
from repro_torch.core.executor import CompactionSession, make_intree_executor
from repro_torch.core.expand import ExpansionEngine
from repro_torch.core.mcts import Environment, SimulationBackend
from repro_torch.core.state_table import StateTable
from repro_torch.core.tree import NULL, TreeConfig, bucket_key, resolve_device
from repro_torch.envs.device import (
    has_async_sim, has_device_env, has_device_sim,
)
from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.obs.trace import NULL_TRACER


def bucket_label(cfg: TreeConfig) -> str:
    """Human-readable bucket tag for metric labels and trace tracks."""
    return f"X{cfg.X}_D{cfg.D}_Fp{cfg.Fp}"


@dataclasses.dataclass
class SearchRequest:
    """One user search: plan `moves` actions from the seed state, spending
    up to `budget` supersteps of p simulations per move.  `cfg` is the
    request's own tree shape — the scheduler routes on it; None means "the
    serving pool's config".  `priority` breaks admission ties (higher
    first, FIFO within a class); `deadline_supersteps` is a global-tick
    budget after which the scheduler core evicts the request with
    whatever moves it has committed."""

    uid: int
    seed: int
    budget: int = 16
    moves: int = 1
    keep_tree: bool = False      # attach the final tree snapshot to the result
    cfg: Optional[TreeConfig] = None
    submitted_at: float = 0.0
    priority: int = 0
    deadline_supersteps: Optional[int] = None
    submit_tick: int = -1        # global tick at submission (set by scheduler)
    deadline_tick: Optional[int] = None  # absolute eviction tick (set by core)


@dataclasses.dataclass
class SearchResult:
    uid: int
    actions: list = dataclasses.field(default_factory=list)
    rewards: list = dataclasses.field(default_factory=list)
    visit_counts: list = dataclasses.field(default_factory=list)  # per move, [F]
    supersteps: int = 0
    terminal: bool = False
    tree_snapshot: Optional[dict] = None
    submitted_at: float = 0.0
    done_at: float = 0.0
    cancelled: bool = False          # cancel() or deadline eviction
    deadline_evicted: bool = False   # the cancel came from a deadline
    done_tick: int = -1              # global tick at completion (result TTL)


@dataclasses.dataclass
class MoveEvent:
    """One committed move of one request, emitted as the reroot commits —
    the streaming unit of SearchHandle.moves().  `last` marks the
    request's final move (its SearchResult is complete)."""

    uid: int
    move_index: int
    action: int
    reward: float
    visit_counts: np.ndarray     # root visit distribution, [F]
    last: bool = False


@dataclasses.dataclass
class _Slot:
    req: SearchRequest
    res: SearchResult
    root_state: np.ndarray
    cfg: TreeConfig              # the request's own config (host readouts)
    moves_done: int = 0
    move_supersteps: int = 0
    prev_size: int = 1


@dataclasses.dataclass
class _PendingStep:
    """A superstep paused at the Simulation boundary: everything
    begin_superstep computed that finish_superstep needs, plus the fused
    sim rows a scheduler may batch across pools."""

    ex: object                   # executor chosen for this tick (arena or sub)
    ex_active: np.ndarray
    rows: np.ndarray             # executor row of each active slot
    act_idx: np.ndarray          # arena slot id of each active slot
    sel_dev: object
    hx: dict                     # {slot: HostExpansion}
    sim_states: np.ndarray       # [sum_p, ...] fused Simulation inputs
    t_intree: float = 0.0        # begin-side wall, folded into the pool's
    t_host: float = 0.0          # timing stats at finish time
    tok: object = None           # open "superstep" span (obs.trace)
    compacted: Optional[bool] = None  # ran on a session sub-arena?  None =
    #                              infer from `ex is not pool.exec` (the
    #                              sharded fused path sets it explicitly:
    #                              its `ex` is a shard child, not a sub)


class GangSchedule:
    """Fixed partition of the G slots into `n_gangs` gangs plus the
    round-robin staging order.  Gangs partition WITHIN each shard
    (contiguous runs of the shard's slots), so every gang keeps balanced
    per-device batches at D > 1.  The schedule is a pure function of
    (G, n_gangs, shard_G) and the occupancy sequence: a fixed schedule
    replays deterministically."""

    def __init__(self, G: int, n_gangs: int, shard_G: Optional[int] = None):
        shard_G = G if shard_G is None else int(shard_G)
        self.n_gangs = max(1, min(int(n_gangs), shard_G))
        self.gang_of = np.array(
            [(g % shard_G) * self.n_gangs // shard_G for g in range(G)],
            np.int64)
        self.cursor = 0   # round-robin position of the next stage

    def mask(self, gang: int) -> np.ndarray:
        return self.gang_of == gang

    def next_gang(self, active: np.ndarray,
                  exclude: Optional[int] = None) -> Optional[int]:
        """Next gang (round-robin from the cursor) holding at least one
        active slot, skipping `exclude` (the in-flight gang).  None when
        no other gang has work."""
        for i in range(self.n_gangs):
            cand = (self.cursor + i) % self.n_gangs
            if cand == exclude:
                continue
            if bool((active & (self.gang_of == cand)).any()):
                self.cursor = (cand + 1) % self.n_gangs
                return cand
        return None


@dataclasses.dataclass
class _StagedGang:
    """A gang whose device half (Selection + Node Insertion) is queued
    but not yet read back — the double buffer's async leg."""

    gang: int
    ex_active: np.ndarray        # [G] gang-restricted active mask
    act_idx: np.ndarray          # occupied slots of this gang
    sel_dev: object
    new_nodes_dev: object        # device id block (executor insert_dev)
    tok: object = None           # open "superstep" span on the gang track


@dataclasses.dataclass
class _InflightGang:
    """A promoted gang: device results read back, host expansion batch
    POSTED to the env workers (expand_submit) and running concurrently
    with whatever the main thread does next.  _collect_inflight blocks
    on it and builds the ordinary _PendingStep."""

    gang: int
    ex_active: np.ndarray
    act_idx: np.ndarray
    sel_dev: object
    pexp: object                 # core.expand.PendingExpansion
    t_intree: float
    t_submit: float
    tok: object = None


@dataclasses.dataclass
class ServiceStats:
    supersteps: int = 0
    ticks: int = 0               # scheduler ticks observed (monotonic; a
    #                              bare pool counts its own superstep calls,
    #                              a SchedulerCore overwrites the aggregate
    #                              with its global tick clock)
    admitted: int = 0
    completed: int = 0
    cancelled: int = 0           # cancel() evictions (deadline ones included)
    deadline_evictions: int = 0
    retirements: int = 0         # cold-pool arena releases
    sim_rows: int = 0            # fused simulation-batch rows evaluated
    sim_batches: int = 0         # evaluate() calls this pool issued itself
    max_fused_rows: int = 0
    compacted_supersteps: int = 0  # supersteps run on a gathered sub-arena
    session_gathers: int = 0     # CompactionSession opens (arena -> sub copy)
    session_scatters: int = 0    # sub -> arena write-backs (close/sync)
    session_reuses: int = 0      # supersteps served by an already-resident sub
    occupancy_sum: float = 0.0     # sum of per-superstep A/G (avg = /supersteps)
    t_intree: float = 0.0        # select + insert + finalize + backup
    t_host: float = 0.0          # ST / env expansion + scheduling bookkeeping
    t_expand: float = 0.0        # expansion-engine share of t_host
    t_sim: float = 0.0
    fused_dispatches: int = 0    # fused K-superstep device dispatches issued
    fused_supersteps: int = 0    # supersteps that ran inside a fused dispatch
    fused_ran_k: int = 0         # dispatches that ran their full K budget
    fused_escape_commit: int = 0   # dispatches stopped at a move boundary
    fused_escape_expand: int = 0   # dispatches escaped for host expansion
    fused_compacted_supersteps: int = 0  # fused supersteps on a sub-arena
    fused_replays: int = 0       # superstep bodies run (graph replays)
    t_fused_submit: float = 0.0  # host: ST rows + upload + queueing the bodies
    t_fused_collect: float = 0.0  # host: the wait for the one read-back
    t_fused_finish: float = 0.0  # host: ST write-back, accounting, commits
    # admission-wait histogram: {ticks_waited: n_requests}
    wait_supersteps: dict = dataclasses.field(default_factory=dict)

    def merge(self, other: "ServiceStats") -> "ServiceStats":
        """Aggregate across pools (scheduler summary): max_fused_rows is a
        max, wait_supersteps histograms add per bucket, everything else
        sums."""
        out = ServiceStats()
        for f in dataclasses.fields(ServiceStats):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if f.name == "max_fused_rows":
                out.max_fused_rows = max(a, b)
            elif f.name == "wait_supersteps":
                hist = dict(a)
                for k, v in b.items():
                    hist[k] = hist.get(k, 0) + v
                out.wait_supersteps = hist
            else:
                setattr(out, f.name, a + b)
        return out

    def wait_percentile(self, q: float) -> int:
        """q-th percentile (0..100) of the admission-wait histogram."""
        total = sum(self.wait_supersteps.values())
        if total == 0:
            return 0
        need = q / 100.0 * total
        seen = 0
        for wait in sorted(self.wait_supersteps):
            seen += self.wait_supersteps[wait]
            if seen >= need:
                return wait
        return max(self.wait_supersteps)


class ArenaPool:
    """G-slot multi-tree MCTS pool for one config bucket (one host, one
    device program per phase).  Runs on CUDA with the hand-written kernels
    unless the caller passes another `device` / `executor`; with no CUDA
    device and no ``device="cpu"`` it raises."""

    def __init__(
        self,
        cfg: TreeConfig,
        env: Environment,
        sim: SimulationBackend,
        G: int,
        p: int,
        executor: str = "cuda",
        alternating_signs: bool = False,
        reuse_subtree: bool = True,
        compact_threshold: float = 0.0,
        compact_exit_threshold: Optional[float] = None,
        persistent_compaction: bool = True,
        expansion: str = "loop",
        supersteps_per_dispatch: int = 1,
        expander: Optional[ExpansionEngine] = None,
        tracer=None,
        metrics=None,
        n_shards: int = 1,
        shard_devices: Optional[list] = None,
        overlap: bool = False,
        n_gangs: int = 2,
        device=None,
    ):
        self.cfg, self.env, self.sim = cfg, env, sim
        self.G, self.p = G, p
        self.executor_name = executor
        self.device = resolve_device(device)
        self.alternating_signs = alternating_signs
        self.reuse_subtree = reuse_subtree
        # observability: phase spans on this pool's own trace track,
        # metrics labelled by bucket; both default to the no-op instances
        self.trace = NULL_TRACER if tracer is None else tracer
        self.registry = NULL_REGISTRY if metrics is None else metrics
        label = bucket_label(cfg)
        self._track = self.trace.track(f"pool:{label}")
        reg = self.registry
        self._m_queue = reg.gauge(
            "service_queue_depth", "requests queued, not yet admitted",
            bucket=label)
        self._m_active = reg.gauge(
            "service_active_slots", "occupied arena slots", bucket=label)
        self._m_admitted = reg.counter(
            "service_admitted_total", "requests admitted into a slot",
            bucket=label)
        self._m_wait = reg.histogram(
            "service_admission_wait_ticks",
            "ticks spent queued before admission", bucket=label)
        self._m_completed = reg.counter(
            "service_completed_total", "requests finished (results emitted)",
            bucket=label)
        self._m_supersteps = reg.counter(
            "service_supersteps_total", "supersteps executed", bucket=label)
        self._m_sim_rows = reg.histogram(
            "service_sim_batch_rows", "rows per fused simulation batch",
            bucket=label)
        self._m_retire = reg.counter(
            "service_retirements_total", "cold-pool arena releases",
            bucket=label)
        self._m_gathers = reg.counter(
            "service_compaction_events_total",
            "compaction-session decisions by kind",
            bucket=label, event="gather")
        self._m_reuses = reg.counter(
            "service_compaction_events_total", bucket=label, event="reuse")
        self._m_scatters = reg.counter(
            "service_compaction_events_total", bucket=label, event="scatter")
        # host-expansion engine (core.expand: loop / vector / pool / auto,
        # bit-identical); a scheduler serving several pools passes one in
        self._owns_expander = expander is None
        self.expander = ExpansionEngine(
            env, expansion, tracer=tracer, metrics=metrics) \
            if expander is None else expander
        # occupancy A/G at or below this gathers active slots into a dense
        # sub-arena for the device phases (0.0 = always masked).  Once
        # compacted, the pool stays compacted until occupancy rises above
        # `compact_exit_threshold` (>= enter; default equal).
        self.compact_threshold = compact_threshold
        self.compact_exit_threshold = (
            compact_threshold if compact_exit_threshold is None
            else compact_exit_threshold)
        assert self.compact_exit_threshold >= self.compact_threshold, (
            "hysteresis exit threshold must be >= enter threshold")
        # keep the sub-arena resident across supersteps; False restores
        # the per-superstep gather/scatter for comparison
        self.persistent_compaction = persistent_compaction
        # fused K-superstep device dispatch (core.fused): K > 1 runs it
        # when the executor, env and sim backend all have device legs
        # (fused_capable); K = 1 keeps the phase-by-phase path, the
        # oracle the fused path is held to
        self.supersteps_per_dispatch = max(1, int(supersteps_per_dispatch))
        # multi-device serving: D per-device shard runs of G_shard slots
        # each (module docstring, "Multi-device serving"); D=1 is the
        # single-arena pool, bit for bit
        self.n_shards = max(1, int(n_shards))
        if G % self.n_shards:
            raise ValueError(
                f"G={G} must be a multiple of n_shards={self.n_shards}")
        self.shard_G = G // self.n_shards
        self.shard_devices = shard_devices
        self._shard_enabled = [True] * self.n_shards
        # overlap mode: pipelined supersteps over double-buffered gangs
        # (module docstring, "Overlap mode").  A resident session
        # sub-arena cannot track two gangs in flight.
        self.overlap = bool(overlap)
        self.n_gangs = max(1, int(n_gangs))
        if self.overlap and compact_threshold > 0.0:
            raise ValueError(
                "overlap=True is incompatible with active-slot compaction "
                "(compact_threshold > 0): a resident session sub-arena "
                "would go stale under two gangs in flight")
        self.gangs = (GangSchedule(G, self.n_gangs, self.shard_G)
                      if self.overlap else None)
        self._inflight: Optional[_InflightGang] = None
        self._inflight_fused: Optional[dict] = None
        self._gang_tids: dict = {}
        # overlap busy-ratio bookkeeping: wall seconds of overlap ticks,
        # and how much of them the main thread spent BLOCKED on the env
        # workers (host side) / on device reads (device side)
        self._ov_wall = 0.0
        self._ov_wait_host = 0.0
        self._ov_wait_dev = 0.0
        if self.overlap:
            self._m_busy_host = reg.gauge(
                "service_overlap_busy_ratio",
                "fraction of overlap-tick wall the main thread was not "
                "blocked, by waiting side", bucket=label, side="host")
            self._m_busy_dev = reg.gauge(
                "service_overlap_busy_ratio", bucket=label, side="device")
            self._m_ov_eff = reg.histogram(
                "service_overlap_efficiency",
                "per-tick percent of wall not spent blocked on env "
                "workers or device reads", bucket=label)
        self.exec = self._make_executor()
        self._m_reroots = reg.counter(
            "service_reroots_total",
            "move commits that re-rooted their slot, by where the re-root "
            "ran", bucket=label, path=self.exec.reroot_path)
        self.sts = self._make_state_tables()
        self.slots: list[Optional[_Slot]] = [None] * G
        self.queue: list[SearchRequest] = []
        self.completed: list[SearchResult] = []
        self.stats = ServiceStats()
        self.last_decision: dict = {}   # per-superstep occupancy/compaction
        self._session: Optional[CompactionSession] = None
        self._compacting = False        # hysteresis state
        # scheduler hooks: a SchedulerCore installs its global tick clock,
        # an admission cap, deadline-first admission order, and the
        # move/result listeners the client's handle surface is built on
        self.clock: Optional[Callable[[], int]] = None
        self.admit_limit: Optional[int] = None
        self.deadline_first = False
        self.move_listener: Optional[Callable[[MoveEvent], None]] = None
        self.result_listener: Optional[Callable[[SearchResult], None]] = None
        # cold-pool retirement state (see retire())
        self.retired = False
        self.idle_ticks = 0
        # fixed per-slot finalize width (the arena finalize takes one shape)
        self.K = p * cfg.Fp if cfg.expand_all else p

    def _make_executor(self):
        return make_intree_executor(self.cfg, self.G, self.executor_name,
                                    device=self.device,
                                    n_shards=self.n_shards,
                                    devices=self.shard_devices)

    def _make_state_tables(self) -> list:
        return [StateTable(self.cfg.X, self.env.state_shape,
                           self.env.state_dtype) for _ in range(self.G)]

    # ---- admission ----
    def submit(self, req: SearchRequest):
        if req.cfg is not None and bucket_key(req.cfg) != bucket_key(self.cfg):
            raise ValueError(
                f"request uid={req.uid} config {req.cfg} is outside this "
                f"pool's bucket {bucket_key(self.cfg)} — route it through "
                f"service.client.SearchClient")
        if not req.submitted_at:
            req.submitted_at = time.perf_counter()
        if req.submit_tick < 0:
            req.submit_tick = self._now()
        if self.retired:
            self._resurrect()
        self.queue.append(req)
        self.trace.async_begin(
            "request", req.uid, cat="request", tid=self._track,
            uid=req.uid, seed=req.seed, budget=req.budget, moves=req.moves)
        self.trace.instant("submit", cat="request", tid=self._track,
                           uid=req.uid)

    def _now(self) -> int:
        return self.clock() if self.clock is not None else self.stats.ticks

    def _admit_rank(self, req: SearchRequest, i: int) -> tuple:
        """Admission order: priority class first; within a class, earliest
        deadline first when the scheduler policy asked for it
        (deadline_first), else strict FIFO."""
        urgency = (-req.deadline_tick
                   if self.deadline_first and req.deadline_tick is not None
                   else float("-inf"))
        return (req.priority, urgency, -i)

    def shard_of(self, g: int) -> int:
        """Owning shard of slot g (contiguous D-way partition)."""
        return int(g) // self.shard_G

    def shard_loads(self) -> list:
        """Occupied-slot count per shard — the placement signal."""
        loads = [0] * self.n_shards
        for g, s in enumerate(self.slots):
            if s is not None:
                loads[g // self.shard_G] += 1
        return loads

    def set_shard_enabled(self, shard: int, enabled: bool = True):
        """Failover lever: a disabled shard accepts no NEW admissions
        (its live requests run to completion) — placement routes around
        it until it is re-enabled."""
        self._shard_enabled[int(shard)] = bool(enabled)

    def _place_slot(self) -> Optional[int]:
        """Cross-device placement: the lowest free slot of the
        least-loaded ENABLED shard (ties: lowest shard id).  With D=1
        this is exactly the lowest-free-slot order."""
        loads = self.shard_loads()
        best = None
        for d in range(self.n_shards):
            if not self._shard_enabled[d]:
                continue
            lo = d * self.shard_G
            free = next((g for g in range(lo, lo + self.shard_G)
                         if self.slots[g] is None), None)
            if free is None:
                continue
            if best is None or loads[d] < loads[best[0]]:
                best = (d, free)
        return None if best is None else best[1]

    def _admit(self):
        limit = self.G if self.admit_limit is None \
            else max(0, min(self.admit_limit, self.G))
        active = sum(s is not None for s in self.slots)
        if not self.queue or active >= limit:
            return
        tok = self.trace.begin("admission", cat="phase", tid=self._track)
        while self.queue and active < limit:
            g = self._place_slot()
            if g is None:   # every enabled shard is full
                break
            i = max(range(len(self.queue)),
                    key=lambda j: self._admit_rank(self.queue[j], j))
            req = self.queue.pop(i)
            res = SearchResult(uid=req.uid, submitted_at=req.submitted_at)
            s0 = self.env.initial_state(req.seed)
            na = self.env.num_actions(s0)
            if na == 0:  # degenerate: nothing to search, slot stays free
                res.terminal = True
                self._finish(res)
                continue
            self._root_changed(None, s0)
            self.exec.reset_slot(g, na)
            self.sts[g].flush(s0)
            self.slots[g] = _Slot(req=req, res=res, root_state=s0,
                                  cfg=req.cfg if req.cfg is not None
                                  else self.cfg)
            self.stats.admitted += 1
            wait = max(0, self._now() - max(req.submit_tick, 0))
            self.stats.wait_supersteps[wait] = (
                self.stats.wait_supersteps.get(wait, 0) + 1)
            self._m_admitted.inc()
            self._m_wait.observe(wait)
            self.trace.instant("admit", cat="request", tid=self._track,
                               uid=req.uid, slot=g, shard=g // self.shard_G,
                               wait=wait)
            active += 1
        if self.trace.enabled:
            self.exec.block()   # the fresh trees' device work stays here
        self.trace.end(tok)

    def _active(self) -> np.ndarray:
        return np.array([s is not None for s in self.slots], bool)

    def load(self) -> int:
        """Occupied-slot count — the public load accessor."""
        return int(np.sum(self._active()))

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def holds(self, uid: int) -> bool:
        """True while `uid` occupies a slot.  Safe on retired pools — a
        released arena holds nothing."""
        if self.retired:
            return False
        return any(s is not None and s.req.uid == uid for s in self.slots)

    def deadline_ticks(self) -> list:
        """Absolute deadline ticks of every queued and in-flight request.
        Safe on retired pools: retirement is only legal with no occupied
        slot, so only the queue is consulted there."""
        out = [r.deadline_tick for r in self.queue
               if r.deadline_tick is not None]
        if not self.retired:
            out += [s.req.deadline_tick for s in self.slots
                    if s is not None and s.req.deadline_tick is not None]
        return out

    # ---- cancellation (client cancel / scheduler deadline eviction) ----
    def cancel(self, uid: int, reason: str = "cancel") -> bool:
        """Evict a request before it completes.  Queued requests leave
        with an empty (cancelled) result; an in-flight request keeps the
        moves it already committed.  Returns False when the uid is not
        queued or active here (already done, or never submitted)."""
        for i, req in enumerate(self.queue):
            if req.uid == uid:
                self.queue.pop(i)
                res = SearchResult(uid=uid, submitted_at=req.submitted_at)
                self._mark_cancelled(res, reason)
                self._finish(res)
                return True
        for g, slot in enumerate(self.slots):
            if slot is not None and slot.req.uid == uid:
                # an in-flight gang holding this slot must finish first:
                # its queued selection/insertion reference the slot, and
                # freeing it mid-pipeline would strand virtual losses
                if self.overlap:
                    self.drain_overlap()
                    if self.slots[g] is None or self.slots[g].req.uid != uid:
                        # the drained superstep completed this request
                        return True
                # freeing the slot is a membership change: a resident
                # session spanning it must scatter + close first
                self._invalidate_session(g)
                self._mark_cancelled(slot.res, reason)
                self._root_changed(slot.root_state, None)
                self._finish(slot.res)
                self.slots[g] = None
                return True
        return False

    def _mark_cancelled(self, res: SearchResult, reason: str):
        res.cancelled = True
        self.stats.cancelled += 1
        if reason == "deadline":
            res.deadline_evicted = True
            self.stats.deadline_evictions += 1
        self.registry.counter(
            "service_evictions_total", "requests cancelled or evicted",
            bucket=bucket_label(self.cfg), reason=reason).inc()
        self.trace.instant("evict" if reason == "deadline" else "cancel",
                           cat="request", tid=self._track, uid=res.uid,
                           reason=reason)

    # ---- cold-pool retirement ----
    def retire(self) -> bool:
        """Release the arena and StateTables of an idle pool (queue empty,
        no occupied slot): the CompactionSession closes, the executor's
        tensors are released, and only queue/result/stat state remains.
        The next submit resurrects the pool with a fresh arena."""
        if self.retired or self.has_work():
            return False
        self._close_session()
        self.exec.release()
        self.exec = None
        self.sts = None
        self.slots = [None] * self.G
        self.retired = True
        self.stats.retirements += 1
        self._m_retire.inc()
        self.trace.instant("retire", cat="pool", tid=self._track)
        return True

    def _resurrect(self):
        self.exec = self._make_executor()
        self.sts = self._make_state_tables()
        self.retired = False
        self.idle_ticks = 0
        self._compacting = False   # fresh arena, fresh hysteresis state
        self.trace.instant("resurrect", cat="pool", tid=self._track)

    # ---- session plumbing ----
    def _close_session(self):
        ses, self._session = self._session, None
        if ses is not None and ses.close():
            self.stats.session_scatters += 1
            self._m_scatters.inc()

    def _sizes(self) -> np.ndarray:
        ses = self._session
        sizes = np.asarray(self.exec.sizes()).copy()
        if ses is not None and ses.open and ses.dirty:
            sizes[ses.slot_idx] = np.asarray(ses.sub.sizes())[: ses.A]
        return sizes

    def _best_actions(self) -> np.ndarray:
        ses = self._session
        best = np.asarray(self.exec.best_actions()).copy()
        if ses is not None and ses.open and ses.dirty:
            best[ses.slot_idx] = np.asarray(ses.sub.best_actions())[: ses.A]
        return best

    def _invalidate_session(self, g: int):
        """A host-side write (reroot / reset / eviction) is about to touch
        slot g on the full arena — a resident sub-arena copy of it would go
        stale, so the session ends here."""
        ses = self._session
        if ses is not None and ses.owns(int(g)):
            self._close_session()

    # ---- occupancy decision: masked full arena vs resident sub-arena ----
    def _pick_execution(self, active: np.ndarray):
        """Return (executor, exec_active, rows, act_idx): `rows[i]` is the
        arena row carrying active slot `act_idx[i]` on the chosen executor
        (identity when masked, dense prefix when compacted)."""
        act_idx = np.flatnonzero(active)
        A = len(act_idx)
        Gc = 1 << (A - 1).bit_length()     # pow2 pad: few distinct widths
        thresh = (self.compact_exit_threshold if self._compacting
                  else self.compact_threshold)
        compacted = (self.compact_threshold > 0.0
                     and A <= thresh * self.G
                     and Gc < self.G)
        self._compacting = compacted
        session_state = None
        if compacted:
            ses = self._session
            if ses is not None and ses.matches(act_idx, Gc):
                session_state = "resident"
                self.stats.session_reuses += 1
                self._m_reuses.inc()
            else:
                self._close_session()
                ses = self._session = self.exec.open_session(
                    act_idx, Gc, tracer=self.trace, tid=self._track)
                session_state = "gather"
                self.stats.session_gathers += 1
                self._m_gathers.inc()
            ses.mark_superstep()
        else:
            self._close_session()
        self.last_decision = {
            "A": A, "G": self.G, "occupancy": A / self.G,
            "compacted": compacted, "G_exec": Gc if compacted else self.G,
            "session": session_state,
        }
        if compacted:
            return (self._session.sub, np.arange(Gc) < A,
                    np.arange(A), act_idx)
        return self.exec, active, act_idx, act_idx

    # ---- overlap pipeline (double-buffered gangs) ----
    def _gang_track(self, gang: int) -> int:
        """Per-gang trace track: gang supersteps interleave, so each
        gang's spans nest on its own timeline."""
        tid = self._gang_tids.get(gang)
        if tid is None:
            tid = self.trace.track(
                f"pool:{bucket_label(self.cfg)}:gang{gang}")
            self._gang_tids[gang] = tid
        return tid

    def _stage(self, gang: int, active: np.ndarray) -> _StagedGang:
        """Queue one gang's device half (Selection + Node Insertion)
        WITHOUT reading anything back: the kernels and ops go on the
        device's stream and return; the blocking read waits until
        _promote."""
        gmask = active & self.gangs.mask(gang)
        act_idx = np.flatnonzero(gmask)
        tid = self._gang_track(gang)
        tok = self.trace.begin("superstep", cat="phase", tid=tid,
                               tick=self._now(), gang=gang,
                               slots=len(act_idx))
        with self.trace.span("select", cat="phase", tid=tid,
                             slots=len(act_idx), gang=gang):
            sel_dev = self.exec.selection(gmask, self.p)
            new_dev = self.exec.insert_dev(gmask, sel_dev)
            if self.trace.enabled:
                self.exec.block()   # timing honesty: fence only when tracing
        return _StagedGang(gang=gang, ex_active=gmask, act_idx=act_idx,
                           sel_dev=sel_dev, new_nodes_dev=new_dev, tok=tok)

    def _promote(self, st: _StagedGang) -> _InflightGang:
        """Staged -> in flight: the gang's one blocking read (selection
        and inserted ids) and the expansion batch's POST.  From here the
        gang's env workers step while the main thread evaluates and
        finishes another gang."""
        t0 = time.perf_counter()
        sel = self.exec.sel_to_host(st.sel_dev)
        new_nodes = self.exec.insert_host(st.new_nodes_dev)
        t_dev = time.perf_counter() - t0
        self._ov_wait_dev += t_dev
        pexp = self.expander.expand_submit(
            [(g, self.sts[g], {k: v[g] for k, v in sel.items()},
              new_nodes[g]) for g in st.act_idx],
            tid=self._gang_tids.get(st.gang, self._track))
        t1 = time.perf_counter()
        # in-tree wall ~= the blocking read; the queueing itself returned
        # at stage time
        return _InflightGang(gang=st.gang, ex_active=st.ex_active,
                             act_idx=st.act_idx, sel_dev=st.sel_dev,
                             pexp=pexp, t_intree=t_dev,
                             t_submit=(t1 - t0) - t_dev, tok=st.tok)

    def _collect_inflight(self) -> _PendingStep:
        """Block on the in-flight gang's posted expansion batch and build
        the ordinary _PendingStep the caller evaluates and finishes."""
        inf, self._inflight = self._inflight, None
        t0 = time.perf_counter()
        hx = self.expander.expand_collect(
            inf.pexp, tid=self._gang_tids.get(inf.gang, self._track))
        t_wait = time.perf_counter() - t0
        self._ov_wait_host += t_wait
        self.stats.t_expand += inf.t_submit + t_wait
        sim_states = np.concatenate([hx[g].sim_states for g in inf.act_idx])
        return _PendingStep(
            ex=self.exec, ex_active=inf.ex_active, rows=inf.act_idx,
            act_idx=inf.act_idx, sel_dev=inf.sel_dev, hx=hx,
            sim_states=sim_states, t_intree=inf.t_intree,
            t_host=inf.t_submit + t_wait, tok=inf.tok, compacted=False)

    def _overlap_gauges(self, t_tick0: float) -> None:
        self._ov_wall += time.perf_counter() - t_tick0
        if self._ov_wall > 0:
            self._m_busy_host.set(1.0 - self._ov_wait_host / self._ov_wall)
            self._m_busy_dev.set(1.0 - self._ov_wait_dev / self._ov_wall)

    def _begin_overlap(self) -> Optional[_PendingStep]:
        """One overlap tick: stage + promote the next gang (device half
        queued, expansion batch posted), then collect the in-flight
        gang.  Returns the collected gang's pending step (one per tick,
        like lock-step); with a single active gang the pipeline drains
        each tick and degenerates to lock-step."""
        if self._inflight_fused is not None:
            # mode switch (a scheduler deadline cap dropped K to 1):
            # finish the fused gang before pipelining phase-path gangs,
            # or the same slots could select twice concurrently
            self.drain_overlap()
        self.stats.ticks += 1
        t_tick0 = time.perf_counter()
        self._admit()
        self._m_queue.set(len(self.queue))
        active = self._active()
        self._m_active.set(int(active.sum()))
        if not active.any():
            # an in-flight gang implies occupied slots, so the pipeline
            # is empty here
            return None
        if self._inflight is None:   # warm-up: fill the double buffer
            self._inflight = self._promote(
                self._stage(self.gangs.next_gang(active), active))
        # stage AND promote the next gang before blocking on the in-flight
        # gang's batch: the promoted gang's expansion then runs in the env
        # workers across the in-flight gang's collect wait plus the
        # caller's evaluate + finish (promote never touches the in-flight
        # gang's slots)
        nxt = self.gangs.next_gang(active, exclude=self._inflight.gang)
        promoted = None if nxt is None else self._promote(
            self._stage(nxt, active))
        pend = self._collect_inflight()
        self._inflight = promoted
        self._overlap_gauges(t_tick0)
        self._m_ov_eff.observe(100.0 * max(
            0.0, 1.0 - (self._ov_wait_host + self._ov_wait_dev)
            / max(self._ov_wall, 1e-12)))
        return pend

    def drain_overlap(self) -> int:
        """Complete any in-flight gang WITHOUT advancing the clock: the
        budget-bound contract (run/result/run_until max_ticks) and every
        path that frees an active slot (cancel, deadline eviction, close)
        must not leave a gang's queued selection/insertion unfinished.
        Returns the number of supersteps completed (0 when idle)."""
        n = 0
        inf_f, self._inflight_fused = self._inflight_fused, None
        if inf_f is not None:
            n = max(n, self._fused_collect_gang(inf_f))
        if self._inflight is not None:
            pend = self._collect_inflight()
            with self.trace.span("simulate", cat="phase", tid=self._track,
                                 rows=len(pend.sim_states), drain=True):
                values, priors = self._sim_evaluate(pend.sim_states)
            self.finish_superstep(pend, values, priors)
            n += 1
        return n

    # ---- superstep, paused at the Simulation boundary ----
    def begin_superstep(self) -> Optional[_PendingStep]:
        """Admission + Selection + Insertion + host expansion.  Returns
        the pending step carrying the fused simulation rows, or None when
        no slot is occupied.  The caller evaluates the rows (alone or
        fused with other pools') and hands them to finish_superstep."""
        if self.overlap:
            return self._begin_overlap()
        self.stats.ticks += 1
        tok = self.trace.begin("superstep", cat="phase", tid=self._track,
                               tick=self._now())
        self._admit()
        self._m_queue.set(len(self.queue))
        active = self._active()
        self._m_active.set(int(active.sum()))
        if not active.any():
            self.trace.end(tok)
            return None
        t0 = time.perf_counter()
        ex, ex_active, rows, act_idx = self._pick_execution(active)
        with self.trace.span("select", cat="phase", tid=self._track,
                             slots=len(act_idx)):
            sel_dev = ex.selection(ex_active, self.p)
            new_dev = ex.insert_dev(ex_active, sel_dev)     # queued, no read
            sel = ex.sel_to_host(sel_dev)                   # [Ge, p, ...]
            new_nodes = ex.insert_host(new_dev)             # [Ge, p, Fp]
            if self.trace.enabled:
                ex.block()   # attribute device time to select, honestly
        t1 = time.perf_counter()

        # host expansion: every slot's pending expansions through the
        # engine (one flattened env batch in vector/pool mode); the fused
        # Simulation rows are the pending step's hand-off
        hx = self.expander.expand(
            [(g, self.sts[g], {k: v[r] for k, v in sel.items()},
              new_nodes[r]) for r, g in zip(rows, act_idx)],
            tid=self._track)
        t_x = time.perf_counter()
        self.stats.t_expand += t_x - t1
        sim_states = np.concatenate([hx[g].sim_states for g in act_idx])
        t2 = time.perf_counter()
        return _PendingStep(
            ex=ex, ex_active=ex_active, rows=rows, act_idx=act_idx,
            sel_dev=sel_dev, hx=hx, sim_states=sim_states,
            t_intree=t1 - t0, t_host=t2 - t1, tok=tok)

    def finish_superstep(self, pend: _PendingStep, values, priors,
                         t_sim: float = 0.0, own_batch: bool = True):
        """Scatter evaluated values back: finalize + BackUp across all
        slots at once, then commit any finished moves.  `own_batch` is
        False when a scheduler core evaluated this pool's rows inside a
        cross-pool fused batch (the core counts that batch once)."""
        ex, rows, act_idx = pend.ex, pend.rows, pend.act_idx
        p, cfg = self.p, self.cfg
        Ge = ex.G
        self.stats.sim_rows += len(pend.sim_states)
        self.stats.t_sim += t_sim
        if own_batch:
            self.stats.sim_batches += 1
        self.stats.max_fused_rows = max(self.stats.max_fused_rows,
                                        len(pend.sim_states))
        t3 = time.perf_counter()
        tok = self.trace.begin("finalize-build", cat="phase", tid=self._track,
                               slots=len(act_idx))
        values_fx = np.asarray(fx.encode(np.asarray(values)), np.int32)
        fin_nodes = np.full((Ge, self.K), NULL, np.int32)
        fin_na = np.zeros((Ge, self.K), np.int32)
        fin_term = np.zeros((Ge, self.K), np.int32)
        fin_pp = np.full((Ge, p), NULL, np.int32)
        fin_pf = np.zeros((Ge, p, cfg.Fp), np.int32)
        sim_nodes = np.zeros((Ge, p), np.int32)
        vals = np.zeros((Ge, p), np.int32)
        # batched scatter over all active slots at once: ragged per-slot
        # finalize entries land at (repeated row, dense prefix position)
        hxs = [pend.hx[g] for g in act_idx]
        rows_arr = np.asarray(rows, np.int64)
        A = len(hxs)
        sim_nodes[rows_arr] = np.stack([h.sim_nodes for h in hxs])
        vals[rows_arr] = values_fx.reshape(A, p)
        counts = np.fromiter((len(h.fin_nodes) for h in hxs), np.int64, A)
        total = int(counts.sum())
        if total:
            rr = np.repeat(rows_arr, counts)
            pos = np.arange(total) - np.repeat(np.cumsum(counts) - counts,
                                               counts)
            fin_nodes[rr, pos] = np.concatenate(
                [h.fin_nodes for h in hxs if h.fin_nodes])
            fin_na[rr, pos] = np.concatenate(
                [h.fin_na for h in hxs if h.fin_na])
            fin_term[rr, pos] = np.concatenate(
                [h.fin_term for h in hxs if h.fin_term])
        if priors is not None:
            pw = np.fromiter((len(h.prior_workers) for h in hxs), np.int64,
                             A)
            tp = int(pw.sum())
            if tp:
                rr2 = np.repeat(rows_arr, pw)
                pos2 = np.arange(tp) - np.repeat(np.cumsum(pw) - pw, pw)
                fin_pp[rr2, pos2] = np.concatenate(
                    [h.prior_parents for h in hxs if h.prior_parents])
                # global prior row of slot i's worker w is i*p + w
                gw = np.concatenate(
                    [np.asarray(h.prior_workers, np.int64) + i * p
                     for i, h in enumerate(hxs) if h.prior_workers])
                pr = np.asarray(priors)[gw]
                padded = np.zeros((tp, cfg.Fp), np.float32)
                padded[:, : pr.shape[1]] = pr
                fin_pf[rr2, pos2] = np.asarray(fx.encode(padded), np.int32)
        self.trace.end(tok)
        t4 = time.perf_counter()

        with self.trace.span("backup", cat="phase", tid=self._track,
                             slots=len(act_idx)):
            ex.finalize(fin_nodes, fin_na, fin_term, fin_pp, fin_pf)
            ex.backup(pend.ex_active, pend.sel_dev, sim_nodes, vals,
                      self.alternating_signs)
            if self.trace.enabled:
                ex.block()   # fence: device backup time stays in this span
        compacted = (pend.compacted if pend.compacted is not None
                     else ex is not self.exec)
        if compacted:
            self.stats.compacted_supersteps += 1
            if not self.persistent_compaction:
                # per-superstep mode: scatter (and re-gather next tick)
                self._close_session()
        t5 = time.perf_counter()

        self.stats.supersteps += 1
        self.stats.occupancy_sum += len(act_idx) / self.G
        self.stats.t_intree += pend.t_intree + (t5 - t4)
        self.stats.t_host += pend.t_host + (t4 - t3)
        self._m_supersteps.inc()
        if own_batch:
            self._m_sim_rows.observe(len(pend.sim_states))

        self._commit_moves(act_idx)
        if pend.tok is not None:
            self.trace.end(pend.tok)

    def _sim_evaluate(self, states):
        """One simulation batch, through the backend's non-blocking
        submit/collect split when it has one (identical results either
        way)."""
        if has_async_sim(self.sim):
            return self.sim.collect(self.sim.submit(states))
        return self.sim.evaluate(states)

    # ---- one fused superstep over all occupied slots ----
    def superstep(self) -> bool:
        pend = self.begin_superstep()
        if pend is None:
            return False
        t2 = time.perf_counter()
        with self.trace.span("simulate", cat="phase", tid=self._track,
                             rows=len(pend.sim_states)):
            values, priors = self._sim_evaluate(pend.sim_states)
        t_sim = time.perf_counter() - t2
        self.finish_superstep(pend, values, priors, t_sim=t_sim)
        return True

    # ---- fused K-superstep device dispatch (core.fused) ----
    def fused_capable(self) -> bool:
        """True when this pool can run fused dispatches: a device executor
        (the reference keeps the phase-by-phase oracle), device twins of
        the env and the sim backend, and no expand-all priors (those force
        the host expansion path).  A sharded executor is fused-capable
        when every per-device child is (the fused program runs per
        shard, never across shards)."""
        ex = self.exec
        if ex is None:
            return False
        children = [c for c, _, _ in getattr(ex, "shards", [(ex, 0, 0)])]
        return (not self.cfg.expand_all
                and all(hasattr(c, "run_supersteps") for c in children)
                and has_device_env(self.env) and has_device_sim(self.sim))

    def fused_dispatch(self, max_supersteps: Optional[int] = None) -> int:
        """Run up to min(supersteps_per_dispatch, max_supersteps) BSP
        supersteps in ONE device dispatch, escaping early at a
        move-commit boundary or an expansion the env's device twin
        cannot resolve (that superstep is then completed through the
        ordinary host path, so every escape stays on the K=1 oracle
        trajectory).  Falls back to a single phase-by-phase superstep
        when K <= 1 or the pool is not fused-capable.  Returns the number
        of complete supersteps executed (0 when no slot is occupied).

        At D > 1 each shard dispatches its OWN fused program on its own
        device, runs to its own escape, and handles its own commits and
        escapes before the next shard dispatches — a commit boundary only
        stops the shard that hit it, so the scheduler clock advances by
        the max over shards.  Per-slot trajectories are unchanged
        (commit boundaries are slot-local), so per-request results stay
        bit-identical to D=1; pool-total dispatch counters become
        per-shard sums."""
        K = self.supersteps_per_dispatch
        if max_supersteps is not None:
            K = min(K, max(1, int(max_supersteps)))
        if K <= 1 or not self.fused_capable():
            return 1 if self.superstep() else 0
        if self.overlap:
            return self._fused_overlap_tick(K)
        self.stats.ticks += 1
        tok = self.trace.begin("fused-dispatch", cat="phase",
                               tid=self._track, tick=self._now(), k=K)
        self._admit()
        self._m_queue.set(len(self.queue))
        active = self._active()
        self._m_active.set(int(active.sum()))
        if not active.any():
            self.trace.end(tok)
            return 0
        if self.n_shards > 1:
            # masked on the per-device arenas, never on a session sub: a
            # shard's move commit writes the full arena (reroot, reset,
            # evict), which would stale a resident sub-arena the other
            # shards still dispatch on this tick, so any session closes
            # first.  Supersteps are grouping-independent: results stay.
            self._close_session()
            self._compacting = False
            act_idx = np.flatnonzero(active)
            self.last_decision = {
                "A": len(act_idx), "G": self.G,
                "occupancy": len(act_idx) / self.G, "compacted": False,
                "G_exec": self.G, "session": None,
            }
            ns = [self._fused_dispatch_one(child, c_active, rows, c_idx, K,
                                           on_sub=False, tok=None)
                  for child, c_active, rows, c_idx
                  in self._shard_parts(act_idx)]
            self.trace.end(tok)
            return max(ns) if ns else 0
        ex, ex_active, rows, act_idx = self._pick_execution(active)
        return self._fused_dispatch_one(ex, ex_active, rows, act_idx, K,
                                        on_sub=ex is not self.exec, tok=tok)

    def _shard_parts(self, act_idx: np.ndarray) -> list:
        """The shards holding some of `act_idx`: (child executor, child
        active mask, child rows, global slot ids) each.  The arena itself
        is the one shard at D=1."""
        shards = getattr(self.exec, "shards", None) or [(self.exec, 0, self.G)]
        parts = []
        for child, lo, n_run in shards:
            c_idx = act_idx[(act_idx >= lo) & (act_idx < lo + n_run)]
            if not len(c_idx):
                continue
            c_active = np.zeros(child.G, bool)
            c_active[c_idx - lo] = True
            parts.append((child, c_active, c_idx - lo, c_idx))
        return parts

    def _fused_dispatch_one(self, ex, ex_active, rows, act_idx, K: int,
                            on_sub: bool, tok) -> int:
        """One fused device dispatch on the whole arena (masked) or on a
        session's sub-arena (`on_sub`), with its escape handled: a commit
        exit replays _commit_moves exactly like the K=1 path, an
        expansion escape completes the partial superstep through the
        ordinary host path.  Ends the open ``fused-dispatch`` span `tok`
        when given.  Returns the superstep count."""
        t0 = time.perf_counter()
        with self._fused_phase("fused-submit"):
            budget_left, states, start_size = self._fused_upload(
                ex, rows, act_idx)
            pend = ex.run_supersteps_submit(ex_active, self.p, K, self.env,
                                            self.sim, states, budget_left,
                                            self.alternating_signs)
        with self._fused_phase("fused-collect"):
            disp = ex.run_supersteps_collect(pend)
        with self._fused_phase("fused-finish", n=disp.n, escape=disp.escape):
            n = self._fused_finish_one(ex, ex_active, rows, act_idx, disp,
                                       start_size, on_sub, t0)
        if tok is not None:
            self.trace.end(tok)
        return n

    @contextlib.contextmanager
    def _fused_phase(self, name: str, **args):
        """One interval of a fused dispatch (``fused-submit``,
        ``fused-collect``, ``fused-finish``): its span on the pool's track
        and its ServiceStats timer (``t_fused_submit``, ...) open and close
        at the same points."""
        timer = "t_" + name.replace("-", "_")
        tok = self.trace.begin(name, cat="phase", tid=self._track, **args)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            setattr(self.stats, timer,
                    getattr(self.stats, timer) + time.perf_counter() - t0)
            self.trace.end(tok)

    def _fused_upload(self, ex, rows, act_idx):
        """Host half of a fused dispatch's inputs: per-row remaining move
        budgets and the ST rows each dispatched slot's env twin can read
        (those below its size: the only ones the device copy needs)."""
        budget_left = np.zeros(ex.G, np.int32)
        states = [None] * ex.G
        start_size = np.ones(ex.G, np.int64)
        for r, g in zip(rows, act_idx):
            slot = self.slots[g]
            budget_left[r] = slot.req.budget - slot.move_supersteps
            states[r] = self.sts[g].data[: slot.prev_size]
            start_size[r] = slot.prev_size
        return budget_left, states, start_size

    def _fused_finish_one(self, ex, ex_active, rows, act_idx, disp,
                          start_size, on_sub: bool, t0: float) -> int:
        """Accounting and escape handling for one collected fused
        dispatch."""
        A, p = len(act_idx), self.p
        n = disp.n
        t1 = time.perf_counter()
        self.stats.fused_dispatches += 1
        self.stats.fused_supersteps += n
        self.stats.fused_replays += disp.replays
        expand = disp.escape == "expand"
        if expand:
            self.stats.fused_escape_expand += 1
        elif disp.escape == "commit":
            self.stats.fused_escape_commit += 1
        else:
            self.stats.fused_ran_k += 1
        self.registry.counter(
            "service_fused_dispatches_total",
            "fused K-superstep device dispatches by escape reason",
            bucket=bucket_label(self.cfg), escape=disp.escape).inc()
        # pull device-resolved expansion states back into the host tables:
        # node ids are allocated contiguously, so the rows from the size at
        # dispatch start on are exactly the entries the host is missing (an
        # expansion escape leaves out the escaped superstep's insert: the
        # host expansion path writes those)
        for r, g in zip(rows, act_idx):
            lo, new_rows = disp.written(r)
            if lo != start_size[r]:
                raise AssertionError(f"slot {g}: device size {lo} at "
                                     f"dispatch start, host {start_size[r]}")
            if len(new_rows):
                self.sts[g].write(np.arange(lo, lo + len(new_rows)), new_rows)
        # the LAST complete superstep of a normal exit goes through
        # _commit_moves exactly like the K=1 path (so move commits,
        # evictions and reroots replay bit-identically); an expansion
        # escape instead hands its partial superstep to the host path below
        carry = n if expand else n - 1
        for r, g in zip(rows, act_idx):
            slot = self.slots[g]
            slot.move_supersteps += carry
            slot.res.supersteps += carry
            slot.prev_size = int(disp.size_pre[r])
        self.stats.sim_rows += n * A * p
        self.stats.sim_batches += n
        self.stats.max_fused_rows = max(self.stats.max_fused_rows, A * p)
        if n:
            self._m_sim_rows.observe(A * p)
        if on_sub:
            # the n device-complete supersteps ran on the gathered sub-arena
            # (an escaped superstep counts itself in finish_superstep)
            self.stats.compacted_supersteps += n
            self.stats.fused_compacted_supersteps += n
            if not expand and not self.persistent_compaction:
                self._close_session()
        if expand:
            # complete the escaped superstep on the host: the device already
            # applied selection (virtual loss, node_O) and insertion, so the
            # ordinary expand -> evaluate -> finish path picks up exactly
            # where begin_superstep would have handed off
            self.stats.supersteps += n
            self.stats.occupancy_sum += n * A / self.G
            self._m_supersteps.inc(n)
            sel = disp.sel_host
            hx = self.expander.expand(
                [(g, self.sts[g], {k: v[r] for k, v in sel.items()},
                  disp.new_nodes[r]) for r, g in zip(rows, act_idx)],
                tid=self._track)
            t2 = time.perf_counter()
            self.stats.t_expand += t2 - t1
            sim_states = np.concatenate([hx[g].sim_states for g in act_idx])
            pend = _PendingStep(
                ex=ex, ex_active=ex_active, rows=rows, act_idx=act_idx,
                sel_dev=disp.sel_dev, hx=hx, sim_states=sim_states,
                t_intree=t1 - t0, t_host=t2 - t1, tok=None,
                compacted=on_sub)
            t3 = time.perf_counter()
            with self.trace.span("simulate", cat="phase", tid=self._track,
                                 rows=len(sim_states)):
                values, priors = self._sim_evaluate(sim_states)
            self.finish_superstep(pend, values, priors,
                                  t_sim=time.perf_counter() - t3)
            return n + 1
        self.stats.supersteps += n
        self.stats.occupancy_sum += n * A / self.G
        self.stats.t_intree += t1 - t0
        self._m_supersteps.inc(n)
        self._commit_moves(act_idx)
        return n

    # ---- fused x overlap: double-buffered K-superstep dispatches ----
    def _fused_submit_gang(self, gang: int, active: np.ndarray,
                           K: int) -> dict:
        """Queue one gang's fused dispatch per owning shard WITHOUT any
        host read (run_supersteps_submit on the gang's own program): the
        device runs it while the previous gang's collect, escape and
        accounting hold the main thread."""
        act_idx = np.flatnonzero(active & self.gangs.mask(gang))
        parts = []
        for child, c_active, rows, c_idx in self._shard_parts(act_idx):
            t0 = time.perf_counter()
            with self._fused_phase("fused-submit", gang=gang):
                budget_left, states, start_size = self._fused_upload(
                    child, rows, c_idx)
                pend = child.run_supersteps_submit(
                    c_active, self.p, K, self.env, self.sim, states,
                    budget_left, self.alternating_signs, gang=gang)
            parts.append(dict(child=child, c_active=c_active, rows=rows,
                              act_idx=c_idx, start_size=start_size,
                              pend=pend, t0=t0))
        self.trace.instant("fused-stage", cat="phase",
                           tid=self._gang_track(gang), gang=gang, k=K,
                           slots=len(act_idx))
        return {"gang": gang, "parts": parts}

    def _fused_collect_gang(self, inf: dict) -> int:
        """Block on a submitted gang's per-shard fused dispatches and run
        the ordinary accounting and escape body for each.  Returns the
        tick's superstep count (max over shards, as in the sharded
        path)."""
        ns = [0]
        for part in inf["parts"]:
            waited = self.stats.t_fused_collect
            with self._fused_phase("fused-collect", gang=inf["gang"]):
                disp = part["child"].run_supersteps_collect(part["pend"])
            self._ov_wait_dev += self.stats.t_fused_collect - waited
            with self._fused_phase("fused-finish", gang=inf["gang"],
                                   n=disp.n, escape=disp.escape):
                ns.append(self._fused_finish_one(
                    part["child"], part["c_active"], part["rows"],
                    part["act_idx"], disp, part["start_size"],
                    on_sub=False, t0=part["t0"]))
        return max(ns)

    def _fused_overlap_tick(self, K: int) -> int:
        """Overlap tick for K > 1: submit the next gang's fused programs,
        then collect and account the in-flight gang's — its host half
        runs while the freshly submitted programs execute on the
        device."""
        if self._inflight is not None:   # mode switch: K rose above 1
            self.drain_overlap()
        self.stats.ticks += 1
        t_tick0 = time.perf_counter()
        tok = self.trace.begin("fused-dispatch", cat="phase",
                               tid=self._track, tick=self._now(), k=K,
                               overlap=True)
        self._admit()
        self._m_queue.set(len(self.queue))
        active = self._active()
        self._m_active.set(int(active.sum()))
        if not active.any():
            self.trace.end(tok)
            return 0
        self.last_decision = {
            "A": int(active.sum()), "G": self.G,
            "occupancy": float(active.sum()) / self.G, "compacted": False,
            "G_exec": self.G, "session": None,
        }
        if self._inflight_fused is None:   # warm-up
            self._inflight_fused = self._fused_submit_gang(
                self.gangs.next_gang(active), active, K)
        nxt = self.gangs.next_gang(active,
                                   exclude=self._inflight_fused["gang"])
        staged = None if nxt is None \
            else self._fused_submit_gang(nxt, active, K)
        inf, self._inflight_fused = self._inflight_fused, None
        n = self._fused_collect_gang(inf)
        self._inflight_fused = staged
        self.trace.end(tok)
        self._overlap_gauges(t_tick0)
        return n

    # ---- move boundary: commit / advance / evict ----
    def _commit_moves(self, act_idx):
        tok = self.trace.begin("commits", cat="commit", tid=self._track,
                               slots=len(act_idx))
        sizes = self._sizes()
        best = None  # lazy: only computed when some slot finished its move
        for g in act_idx:
            slot = self.slots[g]
            slot.move_supersteps += 1
            slot.res.supersteps += 1
            size = int(sizes[g])
            done_move = (
                slot.move_supersteps >= slot.req.budget
                or size >= self.cfg.X
                or size == slot.prev_size  # saturated: no node inserted
            )
            slot.prev_size = size
            if not done_move:
                continue
            if best is None:
                best = self._best_actions()
            with self.trace.span("commit", cat="commit", tid=self._track,
                                 slot=int(g)):
                self._advance(g, int(best[g]))
        self.trace.end(tok)

    def _advance(self, g: int, a: int):
        slot, env = self.slots[g], self.env
        trace, tid = self.trace, self._track
        # every path below reads this slot on the full arena and rewrites
        # or frees it, so a resident sub-arena spanning it ends here (its
        # close scatters the sub-arena's last supersteps back first)
        self._invalidate_session(g)
        new_state, reward, term = env.step(slot.root_state, a)
        slot.moves_done += 1
        last = bool(term) or slot.moves_done >= slot.req.moves
        self._root_changed(slot.root_state, None if last else new_state)
        snap = old2new = None
        if self.reuse_subtree and not last:
            counts, _, old2new = self.exec.reroot_slot(g, a, trace, tid)
        else:
            with trace.span("snapshot", cat="commit", tid=tid):
                if last and slot.req.keep_tree:
                    snap = self.exec.slot_snapshot(g)
                    counts = snap["edge_N"][int(snap["root"])]
                else:
                    counts = self.exec.root_row(g)[2]
        counts = np.array(counts[: slot.cfg.F], np.int64)
        slot.res.actions.append(a)
        slot.res.rewards.append(float(reward))
        slot.res.visit_counts.append(counts)
        self.trace.instant("move-commit", cat="request", tid=self._track,
                           uid=slot.req.uid, move=slot.moves_done - 1,
                           action=a, last=last)
        if self.move_listener is not None:
            self.move_listener(MoveEvent(
                uid=slot.req.uid, move_index=slot.moves_done - 1, action=a,
                reward=float(reward), visit_counts=counts, last=last))
        if last:
            slot.res.terminal = bool(term)
            slot.res.tree_snapshot = snap
            self._finish(slot.res)
            self.slots[g] = None
            return
        # long-lived request: next move on the same slot
        slot.root_state = new_state
        slot.move_supersteps = 0
        if old2new is not None:   # re-rooted on the chosen child's subtree
            self._m_reroots.inc()
            with trace.span("st-write", cat="commit", tid=tid):
                self.sts[g].compact(old2new)
            slot.prev_size = int(np.count_nonzero(old2new != NULL))
        else:  # paper-faithful full flush (or the child was never expanded)
            with trace.span("write-back", cat="commit", tid=tid):
                self.exec.reset_slot(g, max(env.num_actions(new_state), 1))
                if trace.enabled:
                    self.exec.block()
            with trace.span("st-write", cat="commit", tid=tid):
                self.sts[g].flush(new_state)
            slot.prev_size = 1

    def _root_changed(self, old, new) -> None:
        """Tell an env that keeps state per search root (sim.lm's root
        snapshots: ``root_changed``) that a root was admitted (old None),
        moved by a commit, or left its slot (new None)."""
        hook = getattr(self.env, "root_changed", None)
        if hook is not None:
            hook(old, new)

    def _finish(self, res: SearchResult):
        res.done_at = time.perf_counter()
        res.done_tick = self._now()
        self.completed.append(res)
        self.stats.completed += 1
        self._m_completed.inc()
        status = ("evicted" if res.deadline_evicted
                  else "cancelled" if res.cancelled else "done")
        self.trace.async_end("request", res.uid, cat="request",
                             tid=self._track, uid=res.uid, status=status,
                             moves=len(res.actions))
        if self.result_listener is not None:
            self.result_listener(res)

    # ---- drive to completion ----
    def run(self, max_supersteps: int = 100_000) -> list[SearchResult]:
        while (self.queue or self._active().any()) \
                and self.stats.supersteps < max_supersteps:
            if self.supersteps_per_dispatch > 1:
                if self.fused_dispatch() == 0:
                    break
            elif not self.superstep():
                break
        if self.overlap:   # a budget exit can leave a gang in flight
            self.drain_overlap()
        return self.completed

    def close(self):
        """Flush any in-flight gang and resident session, and release
        expansion-engine resources (process pool, if any)."""
        if self.overlap and not self.retired:
            self.drain_overlap()
        self._close_session()
        if self._owns_expander:
            self.expander.close()
