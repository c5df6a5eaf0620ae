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
              * advanced in place: core.reroot extracts the chosen child's
                subtree (statistics preserved) and the search continues on
                the same slot for its next move.
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

Timing honesty: the phase timers fence the device (executor.block(),
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

Not ported yet, and refused at construction with NotImplementedError:
multi-device shards (``n_shards > 1``) and the overlap mode's pipelined
gangs (``overlap=True``), ROADMAP.md queue A item 6.

Determinism: with a deterministic SimulationBackend the per-slot tree
evolution is bit-identical to a single-tree TreeParallelMCTS run of the
same request — scheduling changes WHEN a tree's supersteps happen, never
what they compute.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core import fixedpoint as fx
from repro_torch.core import reroot
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


def check_unported(n_shards: int = 1, overlap: bool = False) -> None:
    """Refuse the serving modes the port does not have yet, naming the
    ROADMAP.md queue A item that brings each."""
    if int(n_shards) > 1:
        raise NotImplementedError(
            "n_shards > 1 (multi-device shards) is not ported yet: ROADMAP.md "
            "queue A item 6")
    if overlap:
        raise NotImplementedError(
            "overlap=True (pipelined gangs) is not ported yet: ROADMAP.md "
            "queue A item 6")


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
    t_fused_device: float = 0.0  # device: CUDA events around the bodies
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
        overlap: bool = False,
        device=None,
    ):
        check_unported(n_shards, overlap)
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
        self.exec = self._make_executor()
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
                                    device=self.device)

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

    def _admit(self):
        limit = self.G if self.admit_limit is None \
            else max(0, min(self.admit_limit, self.G))
        active = sum(s is not None for s in self.slots)
        while self.queue and active < limit:
            g = next((g for g, s in enumerate(self.slots) if s is None), None)
            if g is None:
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
                               uid=req.uid, slot=g, wait=wait)
            active += 1

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
                # freeing the slot is a membership change: a resident
                # session spanning it must scatter + close first
                self._invalidate_session(g)
                self._mark_cancelled(slot.res, reason)
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

    def _slot_snapshot(self, g: int) -> dict:
        """Snapshot through the session: a dirty sub-arena is scattered
        back first, then the full arena is read as usual."""
        ses = self._session
        if ses is not None and ses.owns(int(g)) and ses.sync():
            self.stats.session_scatters += 1
            self._m_scatters.inc()
        return self.exec.slot_snapshot(g)

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

    # ---- superstep, paused at the Simulation boundary ----
    def begin_superstep(self) -> Optional[_PendingStep]:
        """Admission + Selection + Insertion + host expansion.  Returns
        the pending step carrying the fused simulation rows, or None when
        no slot is occupied.  The caller evaluates the rows (alone or
        fused with other pools') and hands them to finish_superstep."""
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
        t4 = time.perf_counter()

        with self.trace.span("backup", cat="phase", tid=self._track,
                             slots=len(act_idx)):
            ex.finalize(fin_nodes, fin_na, fin_term, fin_pp, fin_pf)
            ex.backup(pend.ex_active, pend.sel_dev, sim_nodes, vals,
                      self.alternating_signs)
            if self.trace.enabled:
                ex.block()   # fence: device backup time stays in this span
        if ex is not self.exec:
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
        the host expansion path)."""
        return (self.exec is not None and not self.cfg.expand_all
                and hasattr(self.exec, "run_supersteps")
                and has_device_env(self.env) and has_device_sim(self.sim))

    def fused_dispatch(self, max_supersteps: Optional[int] = None) -> int:
        """Run up to min(supersteps_per_dispatch, max_supersteps) BSP
        supersteps in ONE device dispatch, escaping early at a
        move-commit boundary or an expansion the env's device twin
        cannot resolve (that superstep is then completed through the
        ordinary host path, so every escape stays on the K=1 oracle
        trajectory).  Falls back to a single phase-by-phase superstep
        when K <= 1 or the pool is not fused-capable.  Returns the number
        of complete supersteps executed (0 when no slot is occupied)."""
        K = self.supersteps_per_dispatch
        if max_supersteps is not None:
            K = min(K, max(1, int(max_supersteps)))
        if K <= 1 or not self.fused_capable():
            return 1 if self.superstep() else 0
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
        ex, ex_active, rows, act_idx = self._pick_execution(active)
        return self._fused_dispatch_one(ex, ex_active, rows, act_idx, K,
                                        on_sub=ex is not self.exec, tok=tok)

    def _fused_dispatch_one(self, ex, ex_active, rows, act_idx, K: int,
                            on_sub: bool, tok) -> int:
        """One fused device dispatch on the whole arena (masked) or on a
        session's sub-arena (`on_sub`), with its escape handled: a commit
        exit replays _commit_moves exactly like the K=1 path, an
        expansion escape completes the partial superstep through the
        ordinary host path.  Returns the superstep count."""
        t0 = time.perf_counter()
        budget_left, states, start_size = self._fused_upload(
            ex, rows, act_idx)
        pend = ex.run_supersteps_submit(ex_active, self.p, K, self.env,
                                        self.sim, states, budget_left,
                                        self.alternating_signs)
        t1 = time.perf_counter()
        disp = ex.run_supersteps_collect(pend)
        t2 = time.perf_counter()
        self.stats.t_fused_submit += t1 - t0
        self.stats.t_fused_collect += t2 - t1
        self.stats.t_fused_device += 1e-3 * (disp.device_ms or 0.0)
        n = self._fused_finish_one(ex, ex_active, rows, act_idx, disp,
                                   start_size, on_sub, tok, t0)
        self.stats.t_fused_finish += time.perf_counter() - t2
        return n

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
                          start_size, on_sub: bool, tok, t0: float) -> int:
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
                t_intree=t1 - t0, t_host=t2 - t1, tok=tok)
            t3 = time.perf_counter()
            values, priors = self._sim_evaluate(sim_states)
            self.finish_superstep(pend, values, priors,
                                  t_sim=time.perf_counter() - t3)
            return n + 1
        self.stats.supersteps += n
        self.stats.occupancy_sum += n * A / self.G
        self.stats.t_intree += t1 - t0
        self._m_supersteps.inc(n)
        self._commit_moves(act_idx)
        if tok is not None:
            self.trace.end(tok)
        return n

    # ---- move boundary: commit / advance / evict ----
    def _commit_moves(self, act_idx):
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
            self._advance(g, int(best[g]))

    def _advance(self, g: int, a: int):
        slot, env = self.slots[g], self.env
        snap = self._slot_snapshot(g)
        # every path below rewrites or frees this slot on the full arena,
        # so a resident sub-arena spanning it must end now (its final
        # state was just scattered by the snapshot sync)
        self._invalidate_session(g)
        root = int(snap["root"])
        counts = np.array(snap["edge_N"][root][: slot.cfg.F], np.int64)
        new_state, reward, term = env.step(slot.root_state, a)
        slot.res.actions.append(a)
        slot.res.rewards.append(float(reward))
        slot.res.visit_counts.append(counts)
        slot.moves_done += 1
        last = bool(term) or slot.moves_done >= slot.req.moves
        self.trace.instant("move-commit", cat="request", tid=self._track,
                           uid=slot.req.uid, move=slot.moves_done - 1,
                           action=a, last=last)
        if self.move_listener is not None:
            self.move_listener(MoveEvent(
                uid=slot.req.uid, move_index=slot.moves_done - 1, action=a,
                reward=float(reward), visit_counts=counts, last=last))
        if last:
            slot.res.terminal = bool(term)
            if slot.req.keep_tree:
                slot.res.tree_snapshot = snap
            self._finish(slot.res)
            self.slots[g] = None
            return
        # long-lived request: next move on the same slot
        slot.root_state = new_state
        slot.move_supersteps = 0
        new_root = int(snap["child"][root, a])
        if self.reuse_subtree and new_root != NULL:
            arrays, old2new = reroot.reroot(self.cfg, snap, new_root)
            self.exec.write_slot(g, arrays)
            self.sts[g].compact(old2new)
            slot.prev_size = int(arrays["size"])
        else:  # paper-faithful full flush
            self.exec.reset_slot(g, max(env.num_actions(new_state), 1))
            self.sts[g].flush(new_state)
            slot.prev_size = 1

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
        return self.completed

    def close(self):
        """Flush any resident session and release expansion-engine
        resources (process pool, if any)."""
        self._close_session()
        if self._owns_expander:
            self.expander.close()
