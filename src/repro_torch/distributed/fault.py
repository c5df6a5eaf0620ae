"""Fault tolerance and straggler mitigation policies (a copy of
repro.distributed.fault, which is numpy only).

Two layers:

1. **Training** (LM substrate): checkpoint/restart via
   distributed.checkpoint (atomic, elastic across meshes) + deterministic
   data order (data pipeline is seeded by step index, so replay after
   restart consumes the identical batches).

2. **MCTS serving** (the paper's system): the BSP superstep itself is the
   natural fault boundary.  Virtual loss makes a *dropped* worker safe:
   its VL is simply recovered by a compensating backup with V drawn from
   the current edge mean (or discarded wholesale at the next Tree Flush).
   BSPFaultPolicy implements the paper-consistent policy:

     * straggler mitigation: a superstep commits when `quorum` of p
       simulation results arrived before `timeout`; missing workers'
       backups are replaced by VL-recovery-only updates (edge stats get
       their virtual loss removed, no reward contribution) — equivalent
       to the worker never having been dispatched, so the UCT invariants
       (VL==0, O==0 at quiescence) still hold;
     * worker failure: same mechanism, permanently masking the worker slot
       (elastic p).

HeartbeatMonitor is the host-side liveness tracker used by the launcher;
in this single-host container it is exercised by tests with synthetic
clocks.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core import fixedpoint as fx


@dataclasses.dataclass
class HeartbeatMonitor:
    """Tracks per-worker liveness from heartbeat timestamps."""

    n_workers: int
    timeout_s: float = 5.0

    def __post_init__(self):
        self.last_beat = np.zeros(self.n_workers, dtype=np.float64)
        self.alive = np.ones(self.n_workers, dtype=bool)

    def beat(self, worker: int, now: float | None = None):
        self.last_beat[worker] = time.time() if now is None else now

    def sweep(self, now: float | None = None) -> np.ndarray:
        now = time.time() if now is None else now
        self.alive = (now - self.last_beat) <= self.timeout_s
        return self.alive

    def mark_dead(self, worker: int):
        self.alive[worker] = False


class BSPFaultPolicy:
    """Commit rule for a Tree-Parallel MCTS superstep under stragglers.

    Given per-worker completion flags, produce the (values, mask) pair for
    the backup phase: masked workers get a VL-recovery-only backup
    (value contribution 0 and edge_N not incremented — implemented by the
    driver re-running backup with a worker mask).
    """

    def __init__(self, p: int, quorum: float = 0.75):
        self.p = p
        self.quorum = quorum

    def commit_mask(self, done: np.ndarray) -> tuple[bool, np.ndarray]:
        """(should_commit, mask). should_commit is False until quorum."""
        frac = float(done.mean()) if len(done) else 0.0
        return frac >= self.quorum, done.copy()

    def masked_values(self, values: np.ndarray, mask: np.ndarray):
        """Values for backup: masked-out workers contribute 0 reward; the
        driver pairs this with `recover_only` so their edge_N stays 0."""
        vals = np.where(mask, values, 0.0).astype(np.float32)
        return np.asarray(fx.encode(vals), np.int32), ~mask
