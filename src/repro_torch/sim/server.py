"""SimServer — microbatched policy/value inference behind one
fixed-shape forward (the port of repro.sim.server).

The paper's Fig. 5 observation made operational: per-worker batch-1 DNN
inference leaves throughput on the table, so the serving layer owns ONE
admission window and coalesces every caller's simulation rows —
cross-pool fused evaluates, overlap-mode gang submits, plain per-pool
supersteps — into fixed-shape microbatches before they reach the model.

Mechanics:

  * admission window — submitted rows queue per priority class
    (interactive > batch > self-play, FIFO within a class); a microbatch
    flushes as soon as ``max_batch`` rows are queued, and ``poll()``
    flushes a partial batch once the oldest row has waited ``max_wait``.
    ``collect()`` force-flushes whatever its ticket still needs, so a
    synchronous caller never deadlocks on the window.
  * fixed-shape padding — every microbatch is padded (with copies of its
    first row) to exactly ``max_batch`` rows before dispatch, so the
    forward always runs at one shape and, more importantly, each row's
    result is independent of which other rows shared its batch.  That
    batch-composition independence is what makes the transposition cache
    (sim.cache) and the cross-pool coalescing semantics-free: cache-on /
    cache-off and any submit interleaving return bit-identical per-row
    results (tests/test_sim.py, tests/test_executor_matrix.py).
  * non-blocking split — ``submit`` returns a ticket after (at most)
    dispatching full microbatches; for backends exposing the
    dispatch/finalize split (envs.policy_net.NNSimBackend) the device
    work is in flight while later submits still assemble.
    ``collect`` redeems the ticket; ``evaluate`` is submit + collect,
    keeping the plain SimulationBackend protocol.

Telemetry (``sim_server_*``) lands in the MetricsRegistry passed at
construction or bound later via ``bind_metrics`` (SearchClient binds its
own registry onto any sim backend exposing the hook).
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np

from repro_torch.obs.metrics import NULL_REGISTRY

__all__ = ["PRIORITY_CLASSES", "PendingBatch", "SimServer"]

#: admission order: interactive rows pack into a microbatch before batch
#: rows, which pack before self-play rows
PRIORITY_CLASSES = ("interactive", "batch", "self-play")


class PendingBatch:
    """Ticket from SimServer.submit(); redeem with SimServer.collect()."""

    __slots__ = ("n", "values", "priors", "filled")

    def __init__(self, n: int):
        self.n = n
        self.values = np.zeros(n, np.float32)
        self.priors = None           # allocated at first prior-bearing row
        self.filled = 0

    @property
    def ready(self) -> bool:
        return self.filled >= self.n


class _Micro:
    """One flushed microbatch: padded states, in-flight device token (for
    dispatch-capable backends), and each real row's destination."""

    __slots__ = ("states", "n_real", "dst", "token")

    def __init__(self, states, n_real, dst, token):
        self.states = states
        self.n_real = n_real
        self.dst = dst               # [(ticket, row_in_ticket), ...]
        self.token = token


class SimServer:
    def __init__(self, backend, max_batch: int = 64,
                 max_wait_us: float = 200.0,
                 default_priority: str = "batch", metrics=None):
        if max_batch <= 0:
            raise ValueError(f"max_batch must be positive: {max_batch}")
        if default_priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority class {default_priority!r}: one of "
                f"{PRIORITY_CLASSES}")
        self.backend = backend
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_us) * 1e-6
        self.default_priority = default_priority
        # per-class FIFO of (state_row, ticket, row_in_ticket, t_arrival)
        self._queues = {c: collections.deque() for c in PRIORITY_CLASSES}
        self._queued = 0
        self._micros: collections.deque = collections.deque()
        self._can_dispatch = callable(getattr(backend, "dispatch", None)) \
            and callable(getattr(backend, "finalize", None))
        self.bind_metrics(metrics)

    def bind_metrics(self, metrics) -> None:
        """This server's telemetry into `metrics`, and the backend's where
        it keeps its own (``bind_metrics``)."""
        if metrics is not None and hasattr(self.backend, "bind_metrics"):
            self.backend.bind_metrics(metrics)
        reg = NULL_REGISTRY if metrics is None else metrics
        self._m_batches = reg.counter(
            "sim_server_batches_total", "microbatches dispatched")
        self._m_rows = {c: reg.counter(
            "sim_server_rows_total", "simulation rows admitted",
            priority=c) for c in PRIORITY_CLASSES}
        self._m_fill = reg.histogram(
            "sim_server_batch_fill", "real rows per dispatched microbatch")
        self._m_queue = reg.gauge(
            "sim_server_queue_depth", "rows waiting in the admission window")
        self._m_partial = reg.counter(
            "sim_server_partial_flushes_total",
            "microbatches flushed below max_batch (window close / collect)")

    def bind_tracer(self, tracer) -> None:
        """The backend's spans into `tracer`, where it records any."""
        if hasattr(self.backend, "bind_tracer"):
            self.backend.bind_tracer(tracer)

    # ---- protocol: non-blocking split ----
    def submit(self, states: np.ndarray,
               priority: Optional[str] = None) -> PendingBatch:
        """Enqueue a batch of simulation rows; returns the ticket.  Full
        microbatches are dispatched before returning (device work starts
        now for dispatch-capable backends); partial tails stay queued for
        later callers to pack into."""
        if priority is None:
            priority = self.default_priority
        if priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority class {priority!r}: one of "
                f"{PRIORITY_CLASSES}")
        states = np.asarray(states)
        ticket = PendingBatch(len(states))
        q = self._queues[priority]
        now = time.perf_counter()
        for i in range(len(states)):
            q.append((states[i], ticket, i, now))
        self._queued += len(states)
        self._m_rows[priority].inc(len(states))
        while self._queued >= self.max_batch:
            self._flush()
        self._m_queue.set(self._queued)
        return ticket

    def collect(self, ticket: PendingBatch):
        """Redeem a ticket: finalize in-flight microbatches (dispatch
        order) and force-flush any of the ticket's rows still queued.
        Returns (values [n], priors [n, A] | None)."""
        while not ticket.ready:
            if self._micros:
                self._finalize(self._micros.popleft())
            elif self._queued:
                self._flush()            # partial, padded to max_batch
            else:
                raise RuntimeError(
                    "collect() on a ticket with no queued or in-flight "
                    "rows — was it already collected?")
        self._m_queue.set(self._queued)
        return ticket.values, ticket.priors

    def poll(self) -> None:
        """Close the admission window if due: dispatch full microbatches,
        and flush a partial one once the oldest queued row has waited
        max_wait.  For callers that submit from an event loop; the
        superstep-driven serving path closes windows via collect()."""
        while self._queued >= self.max_batch:
            self._flush()
        heads = [q[0][3] for q in self._queues.values() if q]
        if heads and time.perf_counter() - min(heads) >= self.max_wait_s:
            self._flush()
        self._m_queue.set(self._queued)

    # ---- protocol: blocking compatibility surface ----
    def evaluate(self, states: np.ndarray):
        return self.collect(self.submit(states))

    # ---- internals ----
    def _flush(self) -> None:
        """Assemble one microbatch (priority order, FIFO within class),
        pad it to max_batch with copies of its first row — always a
        valid state, and row independence keeps real rows unaffected —
        and start the backend forward."""
        rows, dst = [], []
        for cls in PRIORITY_CLASSES:
            q = self._queues[cls]
            while q and len(rows) < self.max_batch:
                state, ticket, i, _ = q.popleft()
                rows.append(state)
                dst.append((ticket, i))
        if not rows:
            return
        self._queued -= len(rows)
        n_real = len(rows)
        if n_real < self.max_batch:
            rows.extend([rows[0]] * (self.max_batch - n_real))
            self._m_partial.inc()
        states = np.stack(rows)
        token = self.backend.dispatch(states) if self._can_dispatch else None
        self._micros.append(_Micro(states, n_real, dst, token))
        self._m_batches.inc()
        self._m_fill.observe(n_real)

    def _finalize(self, micro: _Micro) -> None:
        if self._can_dispatch:
            values, priors = self.backend.finalize(micro.token, micro.states)
        else:
            values, priors = self.backend.evaluate(micro.states)
        for j, (ticket, row) in enumerate(micro.dst):
            ticket.values[row] = values[j]
            if priors is not None:
                if ticket.priors is None:
                    ticket.priors = np.zeros(
                        (ticket.n, priors.shape[1]), priors.dtype)
                ticket.priors[row] = priors[j]
            ticket.filled += 1
