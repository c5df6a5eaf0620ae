"""The closed loop: clients that each wait for their search before the
next, as self-play workers and game servers do.

Each client holds one search.  A move is asked when its search is
submitted (the first) or when the previous move commits (the rest), and
answered when the harness sees its commit after a scheduler tick; its
latency runs from ask to answer.  The slot a search was admitted to is
noted when first seen (for the check's sample, which covers every
slot).  When a search ends its client submits the next at once, while
asking is open.

`window()` measures from its call to the end of the first tick past the
close.  No search is submitted from the close on, and `drain()` waits
for every move asked before the close; a search is cancelled once its
in-window move has committed, so nothing asked later runs.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class Search:
    spec: dict
    client: int
    asks: list          # ask time of each move asked so far
    commits: list = dataclasses.field(default_factory=list)
    moves: list = dataclasses.field(default_factory=list)  # (action, visits)
    slot: object = None  # (pool, slot index) it was admitted to


class ClosedLoop:
    def __init__(self, system, specs, n_clients: int):
        self.system, self.specs = system, specs
        self.client = system.client
        self.n_clients = n_clients
        self.searches: list = []
        self.live: dict = {}
        self.t0 = self.t1 = self.t2 = None

    def _submit(self, client: int, t: float) -> None:
        spec = self.specs.next()
        s = Search(spec=spec, client=client, asks=[t])
        self.searches.append(s)
        self.live[spec["uid"]] = s
        self.client.submit(self.system.request(spec))

    def start(self) -> None:
        t = time.perf_counter()
        for c in range(self.n_clients):
            self._submit(c, t)

    def _slots(self) -> dict:
        """{uid: (pool, slot index)} of the searches in the pools' slots
        now; empty where the pools do not show their slots."""
        out = {}
        pools = getattr(self.client.core, "pools", {})
        for key, pool in enumerate(pools.values()):
            for g, held in enumerate(getattr(pool, "slots", ())):
                req = getattr(held, "req", None)
                if req is not None:
                    out[req.uid] = (key, g)
        return out

    def _observe(self, t: float, asking: bool) -> None:
        core = self.client.core
        if any(s.slot is None for s in self.live.values()):
            slots = self._slots()
            for uid, s in self.live.items():
                if s.slot is None:
                    s.slot = slots.get(uid)
        for uid, s in list(self.live.items()):
            log = core.move_log.get(uid, ())
            while len(s.moves) < len(log):
                ev = log[len(s.moves)]
                s.moves.append((int(ev.action), np.asarray(ev.visit_counts)))
                s.commits.append(t)
                if not ev.last:
                    s.asks.append(t)
            if uid in core.results:
                del self.live[uid]
                if asking:
                    self._submit(s.client, t)
            elif self.t1 is not None and s.asks[-1] >= self.t1:
                # its in-window move is in: nothing asked later runs
                self.client.handle(uid).cancel()
                del self.live[uid]

    def _tick(self) -> float:
        if not self.client.poll(1):
            raise RuntimeError("the scheduler drained with searches live")
        return time.perf_counter()

    def warm(self, ticks: int) -> None:
        """Run the loop until the scheduler's clock passes `ticks`
        supersteps: the kernels, graphs and buffers of this traffic's
        shapes are made, and the slots hold searches of mixed ages."""
        while self.client.core.ticks < ticks:
            self._observe(self._tick(), asking=True)

    def window(self, seconds: float, hook=None) -> None:
        self.t0 = time.perf_counter()
        close = self.t0 + seconds
        while True:
            t = self._tick()
            last = t >= close
            self._observe(t, asking=not last)
            if hook is not None:
                hook(t, last)
            if last:
                self.t1 = t
                return

    def drain(self, limit_s: float) -> None:
        """Wait for every move asked before the close, up to `limit_s`
        past it; a move still out then has failed, and its search is
        cancelled."""
        self._observe(self.t1, asking=False)
        while self.live and time.perf_counter() < self.t1 + limit_s:
            self._observe(self._tick(), asking=False)
        for uid in list(self.live):
            self.client.handle(uid).cancel()
            del self.live[uid]
        self.t2 = time.perf_counter()

    # ---- what the window saw ----
    def asked(self) -> list:
        """(search, move index) of every move asked inside the window."""
        return [(s, i) for s in self.searches for i, t in enumerate(s.asks)
                if self.t0 <= t < self.t1]

    def committed(self) -> list:
        """(search, move index) of every move committed inside it."""
        return [(s, i) for s in self.searches for i, t in enumerate(s.commits)
                if self.t0 <= t <= self.t1]

    def latency_s(self, s: Search, i: int) -> float:
        """Ask to commit; a move that never came counts until the drain
        gave up on it."""
        end = s.commits[i] if i < len(s.commits) else self.t2
        return end - s.asks[i]
