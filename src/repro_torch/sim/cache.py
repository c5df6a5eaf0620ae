"""Value/prior transposition cache for the simulation serving layer
(the port of repro.sim.cache).

Re-expanded positions skip inference entirely: tree-parallel MCTS with
subtree reuse and multi-slot self-play re-evaluates the same positions
constantly (every reroot re-expands the committed child's subtree, and
G concurrent self-play games walk overlapping openings), so a small LRU
in front of the NN backend converts that redundancy into cache hits.

Keying: entries are keyed by the raw BYTES of the state row, not by
StateTable node ids — node ids are slot-local and recycled across
flush/reroot/compaction, so state content is the only transposition
identity that is stable across slots, pools, and re-expansions of the
same position.  (For Gomoku the row embeds player-to-move, so the
canonical perspective is part of the key for free.)

Hit/miss/evict counters live in the MetricsRegistry (``sim_cache_*``);
``bind_metrics`` rebinds them onto a client's registry after
construction (SearchClient does this for any ``sim_backend`` that
exposes the hook).
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np

from repro_torch.obs.metrics import NULL_REGISTRY

__all__ = ["SimCache", "CachedSimBackend"]


class SimCache:
    """Bounded LRU: state-content bytes -> (value, priors-row | None).

    Stored results are copies and returned as-is, so a hit is
    bit-identical to the cold evaluate that populated it.
    """

    def __init__(self, capacity: int = 4096, metrics=None):
        if capacity <= 0:
            raise ValueError(f"cache capacity must be positive: {capacity}")
        self.capacity = int(capacity)
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.bind_metrics(metrics)

    def bind_metrics(self, metrics) -> None:
        reg = NULL_REGISTRY if metrics is None else metrics
        self._m_hits = reg.counter(
            "sim_cache_hits_total", "sim-cache lookups served from cache")
        self._m_miss = reg.counter(
            "sim_cache_misses_total", "sim-cache lookups sent to inference")
        self._m_evict = reg.counter(
            "sim_cache_evictions_total", "sim-cache LRU evictions")
        self._m_size = reg.gauge(
            "sim_cache_entries", "sim-cache resident entries")

    @staticmethod
    def key(state: np.ndarray) -> bytes:
        return np.ascontiguousarray(state).tobytes()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: bytes) -> Optional[tuple]:
        hit = self._entries.get(key)
        if hit is None:
            self._m_miss.inc()
            return None
        self._entries.move_to_end(key)
        self._m_hits.inc()
        return hit

    def put(self, key: bytes, value, prior) -> None:
        if key in self._entries:
            self._entries.move_to_end(key)
        self._entries[key] = (
            np.float32(value),
            None if prior is None else np.array(prior, copy=True))
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self._m_evict.inc()
        self._m_size.set(len(self._entries))


class _PendingCached:
    """Ticket from CachedSimBackend.submit(): the per-row hit results
    plus the inner backend's in-flight handle for the miss rows."""

    __slots__ = ("keys", "hits", "miss_idx", "miss_states", "inner", "n")

    def __init__(self, keys, hits, miss_idx, miss_states, inner, n):
        self.keys = keys
        self.hits = hits                # row index -> (value, prior) | None
        self.miss_idx = miss_idx
        self.miss_states = miss_states
        self.inner = inner              # ticket | token | None
        self.n = n


class CachedSimBackend:
    """SimulationBackend wrapper: hits skip inference entirely; misses go
    to the inner backend as one batch.  Keeps the non-blocking
    submit/collect split when the inner backend has one (SimServer), so
    a caching server still overlaps device work with batch assembly.

    Caching is semantics-free when the inner backend's per-row results
    are batch-composition independent (SimServer pads every microbatch
    to a fixed shape precisely so this holds): cache-on and cache-off
    runs return bit-identical values/priors for every request stream —
    pinned by tests/test_executor_matrix.py's NN differential leg.
    """

    def __init__(self, inner, capacity: int = 4096, metrics=None):
        self.inner = inner
        self.cache = SimCache(capacity, metrics)

    def bind_metrics(self, metrics) -> None:
        self.cache.bind_metrics(metrics)
        if hasattr(self.inner, "bind_metrics"):
            self.inner.bind_metrics(metrics)

    # ---- non-blocking split ----
    def submit(self, states: np.ndarray, priority: Optional[str] = None):
        states = np.asarray(states)
        keys = [SimCache.key(states[i]) for i in range(len(states))]
        hits = [self.cache.get(k) for k in keys]
        miss_idx = [i for i, h in enumerate(hits) if h is None]
        miss_states = states[np.asarray(miss_idx)] if miss_idx else None
        inner = None
        if miss_idx:
            if callable(getattr(self.inner, "submit", None)):
                inner = self.inner.submit(miss_states, priority=priority)
            elif callable(getattr(self.inner, "dispatch", None)):
                inner = self.inner.dispatch(miss_states)
            # else: evaluate-only inner — computed at collect()
        return _PendingCached(keys, hits, miss_idx, miss_states, inner,
                              len(states))

    def collect(self, pending: _PendingCached):
        values = np.zeros(pending.n, np.float32)
        priors = None

        def _prior_row(row, pr):
            nonlocal priors
            if pr is None:
                return
            if priors is None:
                priors = np.zeros((pending.n, len(pr)),
                                  np.asarray(pr).dtype)
            priors[row] = pr

        if pending.miss_idx:
            if callable(getattr(self.inner, "collect", None)) \
                    and pending.inner is not None:
                mv, mp = self.inner.collect(pending.inner)
            elif callable(getattr(self.inner, "finalize", None)):
                mv, mp = self.inner.finalize(pending.inner,
                                             pending.miss_states)
            else:
                mv, mp = self.inner.evaluate(pending.miss_states)
            for j, row in enumerate(pending.miss_idx):
                pr = None if mp is None else mp[j]
                values[row] = mv[j]
                _prior_row(row, pr)
                self.cache.put(pending.keys[row], mv[j], pr)
        for row, hit in enumerate(pending.hits):
            if hit is not None:
                values[row] = hit[0]
                _prior_row(row, hit[1])
        return values, priors

    # ---- blocking protocol surface ----
    def evaluate(self, states: np.ndarray):
        return self.collect(self.submit(states))
