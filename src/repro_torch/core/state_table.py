"""State Table (paper §III-A) — host-resident environment-state store.

The ST is the second half of the paper's tree decomposition: a table of X
entries indexed by UCT node id, holding the application-specific
environment state (256 B for Pong, 432 B for Gomoku in the paper).  It
stays in host memory; only node indices cross the host<->accelerator link
(O(p) per superstep instead of O(p*gamma)).

Concurrency (paper §III-B): within a BSP superstep all writes target
*distinct, freshly allocated* node ids and no read depends on another
worker's write, so the table needs no synchronization.  Here that shows up
as plain vectorized numpy fancy-indexing — the invariant is asserted.
"""

from __future__ import annotations

import numpy as np


class StateTable:
    def __init__(self, capacity: int, state_shape: tuple, dtype=np.float32):
        self.capacity = capacity
        self.data = np.zeros((capacity,) + tuple(state_shape), dtype=dtype)
        self.valid = np.zeros(capacity, dtype=bool)
        # traffic accounting for the Fig. 4 analogue (ST ops on CPU)
        self.bytes_read = 0
        self.bytes_written = 0

    @property
    def state_bytes(self) -> int:
        return int(self.data[0].nbytes)

    def read(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, dtype=np.int64)
        assert self.valid[idx].all(), "ST read of unwritten entry"
        self.bytes_read += int(idx.size) * self.state_bytes
        return self.data[idx]

    def write(self, idx: np.ndarray, states: np.ndarray):
        idx = np.asarray(idx, dtype=np.int64)
        assert np.unique(idx).size == idx.size, (
            "ST write collision — violates the paper's distinct-expansion invariant")
        self.data[idx] = states
        self.valid[idx] = True
        self.bytes_written += int(idx.size) * self.state_bytes

    def flush(self, new_root_state: np.ndarray):
        """Tree Flush (paper §IV-E): drop everything, entry 0 = new root."""
        self.valid[:] = False
        self.data[0] = new_root_state
        self.valid[0] = True
        self.bytes_written += self.state_bytes

    def compact(self, old2new: np.ndarray):
        """Subtree-reusing flush (core.reroot): relocate surviving entries
        to their new ids, invalidate the rest."""
        keep = np.flatnonzero(old2new >= 0)
        new_ids = old2new[keep]
        data = np.zeros_like(self.data)
        valid = np.zeros_like(self.valid)
        data[new_ids] = self.data[keep]
        valid[new_ids] = self.valid[keep]
        self.data, self.valid = data, valid
        self.bytes_written += int(len(keep)) * self.state_bytes

    def nbytes(self) -> int:
        return int(self.data.nbytes)
