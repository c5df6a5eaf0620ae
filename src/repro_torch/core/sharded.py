"""ShardedExecutor — one InTreeExecutor over D per-device child arenas
(the port of repro.core.sharded).

Everything above this module keeps talking about "G slots"; this module
makes those G slots mean "D devices x G_shard slots each".  The serving
pool's slot axis is partitioned into D contiguous runs — slot g is owned
by shard g // G_shard — and each shard holds its own child executor
(TorchExecutor / CudaExecutor / ReferenceExecutor) whose arena lives on
one device (launch.mesh.serving_devices: shard d on
``cuda:(d % device_count)``; every shard on the CPU with
``device="cpu"``).  Dispatch is explicit per device: each protocol call
slices its [G]-leading arguments into per-shard blocks, invokes every
child — each child's kernels go on its own device's current stream, so
every shard's work is queued before any host read — and reassembles the
[G]-shaped result on the host.  A shard with no active slot sits a phase
out (its part is None): an idle device launches nothing, and its rows,
which no caller reads, come back as padding.

Bit-identity: per-slot arithmetic is position- and device-independent
(the property masked and compacted execution already rely on), so a
sharded pool computes bit-identically to the single-arena pool for every
request — placement is scheduling, not semantics.

Compaction composes: `gather_sub` splits the (sorted) active-slot index
into its per-shard runs and gathers a dense pow2-padded sub-arena on
EACH shard, presented as one ShardedExecutor whose global rows [0, A)
are the active slots in slot order.  One CompactionSession over the
sharded executor therefore keeps one resident sub-arena per shard.

The fused K-superstep path stays per shard: the pool submits each
child's `run_supersteps_submit` and collects each with
`run_supersteps_collect` (each shard runs to its own commit or expansion
escape on its own device) — see ArenaPool.fused_dispatch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.tree import NULL, TreeConfig
from repro_torch.obs.trace import NULL_TRACER

__all__ = ["ShardedExecutor", "ShardedSelection", "make_sharded_executor"]


class ShardedSelection:
    """Per-shard selection results, kept opaque: the pool threads this
    back into insert/backup, which route each part to its own child."""

    __slots__ = ("parts",)

    def __init__(self, parts: list):
        self.parts = parts


class ShardedExecutor:
    """D per-device child executors behind the single-arena protocol.

    `shards` is a list of (child, lo, n) runs: global rows [lo, lo + n)
    map to child rows [0, n).  For the top-level executor every child is
    fully mapped (n == child.G); a gathered sub-executor may pad each
    child to its own power of two (n < child.G) and the global width G
    to the pool's requested pow2 (rows past the last run are padding no
    shard owns — callers only read rows the active mask covers).
    """

    def __init__(self, cfg: TreeConfig, G: int, shards: list):
        self.cfg, self.G = cfg, int(G)
        self.shards = list(shards)

    # ---- partition helpers ----
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def devices(self) -> list:
        """Per-shard device (None for host-side children)."""
        return [getattr(c, "device", None) for c, _, _ in self.shards]

    def _locate(self, g: int):
        for child, lo, n in self.shards:
            if lo <= g < lo + n:
                return child, int(g) - lo
        raise IndexError(f"slot {g} outside every shard run")

    def _child_active(self, active) -> list:
        """Per-shard active masks, None for a shard with no active slot
        (the first shard runs when every shard is idle, so a phase always
        has a part to shape its result)."""
        act = np.asarray(active, bool)
        out = []
        for child, lo, n in self.shards:
            a = np.zeros(child.G, bool)
            a[:n] = act[lo:lo + n]
            out.append(a if a.any() else None)
        if all(a is None for a in out):
            out[0] = np.zeros(self.shards[0][0].G, bool)
        return out

    @staticmethod
    def _pad_rows(arr, lo: int, n: int, child_G: int, fill):
        """Slice global rows [lo, lo+n) and pad to the child width."""
        a = np.asarray(arr)
        out = np.full((child_G,) + a.shape[1:], fill, a.dtype)
        out[:n] = a[lo:lo + n]
        return out

    def _gather_rows(self, parts: list, fill=0) -> np.ndarray:
        """Reassemble per-child [child.G, ...] arrays into one [G, ...]
        array (rows no part covers — padding, idle shards — keep
        `fill`)."""
        p0 = np.asarray(next(p for p in parts if p is not None))
        buf = np.full((self.G,) + p0.shape[1:], fill, p0.dtype)
        for (child, lo, n), part in zip(self.shards, parts):
            if part is not None:
                buf[lo:lo + n] = np.asarray(part)[:n]
        return buf

    # ---- device phases (fan out per shard, reassemble on the host) ----
    def selection(self, active: np.ndarray, p: int) -> ShardedSelection:
        acts = self._child_active(active)
        return ShardedSelection([
            None if a is None else child.selection(a, p)
            for (child, _, _), a in zip(self.shards, acts)])

    def sel_to_host(self, sel: ShardedSelection) -> dict:
        hosts = [None if s is None else child.sel_to_host(s)
                 for (child, _, _), s in zip(self.shards, sel.parts)]
        keys = next(h for h in hosts if h is not None)
        return {k: self._gather_rows([None if h is None else h[k]
                                      for h in hosts])
                for k in keys}

    def insert(self, active: np.ndarray, sel: ShardedSelection) -> np.ndarray:
        return self.insert_host(self.insert_dev(active, sel))

    def insert_dev(self, active: np.ndarray, sel: ShardedSelection) -> list:
        """Queue every shard's insert before any host read; the
        per-shard device id blocks come back as a list redeemed by
        insert_host (the overlap mode's staged device half)."""
        acts = self._child_active(active)
        return [None if a is None or s is None else child.insert_dev(a, s)
                for (child, _, _), a, s in zip(self.shards, acts, sel.parts)]

    def insert_host(self, parts: list) -> np.ndarray:
        return self._gather_rows(
            [None if p is None else child.insert_host(p)
             for (child, _, _), p in zip(self.shards, parts)], fill=NULL)

    def finalize(self, nodes, num_actions, terminal, prior_parent,
                 priors_fx):
        for child, lo, n in self.shards:
            if (np.all(np.asarray(nodes)[lo:lo + n] == NULL)
                    and np.all(np.asarray(prior_parent)[lo:lo + n] == NULL)):
                continue    # nothing of this shard's to finalize
            child.finalize(
                self._pad_rows(nodes, lo, n, child.G, NULL),
                self._pad_rows(num_actions, lo, n, child.G, 0),
                self._pad_rows(terminal, lo, n, child.G, 0),
                self._pad_rows(prior_parent, lo, n, child.G, NULL),
                self._pad_rows(priors_fx, lo, n, child.G, 0))

    def backup(self, active, sel: ShardedSelection, sim_nodes, values_fx,
               alternating: bool, dropped=None):
        acts = self._child_active(active)
        for (child, lo, n), a, s in zip(self.shards, acts, sel.parts):
            if a is None or s is None:
                continue
            child.backup(
                a, s,
                self._pad_rows(sim_nodes, lo, n, child.G, 0),
                self._pad_rows(values_fx, lo, n, child.G, 0),
                alternating,
                None if dropped is None
                else self._pad_rows(dropped, lo, n, child.G, 0))

    # ---- host-side slot access (route to the owning shard) ----
    def reset_slot(self, g: int, root_num_actions: int):
        child, r = self._locate(int(g))
        child.reset_slot(r, root_num_actions)

    def best_actions(self) -> np.ndarray:
        return self._gather_rows([c.best_actions()
                                  for c, _, _ in self.shards])

    def sizes(self) -> np.ndarray:
        return self._gather_rows([c.sizes() for c, _, _ in self.shards])

    def slot_snapshot(self, g: int) -> dict:
        child, r = self._locate(int(g))
        return child.slot_snapshot(r)

    @property
    def reroot_path(self) -> str:
        return self.shards[0][0].reroot_path

    def root_row(self, g: int) -> tuple:
        child, r = self._locate(int(g))
        return child.root_row(r)

    def reroot_slot(self, g: int, a: int, trace=NULL_TRACER,
                    tid: int = 0) -> tuple:
        child, r = self._locate(int(g))
        return child.reroot_slot(r, a, trace, tid)

    def block(self):
        for child, _, _ in self.shards:
            child.block()

    def release(self):
        for child, _, _ in self.shards:
            child.release()

    # ---- compaction (per-shard dense sub-arenas behind one session) ----
    def _shard_runs(self, slot_idx: np.ndarray):
        """Split a sorted global slot index into per-shard local runs."""
        idx = np.asarray(slot_idx, np.int64)
        for child, lo, n in self.shards:
            li = idx[(idx >= lo) & (idx < lo + n)] - lo
            if len(li):
                yield child, li

    def gather_sub(self, slot_idx: np.ndarray, Gc: int) -> "ShardedExecutor":
        subs, off = [], 0
        for child, li in self._shard_runs(slot_idx):
            c_gc = 1 << (len(li) - 1).bit_length()   # per-child pow2 pad
            subs.append((child.gather_sub(li, c_gc), off, len(li)))
            off += len(li)
        return ShardedExecutor(self.cfg, Gc, subs)

    def scatter_sub(self, sub: "ShardedExecutor", slot_idx: np.ndarray):
        parts = iter(sub.shards)
        for child, li in self._shard_runs(slot_idx):
            sub_child, _, _ = next(parts)
            child.scatter_sub(sub_child, li)

    def open_session(self, slot_idx: np.ndarray, Gc: int,
                     tracer=None, tid: int = 0):
        from repro_torch.core.executor import CompactionSession
        return CompactionSession(self, slot_idx, Gc, tracer=tracer, tid=tid)

    # ---- single-tree surface ----
    def init(self, root_num_actions: int):
        return self.shards[0][0].init(root_num_actions)

    def get_tree(self, g: int = 0):
        child, r = self._locate(int(g))
        return child.get_tree(r)

    def set_tree(self, tree, g: int = 0):
        child, r = self._locate(int(g))
        child.set_tree(tree, r)

    def snapshot(self, tree) -> dict:
        return self.shards[0][0].snapshot(tree)

    def best_action(self, tree) -> int:
        return self.shards[0][0].best_action(tree)


def make_sharded_executor(cfg: TreeConfig, G: int, name: str, n_shards: int,
                          devices: Optional[list] = None,
                          device=None) -> ShardedExecutor:
    """Partition G slots into n_shards per-device child executors.

    Equal contiguous runs (G must divide evenly); shard d's child arena
    lives on devices[d] — by default launch.mesh.serving_devices(n_shards,
    device), which wraps round-robin over the cards (or puts every shard
    on the CPU).  Reference children stay on the host (the numpy oracle
    has no device) but still get the D-way partition, so the pool's
    placement logic is executor-agnostic."""
    n_shards = int(n_shards)
    if G % n_shards:
        raise ValueError(
            f"G={G} does not divide into n_shards={n_shards} equal shard "
            f"runs — pick G as a multiple of the shard count")
    if devices is None:
        from repro_torch.launch.mesh import serving_devices
        devices = serving_devices(n_shards, device)
    if len(devices) < n_shards:
        raise ValueError(f"{len(devices)} devices for n_shards={n_shards}")
    from repro_torch.core.executor import make_intree_executor
    gs = G // n_shards
    return ShardedExecutor(cfg, G, [
        (make_intree_executor(cfg, gs, name, device=devices[d]), d * gs, gs)
        for d in range(n_shards)])
