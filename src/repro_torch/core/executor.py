"""In-tree executor stack: one protocol, every backend, any G.

The port of repro.core.executor:

  InTreeExecutor    — the protocol.  Every implementation drives G >= 1
                      tree slots through the device phases (Selection /
                      Insertion / finalize / BackUp) under a [G] active
                      mask; inactive slots come back bit-frozen.
                      TreeParallelMCTS is the G=1 client, the service
                      pools (repro_torch.service) the G > 1 client.
  ReferenceExecutor — the paper's CPU-only master process: one sequential
                      numpy MutableTree per slot.  Correctness oracle.
  TorchExecutor     — an arena of tensors on a device + the plain torch
                      ops of core.intree ("faithful", "relaxed",
                      "wavefront" selection variants).
  CudaExecutor      — the port's counterpart of PallasExecutor: Selection
                      (with the expansion assignment) and BackUp (with
                      the straggler mask) are the hand-written CUDA
                      kernels, one launch each per superstep; Insertion
                      and finalize are torch ops on the card.  On a CPU
                      arena the kernel wrappers run their plain versions.

Every device executor keeps its arena in place on its device and updates
it in place.  Node Insertion is split as in the JAX package: insert_dev
queues it and returns the device id block without reading anything
back, insert_host is the one blocking read, and insert() is the two back
to back.

Slot compaction: ``gather_sub`` copies the active slots into a dense
sub-executor of the same kind (padded to a power of two with copies of
the first member, which run masked off) and ``scatter_sub`` writes the
first A rows back.  ``open_session`` wraps the pair in a
CompactionSession that keeps the sub-arena resident across supersteps:
one gather when the active set forms, one scatter when it changes or a
snapshot is read.  Per-slot arithmetic is position-independent, so
compaction never changes what a slot computes.  A closed session
releases its sub-arena.

Fused K-superstep dispatch (core.fused): the device executors (not the
oracle, which keeps the phase-by-phase path on purpose) run up to K
supersteps per call with ``run_supersteps``, or split into the
non-blocking ``run_supersteps_submit`` and the blocking
``run_supersteps_collect``.  Each executor caches one FusedProgram (on
the cuda executor on a card: one captured CUDA graph of the superstep
body) for its arena, and drops it when its arena is released or the
program's key changes.  Sharding of the JAX module is a later slice of
the port (ROADMAP.md queue A item 6).
"""

from __future__ import annotations

from typing import Optional, Protocol

import numpy as np
import torch

from repro_torch.core import intree, ref_sequential as ref
from repro_torch.core.tree import (
    FIELDS, NULL, TreeConfig, UCTree, arena_set_slot, arena_slot, from_numpy,
    init_arena, init_tree, init_tree_arrays, resolve_device, to_numpy,
)
from repro_torch.obs.trace import NULL_TRACER

EXECUTOR_NAMES = ("reference", "faithful", "relaxed", "wavefront", "cuda")


class InTreeExecutor(Protocol):
    """The in-tree accelerator contract (paper §IV, lifted to G slots).

    `active` is a [G] bool mask, selection results / sim nodes / values
    carry a leading [G] axis, and finalize takes the fixed-width
    NULL-padded per-slot rows of HostExpansion.padded_finalize_args.
    """

    cfg: TreeConfig
    G: int

    def reset_slot(self, g: int, root_num_actions: int) -> None: ...
    def selection(self, active: np.ndarray, p: int): ...
    def insert(self, active: np.ndarray, sel) -> np.ndarray: ...
    def insert_dev(self, active: np.ndarray, sel): ...
    def insert_host(self, new_nodes) -> np.ndarray: ...
    def finalize(self, nodes, num_actions, terminal, prior_parent,
                 priors_fx) -> None: ...
    def backup(self, active, sel, sim_nodes, values_fx, alternating: bool,
               dropped=None) -> None: ...
    def sel_to_host(self, sel) -> dict: ...
    def best_actions(self) -> np.ndarray: ...
    def sizes(self) -> np.ndarray: ...
    def slot_snapshot(self, g: int) -> dict: ...
    def write_slot(self, g: int, arrays: dict) -> None: ...
    def block(self) -> None: ...
    def release(self) -> None: ...
    # OPTIONAL fused fast path (device executors only; absence of the
    # method is what keeps a pool on the phase-by-phase path): up to K
    # supersteps per call, see core.fused.  Mutates the arena in place
    # and returns a FusedDispatch; run_supersteps ==
    # run_supersteps_collect(run_supersteps_submit(...)).
    # def run_supersteps(self, active, p, K, env, sim, states,
    #                    budget_left, alternating) -> FusedDispatch: ...
    def gather_sub(self, slot_idx: np.ndarray, Gc: int) -> "InTreeExecutor": ...
    def scatter_sub(self, sub: "InTreeExecutor", slot_idx: np.ndarray) -> None: ...
    def open_session(self, slot_idx: np.ndarray, Gc: int,
                     tracer=None, tid: int = 0) -> "CompactionSession": ...
    # single-tree surface of the G=1 client
    def init(self, root_num_actions: int): ...
    def get_tree(self, g: int = 0): ...
    def set_tree(self, tree, g: int = 0) -> None: ...
    def snapshot(self, tree) -> dict: ...
    def best_action(self, tree) -> int: ...


class CompactionSession:
    """Device-resident dense sub-arena spanning one fixed active set
    (a copy of repro.core.executor.CompactionSession).

    Built on any executor's gather_sub/scatter_sub.  Lifecycle:

      open   — ONE gather_sub copies the active slots into `sub` (dense,
               pow2-padded); the session then stays resident.
      dirty  — `mark_superstep` records that `sub` holds updates the full
               arena has not seen; `sync` scatters them back WITHOUT
               closing (snapshot reads force this), after which `sub`
               keeps accumulating.
      close  — final sync + the session refuses further use.  The owning
               pool closes on any membership change (admit / evict) or
               content rewrite of a member slot (reroot / reset).

    `matches` is the reuse test: same slot set, same padded width, still
    open.  When tracing is live the gather and scatter are fenced with
    the executor's block() (torch.cuda.synchronize on a card), so their
    copy time stays inside their spans; untraced, nothing waits.
    """

    def __init__(self, parent: "InTreeExecutor", slot_idx: np.ndarray,
                 Gc: int, tracer=None, tid: int = 0):
        self.parent = parent
        self.slot_idx = np.asarray(slot_idx, np.int32).copy()
        self.Gc = int(Gc)
        self.trace = NULL_TRACER if tracer is None else tracer
        self.tid = tid
        with self.trace.span("compact-gather", cat="compact", tid=tid,
                             slots=len(self.slot_idx), Gc=self.Gc):
            self.sub = parent.gather_sub(self.slot_idx, self.Gc)
            if self.trace.enabled:
                self.sub.block()
        self.dirty = False
        self.open = True
        self.supersteps = 0

    @property
    def A(self) -> int:
        return len(self.slot_idx)

    def matches(self, slot_idx: np.ndarray, Gc: int) -> bool:
        return (self.open and self.Gc == int(Gc)
                and len(slot_idx) == self.A
                and bool(np.array_equal(self.slot_idx, slot_idx)))

    def owns(self, g: int) -> bool:
        return self.open and bool(np.any(self.slot_idx == g))

    def mark_superstep(self):
        assert self.open, "superstep on a closed CompactionSession"
        self.dirty = True
        self.supersteps += 1

    def sync(self) -> bool:
        """Scatter pending sub-arena updates back; True if one happened."""
        if self.dirty:
            with self.trace.span("compact-scatter", cat="compact",
                                 tid=self.tid, slots=len(self.slot_idx)):
                self.parent.scatter_sub(self.sub, self.slot_idx)
                if self.trace.enabled:
                    self.parent.block()
            self.dirty = False
            return True
        return False

    def close(self) -> bool:
        """Final sync, then the sub-arena is released (its tensors, and a
        fused dispatch's cached graph over them); the session is unusable
        afterwards.  True if the close actually scattered."""
        scattered = self.sync() if self.open else False
        if self.open:
            self.sub.release()
        self.open = False
        return scattered


def _padded(slot_idx: np.ndarray, Gc: int) -> np.ndarray:
    """The A member slots, then Gc - A filler copies of the first member
    (run masked off)."""
    idx = np.asarray(slot_idx, np.int64)
    return np.concatenate([idx, np.full(Gc - len(idx), idx[0], np.int64)])


class TorchExecutor:
    """G stacked trees on `device` + the plain torch in-tree ops."""

    def __init__(self, cfg: TreeConfig, G: int, variant: str = "faithful",
                 device=None, _trees: Optional[UCTree] = None):
        if variant not in intree.SELECT_VARIANTS:
            raise NotImplementedError(
                f"TorchExecutor variant {variant!r}: the plain torch paths "
                f"are {intree.SELECT_VARIANTS} (the hand-written kernels "
                "are CudaExecutor / executor='cuda')")
        self.cfg, self.G, self.variant = cfg, G, variant
        self.device = resolve_device(device)
        self.trees = (init_arena(cfg, G, device=self.device) if _trees is None
                      else _trees)
        self._fused = None      # cached core.fused.FusedProgram

    def _mask(self, active) -> torch.Tensor:
        return intree.as_mask(active, self.device)

    # -- device phases -------------------------------------------------
    def selection(self, active, p: int):
        return intree.select_arena(self.cfg, self.trees, self._mask(active),
                                   p, self.variant)

    def insert(self, active, sel) -> np.ndarray:
        return self.insert_host(self.insert_dev(active, sel))

    def insert_dev(self, active, sel) -> torch.Tensor:
        """Queue Node Insertion and return the DEVICE [G, p, Fp] id block
        without reading anything back."""
        return intree.insert_arena(self.cfg, self.trees, self._mask(active),
                                   sel)

    def insert_host(self, new_nodes) -> np.ndarray:
        """The blocking half of insert(): the id block on the host.
        insert() == insert_host(insert_dev(...)) bit for bit."""
        return new_nodes.cpu().numpy()

    def finalize(self, nodes, num_actions, terminal, prior_parent, priors_fx):
        intree.finalize_arena(self.trees, nodes, num_actions, terminal,
                              prior_parent, priors_fx)

    def backup(self, active, sel, sim_nodes, values_fx, alternating: bool,
               dropped=None):
        intree.backup_arena(self.cfg, self.trees, self._mask(active), sel,
                            sim_nodes, values_fx, alternating, dropped)

    # -- host-side slot access -----------------------------------------
    def reset_slot(self, g: int, root_num_actions: int):
        arena_set_slot(self.trees, g,
                       init_tree(self.cfg, root_num_actions, self.device))

    def sel_to_host(self, sel) -> dict:
        return sel if isinstance(sel, dict) else sel.to_host()

    def best_actions(self) -> np.ndarray:
        return intree.best_root_action_arena(self.trees).cpu().numpy()

    def sizes(self) -> np.ndarray:
        return self.trees.size.cpu().numpy()

    def slot_snapshot(self, g: int) -> dict:
        return to_numpy(arena_slot(self.trees, g))

    def write_slot(self, g: int, arrays: dict):
        arena_set_slot(self.trees, g, from_numpy(arrays, self.device))

    def block(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self):
        """Drop the arena's tensors and the fused program cached over them
        (cold-pool retirement, session close); the executor is unusable
        afterwards."""
        self.trees = None
        self._fused = None

    # -- fused multi-superstep dispatch (core.fused) -------------------
    def fused_program(self, p: int, env, sim, alternating: bool):
        """The FusedProgram for this arena, captured on first use and
        again whenever its key changes (the old one, and its graph, are
        dropped first)."""
        from repro_torch.core import fused

        key = fused.program_key(self.cfg, self.variant, self.trees, p, env,
                                sim, alternating)
        if self._fused is None or self._fused.key != key:
            self._fused = None
            self._fused = fused.FusedProgram(self.cfg, self.variant,
                                             self.trees, p, env, sim,
                                             alternating)
        return self._fused

    def run_supersteps(self, active, p: int, K: int, env, sim, states,
                       budget_left, alternating: bool):
        """Up to K fused supersteps (core.fused), in place on the arena.
        Returns the FusedDispatch."""
        return self.run_supersteps_collect(self.run_supersteps_submit(
            active, p, K, env, sim, states, budget_left, alternating))

    def run_supersteps_submit(self, active, p: int, K: int, env, sim, states,
                              budget_left, alternating: bool):
        """Non-blocking half of run_supersteps: queue the dispatch and
        return its PendingDispatch without a host read."""
        return self.fused_program(p, env, sim, alternating).submit(
            active, K, states, budget_left)

    def run_supersteps_collect(self, pend):
        """Blocking half: the one read of a submitted dispatch.
        run_supersteps == collect(submit(...))."""
        return pend.program.collect(pend)

    # -- compaction (gather active slots into a dense sub-arena) -------
    def _spawn(self, trees: UCTree, Gc: int) -> "TorchExecutor":
        return TorchExecutor(self.cfg, Gc, self.variant, device=self.device,
                             _trees=trees)

    def gather_sub(self, slot_idx: np.ndarray, Gc: int) -> "TorchExecutor":
        """A sub-executor of the same kind over contiguous copies of the
        member slots (the kernels' check_arena requires contiguous
        arrays), padded to Gc with copies of the first member."""
        gidx = torch.as_tensor(_padded(slot_idx, Gc), device=self.device)
        return self._spawn(self.trees.map(lambda a: a.index_select(0, gidx)),
                           Gc)

    def scatter_sub(self, sub: "TorchExecutor", slot_idx: np.ndarray):
        """Write the first A rows of `sub` back into their slots."""
        idx = torch.as_tensor(np.asarray(slot_idx, np.int64),
                              device=self.device)
        A = len(slot_idx)
        for k in FIELDS:
            getattr(self.trees, k).index_copy_(0, idx, getattr(sub.trees, k)[:A])

    def open_session(self, slot_idx: np.ndarray, Gc: int,
                     tracer=None, tid: int = 0) -> CompactionSession:
        return CompactionSession(self, slot_idx, Gc, tracer=tracer, tid=tid)

    # -- single-tree surface (G=1 driver / tests) -----------------------
    def init(self, root_num_actions: int) -> UCTree:
        return init_tree(self.cfg, root_num_actions, self.device)

    def get_tree(self, g: int = 0) -> UCTree:
        return arena_slot(self.trees, g)

    def set_tree(self, tree: UCTree, g: int = 0):
        arena_set_slot(self.trees, g, tree)

    def snapshot(self, tree) -> dict:
        return to_numpy(tree)

    def best_action(self, tree) -> int:
        return int(intree.best_root_action(tree))


class CudaExecutor(TorchExecutor):
    """Selection and BackUp as the hand-written CUDA kernels
    (kernels.uct_select / kernels.uct_backup), one launch each per
    superstep for all slots; Insertion and finalize as torch ops on the
    same device.  Straggler-masked backups run in the kernel too."""

    def __init__(self, cfg: TreeConfig, G: int, device=None,
                 _trees: Optional[UCTree] = None):
        super().__init__(cfg, G, "faithful", device=device, _trees=_trees)
        from repro_torch.kernels import ops as kops
        self._kops = kops
        self.variant = "cuda"

    def selection(self, active, p: int):
        return self._kops.select_arena(self.cfg, self.trees,
                                       np.asarray(active, np.int32), p)

    def backup(self, active, sel, sim_nodes, values_fx, alternating: bool,
               dropped=None):
        self._kops.backup_arena(
            self.cfg, self.trees, np.asarray(active, np.int32), sel,
            sim_nodes, values_fx, alternating,
            None if dropped is None else np.asarray(dropped, np.int32))

    def _spawn(self, trees: UCTree, Gc: int) -> "CudaExecutor":
        # a session's sub-arena runs the kernels too
        return CudaExecutor(self.cfg, Gc, device=self.device, _trees=trees)


class ReferenceExecutor:
    """The paper's CPU-only master process: one sequential numpy
    MutableTree per slot, looped on the host.  Same interface and stacked
    [G, ...] host-array convention as the device executors; inactive
    slots produce the dead rows the driver never reads."""

    def __init__(self, cfg: TreeConfig, G: int, _trees: Optional[list] = None):
        self.cfg, self.G = cfg, G
        self.trees = ([self.init(cfg.F) for _ in range(G)] if _trees is None
                      else _trees)

    # -- phases --------------------------------------------------------
    def selection(self, active, p: int) -> dict:
        cfg = self.cfg
        out = {
            "path_nodes": np.full((self.G, p, cfg.D), NULL, np.int32),
            "path_actions": np.full((self.G, p, cfg.D), NULL, np.int32),
            "depths": np.zeros((self.G, p), np.int32),
            "leaves": np.zeros((self.G, p), np.int32),
            "expand_action": np.full((self.G, p), NULL, np.int32),
            "n_insert": np.zeros((self.G, p), np.int32),
            "insert_base": np.zeros((self.G, p), np.int32),
        }
        for g in range(self.G):
            t = self.trees[g]
            if not active[g]:
                out["leaves"][g] = t.root
                out["insert_base"][g] = t.size
                continue
            sel = ref.selection_phase(cfg, t, p)
            ni = sel["n_insert"]
            sel["insert_base"] = t.size + np.cumsum(ni) - ni
            for k, v in sel.items():
                out[k][g] = v
        return out

    def insert(self, active, sel: dict) -> np.ndarray:
        p = sel["leaves"].shape[1]
        new_nodes = np.full((self.G, p, self.cfg.Fp), NULL, np.int32)
        for g in np.flatnonzero(active):
            slot_sel = {k: v[g] for k, v in sel.items()}
            new_nodes[g] = ref.insert_phase(self.cfg, self.trees[g], slot_sel)
        return new_nodes

    # numpy has no device: "dev" computes and "host" is the identity
    def insert_dev(self, active, sel: dict) -> np.ndarray:
        return self.insert(active, sel)

    def insert_host(self, new_nodes: np.ndarray) -> np.ndarray:
        return new_nodes

    def finalize(self, nodes, num_actions, terminal, prior_parent, priors_fx):
        for g in range(self.G):
            ref.finalize_expansion(
                self.trees[g], nodes[g], num_actions[g], terminal[g],
                prior_parent[g], priors_fx[g])

    def backup(self, active, sel, sim_nodes, values_fx, alternating: bool,
               dropped=None):
        for g in np.flatnonzero(active):
            slot_sel = {k: v[g] for k, v in sel.items()}
            ref.backup_phase(self.cfg, self.trees[g], slot_sel,
                             np.asarray(sim_nodes)[g], np.asarray(values_fx)[g],
                             alternating,
                             None if dropped is None else np.asarray(dropped)[g])

    # -- host-side slot access -----------------------------------------
    def reset_slot(self, g: int, root_num_actions: int):
        self.trees[g] = self.init(root_num_actions)

    def sel_to_host(self, sel) -> dict:
        return sel

    def best_actions(self) -> np.ndarray:
        return np.array([ref.best_root_action(self.cfg, t)
                         for t in self.trees], np.int32)

    def sizes(self) -> np.ndarray:
        return np.array([t.size for t in self.trees], np.int32)

    def slot_snapshot(self, g: int) -> dict:
        return self.snapshot(self.trees[g])

    def write_slot(self, g: int, arrays: dict):
        self.trees[g] = ref.MutableTree.from_arrays(arrays)

    def block(self):
        pass

    def release(self):
        self.trees = None

    # -- compaction ----------------------------------------------------
    # MutableTrees mutate in place, so the sub-executor shares the slot
    # objects and scatter is a re-link.
    def gather_sub(self, slot_idx: np.ndarray, Gc: int) -> "ReferenceExecutor":
        return ReferenceExecutor(
            self.cfg, Gc, _trees=[self.trees[g] for g in _padded(slot_idx, Gc)])

    def scatter_sub(self, sub: "ReferenceExecutor", slot_idx: np.ndarray):
        for i, g in enumerate(np.asarray(slot_idx)):
            self.trees[g] = sub.trees[i]

    def open_session(self, slot_idx: np.ndarray, Gc: int,
                     tracer=None, tid: int = 0) -> CompactionSession:
        return CompactionSession(self, slot_idx, Gc, tracer=tracer, tid=tid)

    # -- single-tree surface -------------------------------------------
    def init(self, root_num_actions: int) -> ref.MutableTree:
        return ref.MutableTree.from_arrays(
            init_tree_arrays(self.cfg, root_num_actions))

    def get_tree(self, g: int = 0) -> ref.MutableTree:
        return self.trees[g]

    def set_tree(self, tree, g: int = 0):
        if isinstance(tree, UCTree):
            tree = to_numpy(tree)
        self.trees[g] = (tree if isinstance(tree, ref.MutableTree)
                         else ref.MutableTree.from_arrays(tree))

    def snapshot(self, tree) -> dict:
        return {k: np.array(v) for k, v in tree.to_arrays().items()}

    def best_action(self, tree) -> int:
        return ref.best_root_action(self.cfg, tree)


def make_intree_executor(cfg: TreeConfig, G: int, name: str,
                         device=None) -> InTreeExecutor:
    """Executor factory shared by TreeParallelMCTS (G=1) and the service
    pools: ``reference`` (numpy oracle on the host), ``faithful`` /
    ``relaxed`` / ``wavefront`` (plain torch ops) or ``cuda`` (the
    hand-written kernels) on `device` (CUDA unless the caller passes
    another)."""
    if name == "reference":
        return ReferenceExecutor(cfg, G)
    if name == "cuda":
        return CudaExecutor(cfg, G, device=device)
    if name in intree.SELECT_VARIANTS:
        return TorchExecutor(cfg, G, name, device=device)
    raise NotImplementedError(
        f"executor {name!r}: the port has {EXECUTOR_NAMES}")
