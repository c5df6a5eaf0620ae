"""In-tree executor stack: one protocol, every backend, any G.

The port of repro.core.executor (main-path slice):

  InTreeExecutor    — the protocol.  Every implementation drives G >= 1
                      tree slots through the device phases (Selection /
                      Insertion / finalize / BackUp) under a [G] active
                      mask; inactive slots come back bit-frozen.
                      TreeParallelMCTS is the G=1 client.
  ReferenceExecutor — the paper's CPU-only master process: one sequential
                      numpy MutableTree per slot.  Correctness oracle.
  TorchExecutor     — an arena of tensors on a device + the plain torch
                      ops of core.intree ("faithful").
  CudaExecutor      — the port's counterpart of PallasExecutor: Selection
                      (with the expansion assignment) and BackUp (with
                      the straggler mask) are the hand-written CUDA
                      kernels, one launch each per superstep; Insertion
                      and finalize are torch ops on the card.  On a CPU
                      arena the kernel wrappers run their plain versions.

Every device executor keeps its arena in place on its device and updates
it in place.  The serving-stack pieces of the JAX module (compaction
sessions, gather_sub/scatter_sub, fused run_supersteps, sharding) are
later slices of the port (ROADMAP.md queue A).
"""

from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from repro_torch.core import intree, ref_sequential as ref
from repro_torch.core.tree import (
    NULL, TreeConfig, UCTree, arena_set_slot, arena_slot, from_numpy,
    init_arena, init_tree, init_tree_arrays, resolve_device, to_numpy,
)

EXECUTOR_NAMES = ("reference", "faithful", "cuda")


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
    # single-tree surface of the G=1 client
    def init(self, root_num_actions: int): ...
    def get_tree(self, g: int = 0): ...
    def set_tree(self, tree, g: int = 0) -> None: ...
    def snapshot(self, tree) -> dict: ...
    def best_action(self, tree) -> int: ...


class TorchExecutor:
    """G stacked trees on `device` + the plain torch in-tree ops."""

    def __init__(self, cfg: TreeConfig, G: int, variant: str = "faithful",
                 device=None):
        if variant != "faithful":
            raise NotImplementedError(
                f"TorchExecutor variant {variant!r} is not ported yet "
                "(ROADMAP.md queue A); the port has 'faithful'")
        self.cfg, self.G, self.variant = cfg, G, variant
        self.device = resolve_device(device)
        self.trees = init_arena(cfg, G, device=self.device)

    def _mask(self, active) -> torch.Tensor:
        return intree.as_mask(active, self.device)

    # -- device phases -------------------------------------------------
    def selection(self, active, p: int):
        return intree.select_arena(self.cfg, self.trees, self._mask(active), p)

    def insert(self, active, sel) -> np.ndarray:
        new = intree.insert_arena(self.cfg, self.trees, self._mask(active), sel)
        return new.cpu().numpy()

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
        self.trees = None

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

    def __init__(self, cfg: TreeConfig, G: int, device=None):
        super().__init__(cfg, G, "faithful", device=device)
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


class ReferenceExecutor:
    """The paper's CPU-only master process: one sequential numpy
    MutableTree per slot, looped on the host.  Same interface and stacked
    [G, ...] host-array convention as the device executors; inactive
    slots produce the dead rows the driver never reads."""

    def __init__(self, cfg: TreeConfig, G: int):
        self.cfg, self.G = cfg, G
        self.trees = [self.init(cfg.F) for _ in range(G)]

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
    """Executor factory: ``reference`` (numpy oracle on the host),
    ``faithful`` (plain torch ops) or ``cuda`` (the hand-written kernels)
    on `device` (CUDA unless the caller passes another)."""
    if name == "reference":
        return ReferenceExecutor(cfg, G)
    if name == "faithful":
        return TorchExecutor(cfg, G, "faithful", device=device)
    if name == "cuda":
        return CudaExecutor(cfg, G, device=device)
    raise NotImplementedError(
        f"executor {name!r} is not ported yet; the port has "
        f"{EXECUTOR_NAMES} (the rest are queued in ROADMAP.md queue A)")
