"""Batched in-tree operations (the accelerator, paper §IV) in plain torch.

The port of repro.core.intree, faithful variant.  Three entry points
mirror the paper accelerator's three functions:

  select_arena   — Selection + virtual-loss apply for p workers, strictly
                   in worker order (worker k sees the virtual loss of
                   workers < k), then the BSP expansion-assignment pass;
  insert_arena   — Node Insertion (paper §IV-E);
  backup_arena   — BackUp from the memoized paths (one masked scatter-add
                   pass: integer adds commute, so it equals the
                   sequential program bit for bit).

Every op takes an arena (UCTree with a leading [G] axis) and a [G]
``active`` mask, and UPDATES THE ARENA'S TENSORS IN PLACE where the JAX
code rebuilds arrays; inactive slots are left untouched.  Their selection
rows are dead data with fixed values (NULL paths, depth 0, leaf = root,
no expansion, insert_base = size) so every implementation agrees on them.
The single-tree forms (select_batch, ...) run the arena ops on a G=1 view
of the tree.

JAX's ``.at[].add/set(mode="drop")`` silently drops out-of-range indices;
torch does not, so every scatter below first masks its index set.

These ops are also the plain versions of the CUDA kernels
(kernels/uct_select.py, kernels/uct_backup.py): the kernels are held
against them bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import scoring
from repro_torch.core.tree import NULL, TreeConfig, UCTree, as_arena

i32 = torch.int32

SEL_FIELDS = ("path_nodes", "path_actions", "depths", "leaves",
              "expand_action", "n_insert", "insert_base")


@dataclasses.dataclass
class SelectionResult:
    path_nodes: Any     # [G, p, D] i32, NULL-padded
    path_actions: Any   # [G, p, D] i32
    depths: Any         # [G, p] i32
    leaves: Any         # [G, p] i32
    expand_action: Any  # [G, p] i32: action, NULL, or -2 (expand-all claim)
    n_insert: Any       # [G, p] i32
    insert_base: Any    # [G, p] i32: first node id this worker will insert

    def map(self, fn) -> "SelectionResult":
        return SelectionResult(**{k: fn(getattr(self, k)) for k in SEL_FIELDS})

    def to_host(self) -> dict:
        """One device->host transfer of every field (the paper's Receive
        buffer): dict of numpy int32 arrays."""
        parts = [getattr(self, k) for k in SEL_FIELDS]
        flat = torch.cat([t.reshape(-1) for t in parts]).cpu().numpy()
        out, off = {}, 0
        for k, t in zip(SEL_FIELDS, parts):
            n = t.numel()
            out[k] = flat[off: off + n].reshape(tuple(t.shape)).copy()
            off += n
        return out


def as_mask(active, device) -> torch.Tensor:
    """[G] bool mask on `device` from a numpy / list / tensor mask."""
    if isinstance(active, torch.Tensor):
        return (active != 0).to(device)
    return torch.as_tensor(np.asarray(active) != 0, device=device)


def _slots(arena: UCTree) -> torch.Tensor:
    return torch.arange(arena.child.shape[0], device=arena.child.device)


# --------------------------------------------------------------------------
# Selection
# --------------------------------------------------------------------------

def select_arena(cfg: TreeConfig, arena: UCTree, active, p: int,
                 variant: str = "faithful") -> SelectionResult:
    """Selection for p workers on every active slot; updates
    ``arena.edge_VL`` and ``arena.node_O`` in place.  Returns the [G, ...]
    SelectionResult (assignment pass included)."""
    if variant != "faithful":
        raise NotImplementedError(
            f"selection variant {variant!r} is not ported yet (ROADMAP.md "
            "queue A); the port has the faithful variant")
    dev = arena.child.device
    act = as_mask(active, dev)
    G, D = arena.child.shape[0], cfg.D
    gi = _slots(arena)
    pn = torch.full((G, p, D), NULL, dtype=i32, device=dev)
    pa = torch.full((G, p, D), NULL, dtype=i32, device=dev)
    depths = torch.zeros((G, p), dtype=i32, device=dev)
    leaves = torch.zeros((G, p), dtype=i32, device=dev)
    root = arena.root.long()
    act_i = act.to(i32)

    for j in range(p):
        arena.node_O[gi, root] += act_i
        node = root.clone()
        depth = torch.zeros(G, dtype=i32, device=dev)
        for d in range(D):
            leaf = scoring.is_leaf(
                cfg, num_expanded=arena.num_expanded[gi, node],
                num_actions=arena.num_actions[gi, node],
                terminal=arena.terminal[gi, node], depth=depth)
            live = act & ~leaf & (depth == d)
            if not bool(live.any()):
                break   # no slot descends further: later levels are no-ops
            s = scoring.edge_scores_fx(
                cfg,
                child=arena.child[gi, node], edge_N=arena.edge_N[gi, node],
                edge_W=arena.edge_W[gi, node],
                edge_VL=arena.edge_VL[gi, node],
                edge_P=arena.edge_P[gi, node],
                node_N=arena.node_N[gi, node][:, None],
                node_O=arena.node_O[gi, node][:, None],
                num_actions=arena.num_actions[gi, node][:, None],
                log_table=arena.log_table)
            a = scoring.argmax_first(s).long()
            inc = live.to(i32)
            arena.edge_VL[gi, node, a] += inc
            pn[:, j, d] = torch.where(live, node.to(i32), pn[:, j, d])
            pa[:, j, d] = torch.where(live, a.to(i32), pa[:, j, d])
            node = torch.where(live, arena.child[gi, node, a].long(), node)
            arena.node_O[gi, node] += inc
            depth = depth + inc
        depths[:, j] = depth
        leaves[:, j] = node.to(i32)

    return _assign_expansions(cfg, arena, act, pn, pa, depths, leaves, p)


def _assign_expansions(cfg, arena, act, pn, pa, depths, leaves, p):
    """BSP expansion-assignment post-pass, in worker order."""
    dev = arena.child.device
    G, X = arena.child.shape[0], arena.child.shape[1]
    gi = _slots(arena)
    pending = torch.zeros((G, X), dtype=i32, device=dev)
    claimed = torch.zeros((G, X), dtype=i32, device=dev)
    ea = torch.full((G, p), NULL, dtype=i32, device=dev)
    ni = torch.zeros((G, p), dtype=i32, device=dev)
    budget = (X - arena.size).to(i32)
    for j in range(p):
        leaf = leaves[:, j].long()
        can = act & (arena.terminal[gi, leaf] == 0) & (depths[:, j] < cfg.D)
        if cfg.expand_all:
            k = arena.num_actions[gi, leaf]
            ok = (can & (claimed[gi, leaf] == 0)
                  & (arena.num_expanded[gi, leaf] == 0) & (k > 0)
                  & (budget >= k))
            ea[:, j] = torch.where(ok, -2, NULL)
            ni[:, j] = torch.where(ok, k, 0)
            claimed[gi, leaf] = torch.maximum(claimed[gi, leaf], ok.to(i32))
            budget = budget - ni[:, j]
        else:
            a = arena.num_expanded[gi, leaf] + pending[gi, leaf]
            ok = can & (a < arena.num_actions[gi, leaf]) & (budget >= 1)
            ea[:, j] = torch.where(ok, a, NULL)
            ni[:, j] = ok.to(i32)
            pending[gi, leaf] += ok.to(i32)
            budget = budget - ni[:, j]
    insert_base = (arena.size[:, None] + torch.cumsum(ni, 1, dtype=i32)
                   - ni).to(i32)
    return SelectionResult(pn, pa, depths, leaves, ea, ni, insert_base)


# --------------------------------------------------------------------------
# Node Insertion / finalize
# --------------------------------------------------------------------------

def insert_arena(cfg: TreeConfig, arena: UCTree, active,
                 sel: SelectionResult) -> torch.Tensor:
    """Node Insertion for every worker of every active slot (one masked
    scatter), in place.  Returns new_nodes [G, p, Fp] (NULL-padded).
    Target edges are distinct by the assignment pass (the paper's
    'all workers expand different nodes' invariant)."""
    dev = arena.child.device
    act = as_mask(active, dev)
    G, p = sel.leaves.shape
    Fp = arena.child.shape[2]
    lane = torch.arange(Fp, dtype=i32, device=dev)[None, None, :]
    ea = sel.expand_action[:, :, None]
    single = ea >= 0
    allmode = ea == -2
    act_lane = torch.where(single, ea, lane)                          # [G,p,Fp]
    valid = (((single & (lane == 0)) | (allmode & (lane < sel.n_insert[:, :, None])))
             & act[:, None, None])
    nid = sel.insert_base[:, :, None] + torch.where(single, 0, lane)

    vg, vw, vlane = valid.nonzero(as_tuple=True)    # one host sync
    vl = sel.leaves[vg, vw].long()
    va, vn = act_lane[vg, vw, vlane].long(), nid[vg, vw, vlane]
    arena.child[vg, vl, va] = vn
    vn = vn.long()
    arena.node_depth[vg, vn] = arena.node_depth[vg, vl] + 1
    arena.num_actions[vg, vn] = cfg.F
    arena.num_expanded.index_put_(
        (vg, vl), torch.ones_like(vn, dtype=i32), accumulate=True)
    arena.size += (sel.n_insert.sum(1, dtype=i32) * act.to(i32)).to(i32)
    return torch.where(valid, nid, NULL).to(i32)


def finalize_arena(arena: UCTree, nodes, num_actions, terminal,
                   prior_parent=None, priors_fx=None) -> None:
    """Host metadata write-back after the 1-step simulations, in place.
    Inputs carry a leading [G] axis and are NULL-padded per slot; the
    NULL rows are dropped on the host, so the scatter needs no device
    round trip."""
    dev = arena.child.device
    host = lambda x: np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    put = lambda x: torch.as_tensor(x, device=dev)
    nodes = host(nodes)
    g, j = np.nonzero(nodes != NULL)
    idx = (put(g), put(nodes[g, j].astype(np.int64)))
    arena.num_actions[idx] = put(host(num_actions)[g, j].astype(np.int32))
    arena.terminal[idx] = put(host(terminal)[g, j].astype(np.int32))
    if priors_fx is not None:
        pp = host(prior_parent)
        g, j = np.nonzero(pp != NULL)
        arena.edge_P[put(g), put(pp[g, j].astype(np.int64))] = put(
            host(priors_fx)[g, j].astype(np.int32))


# --------------------------------------------------------------------------
# BackUp
# --------------------------------------------------------------------------

def backup_arena(cfg: TreeConfig, arena: UCTree, active, sel: SelectionResult,
                 sim_nodes, values_fx, alternating_signs: bool = False,
                 dropped=None) -> None:
    """BackUp for all p workers of every active slot, in place.

    A `dropped` worker ([G, p] straggler mask) gets the recovery-only
    backup: its virtual loss and in-flight counts are removed as if it
    had never been dispatched, and it adds no visits or reward."""
    dev = arena.child.device
    act = as_mask(active, dev)
    G, p, D = sel.path_nodes.shape
    X, Fp = arena.child.shape[1], arena.child.shape[2]
    sim_nodes = torch.as_tensor(sim_nodes, dtype=i32, device=dev)
    values_fx = torch.as_tensor(values_fx, dtype=i32, device=dev)
    gi = _slots(arena)
    alive = (torch.ones((G, p), dtype=torch.bool, device=dev) if dropped is None
             else ~as_mask(dropped, dev))

    expanded = (sel.expand_action >= 0) & (not cfg.expand_all)        # [G,p]
    sim_depth = sel.depths + expanded.to(i32)
    on = (sel.path_nodes != NULL) & act[:, None, None]                 # [G,p,D]
    d_idx = torch.arange(D, dtype=i32, device=dev)
    if alternating_signs:
        odd = ((sim_depth[:, :, None] - d_idx) & 1) == 1
        sign = torch.where(odd, -1, 1).to(i32)
    else:
        sign = torch.ones((G, p, D), dtype=i32, device=dev)
    ninc = alive[:, :, None].to(i32).expand(G, p, D)
    winc = ninc * sign * values_fx[:, :, None]

    node = sel.path_nodes.long()
    nidx = (gi[:, None, None] * X + node)[on]
    eidx = ((gi[:, None, None] * X + node) * Fp + sel.path_actions.long())[on]
    eN, eW, eVL = (arena.edge_N.view(-1), arena.edge_W.view(-1),
                   arena.edge_VL.view(-1))
    nN, nO = arena.node_N.view(-1), arena.node_O.view(-1)
    eN.index_add_(0, eidx, ninc[on])
    eW.index_add_(0, eidx, winc[on])
    eVL.index_add_(0, eidx, torch.full_like(eidx, -1, dtype=i32))
    nN.index_add_(0, nidx, ninc[on])
    nO.index_add_(0, nidx, torch.full_like(nidx, -1, dtype=i32))

    am = act[:, None].expand(G, p)
    lidx = (gi[:, None] * X + sel.leaves.long())[am]
    nN.index_add_(0, lidx, alive[am].to(i32))
    nO.index_add_(0, lidx, torch.full_like(lidx, -1, dtype=i32))

    # expansion edges (single-expand mode): seed the sim node's in-edge
    live_exp = expanded & alive & am
    e_sign = torch.ones((G, p), dtype=i32, device=dev)
    if alternating_signs:
        e_sign = torch.where(((sim_depth - sel.depths) & 1) == 1, -1, 1).to(i32)
    x_idx = ((gi[:, None] * X + sel.leaves.long()) * Fp
             + sel.expand_action.long())[live_exp]
    ones = torch.ones_like(x_idx, dtype=i32)
    eN.index_add_(0, x_idx, ones)
    eW.index_add_(0, x_idx, (e_sign * values_fx)[live_exp])
    nN.index_add_(0, (gi[:, None] * X + sim_nodes.long())[live_exp], ones)


def best_root_action_arena(arena: UCTree) -> torch.Tensor:
    """Robust-child action (max edge_N, ties to the lowest lane) for every
    slot.  Returns [G] i32."""
    gi = _slots(arena)
    root = arena.root.long()
    Fp = arena.child.shape[2]
    lane = torch.arange(Fp, dtype=i32, device=arena.child.device)
    ok = ((lane < arena.num_actions[gi, root][:, None])
          & (arena.child[gi, root] != NULL))
    return scoring.argmax_first(torch.where(ok, arena.edge_N[gi, root], -1))


# --------------------------------------------------------------------------
# Single-tree forms: the arena ops on a G=1 view (updates write through)
# --------------------------------------------------------------------------

def _one(tree: UCTree):
    return torch.ones(1, dtype=torch.bool, device=tree.child.device)


def _lift(x):
    """A per-tree argument as a [1, ...] arena argument (None stays)."""
    if x is None:
        return None
    return (x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x)))[None]


def select_batch(cfg: TreeConfig, tree: UCTree, p: int) -> SelectionResult:
    return select_arena(cfg, as_arena(tree), _one(tree), p).map(lambda a: a[0])


def insert_batch(cfg: TreeConfig, tree: UCTree, sel: SelectionResult):
    return insert_arena(cfg, as_arena(tree), _one(tree),
                        sel.map(lambda a: a[None]))[0]


def finalize_expansion_batch(tree: UCTree, nodes, num_actions, terminal,
                             prior_parent=None, priors_fx=None) -> None:
    finalize_arena(as_arena(tree), _lift(nodes), _lift(num_actions),
                   _lift(terminal), _lift(prior_parent), _lift(priors_fx))


def backup_batch(cfg: TreeConfig, tree: UCTree, sel: SelectionResult,
                 sim_nodes, values_fx, alternating_signs: bool = False,
                 dropped=None) -> None:
    backup_arena(cfg, as_arena(tree), _one(tree), sel.map(lambda a: a[None]),
                 _lift(sim_nodes), _lift(values_fx), alternating_signs,
                 _lift(dropped))


def best_root_action(tree: UCTree) -> torch.Tensor:
    return best_root_action_arena(as_arena(tree))[0]
