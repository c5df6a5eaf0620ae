"""Batched in-tree operations (the accelerator, paper §IV) in plain torch.

The port of repro.core.intree.  Three entry points mirror the paper
accelerator's three functions:

  select_arena   — Selection + virtual-loss apply for p workers, then the
                   BSP expansion-assignment pass.  Variants (the
                   ``variant`` argument, as in the JAX package):
                     faithful  — strictly in worker order (worker k sees
                                 the virtual loss of workers < k);
                     relaxed   — every worker reads the pre-superstep
                                 statistics and the virtual loss is applied
                                 once after all have chosen (beyond-paper);
                     wavefront — level-synchronous: workers that meet at a
                                 node are spread over its best edges by
                                 their stable within-group rank, virtual
                                 loss applied once at the end (beyond-paper);
  insert_arena   — Node Insertion (paper §IV-E), with no host sync: the
                   [G, p, Fp] id block is computed on the device and the
                   tree is written by scatter-adds over the whole block;
  backup_arena   — BackUp from the memoized paths (one masked scatter-add
                   pass: integer adds commute, so it equals the
                   sequential program bit for bit).

finalize_arena writes the host expansion's metadata back (host-side NULL
filtering); finalize_arena_device is its form with no host read, for
the fused K-superstep dispatch (core.fused).

Every op takes an arena (UCTree with a leading [G] axis) and a [G]
``active`` mask, and UPDATES THE ARENA'S TENSORS IN PLACE where the JAX
code rebuilds arrays; inactive slots are left untouched.  Their selection
rows are dead data with fixed values (NULL paths, depth 0, leaf = root,
no expansion, insert_base = size) so every implementation agrees on them.
The single-tree forms (select_batch, ...) run the arena ops on a G=1 view
of the tree.

JAX's ``.at[].add/set(mode="drop")`` silently drops out-of-range indices;
torch does not, so every scatter below first masks its index set.  The
scatters of the relaxed/wavefront selection and of Node Insertion give
every lane an in-range index and add zero on the masked-off lanes: no
boolean indexing, so nothing reads the device on the host.

These ops are also the plain versions of the CUDA kernels
(kernels/uct_select.py, kernels/uct_backup.py): the kernels are held
against them bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import fixedpoint as fx
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


SELECT_VARIANTS = ("faithful", "relaxed", "wavefront")


def as_mask(active, device) -> torch.Tensor:
    """[G] bool mask on `device` from a numpy / list / tensor mask.  A
    host mask's upload (pinned, non-blocking) does not wait for the
    device's queue."""
    if isinstance(active, torch.Tensor):
        return (active != 0).to(device)
    host = torch.from_numpy(np.ascontiguousarray(np.asarray(active) != 0))
    if torch.device(device).type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


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
    if variant not in SELECT_VARIANTS:
        raise ValueError(f"selection variant {variant!r}: one of "
                         f"{SELECT_VARIANTS}")
    dev = arena.child.device
    act = as_mask(active, dev)
    if variant != "faithful":
        return _select_levelwise(cfg, arena, act, p, variant == "wavefront")
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


def _segment_rank(keys: torch.Tensor) -> torch.Tensor:
    """r[g, j] = #{i < j : keys[g, i] == keys[g, j]}: the stable
    within-group rank (a stable sort, then the run-start scan)."""
    G, p = keys.shape
    sk, sidx = torch.sort(keys, dim=-1, stable=True)
    pos = torch.arange(p, device=keys.device).expand(G, p)
    new_run = torch.ones_like(sk, dtype=torch.bool)
    new_run[:, 1:] = sk[:, 1:] != sk[:, :-1]
    run_start = torch.cummax(torch.where(new_run, pos, 0), dim=-1).values
    return torch.zeros_like(sidx).scatter_(-1, sidx, pos - run_start)


def _select_levelwise(cfg, arena, act, p: int, wavefront: bool):
    """The relaxed and wavefront selections: all p workers of every slot
    descend one level per step reading the pre-superstep statistics;
    virtual loss and in-flight counts are applied once at the end.
    Relaxed takes each node's best edge (so its workers share one path);
    wavefront gives the k-th worker to reach a node that node's k-th best
    edge (mod its valid edges)."""
    dev = arena.child.device
    G, X, Fp = arena.child.shape
    D = cfg.D
    gi = _slots(arena)[:, None]                                       # [G,1]
    w = torch.arange(p, device=dev)
    node = arena.root.long()[:, None].expand(G, p).contiguous()       # [G,p]
    depth = torch.zeros((G, p), dtype=i32, device=dev)
    pn = torch.full((G, p, D), NULL, dtype=i32, device=dev)
    pa = torch.full((G, p, D), NULL, dtype=i32, device=dev)
    for d in range(D):
        leaf = scoring.is_leaf(
            cfg, num_expanded=arena.num_expanded[gi, node],
            num_actions=arena.num_actions[gi, node],
            terminal=arena.terminal[gi, node], depth=depth)
        live = act[:, None] & ~leaf & (depth == d)
        s = scoring.edge_scores_fx(
            cfg,
            child=arena.child[gi, node], edge_N=arena.edge_N[gi, node],
            edge_W=arena.edge_W[gi, node], edge_VL=arena.edge_VL[gi, node],
            edge_P=arena.edge_P[gi, node],
            node_N=arena.node_N[gi, node][..., None],
            node_O=arena.node_O[gi, node][..., None],
            num_actions=arena.num_actions[gi, node][..., None],
            log_table=arena.log_table)                             # [G,p,Fp]
        if wavefront:
            order = torch.argsort(-s, dim=-1, stable=True)   # best first
            n_valid = torch.clamp((s > int(fx.FX_NEG_INF)).sum(-1), min=1)
            rank = _segment_rank(torch.where(live, node, X + w))
            a = order.gather(-1, (rank % n_valid)[..., None])[..., 0]
        else:
            a = scoring.argmax_first(s).long()
        pn[:, :, d] = torch.where(live, node.to(i32), pn[:, :, d])
        pa[:, :, d] = torch.where(live, a.to(i32), pa[:, :, d])
        node = torch.where(live, arena.child[gi, node, a].long(), node)
        depth = depth + live.to(i32)
    on = pn != NULL
    nidx = gi[..., None] * X + pn.clamp(min=0).long()                 # [G,p,D]
    arena.edge_VL.view(-1).index_add_(
        0, (nidx * Fp + pa.clamp(min=0).long()).reshape(-1),
        on.to(i32).reshape(-1))
    nO = arena.node_O.view(-1)
    nO.index_add_(0, nidx.reshape(-1), on.to(i32).reshape(-1))
    nO.index_add_(0, (gi * X + node).reshape(-1),
                  act[:, None].expand(G, p).to(i32).reshape(-1))
    return _assign_expansions(cfg, arena, act, pn, pa, depth,
                              node.to(i32), p)


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
    """Node Insertion for every worker of every active slot, in place,
    without a host sync.  Returns new_nodes [G, p, Fp] (NULL-padded) on
    the arena's device.

    Target edges and new node ids are distinct by the assignment pass
    (the paper's 'all workers expand different nodes' invariant), so each
    written word takes one valid lane's value: the writes are integer
    scatter-adds of ``valid * (new - prior)`` over the whole block, with
    every masked-off lane sent to an in-range index carrying 0.  Integer
    adds commute, so the result is exact and order-free; the JAX
    ``mode="drop"`` set has no torch twin, and a non-accumulating
    scatter with duplicate indices is undefined on CUDA."""
    dev = arena.child.device
    act = as_mask(active, dev)
    G, p = sel.leaves.shape
    X, Fp = arena.child.shape[1], arena.child.shape[2]
    lane = torch.arange(Fp, dtype=i32, device=dev)
    ea = sel.expand_action[:, :, None]
    # a worker inserts n_insert nodes (1 at its expand_action edge, or k
    # for an expand-all claim, one per lane) with ids from insert_base on
    valid = (lane < sel.n_insert[:, :, None]) & act[:, None, None]     # [G,p,Fp]
    nid = sel.insert_base[:, :, None] + lane
    # flat indices; a masked-off lane's leaf and edge are in range already
    # (dead rows hold leaf = root), its id is clamped into range
    base = _slots(arena)[:, None, None] * X
    leaf = (base + sel.leaves[:, :, None]).expand(G, p, Fp)
    edge = (leaf * Fp + torch.where(ea >= 0, ea, lane)).reshape(-1)
    new = (base + nid.clamp(max=X - 1)).reshape(-1)
    leaf = leaf.reshape(-1)
    v = valid.reshape(-1).to(i32)
    child, depth = arena.child.view(-1), arena.node_depth.view(-1)
    n_act, n_exp = arena.num_actions.view(-1), arena.num_expanded.view(-1)
    # every delta reads the pre-insert tree before any write lands
    d_child = v * (nid.reshape(-1) - child[edge])
    d_depth = v * (depth[leaf] + 1 - depth[new])
    d_act = v * (cfg.F - n_act[new])
    child.index_add_(0, edge, d_child)
    depth.index_add_(0, new, d_depth)
    n_act.index_add_(0, new, d_act)
    n_exp.index_add_(0, leaf, v)
    arena.size += sel.n_insert.sum(1, dtype=i32) * act.to(i32)
    return torch.where(valid, nid, NULL)


def finalize_arena(arena: UCTree, nodes, num_actions, terminal,
                   prior_parent=None, priors_fx=None) -> None:
    """Host metadata write-back after the 1-step simulations, in place.
    Inputs carry a leading [G] axis and are NULL-padded per slot; the
    NULL rows are dropped on the host, so the scatter needs no device
    round trip.  (finalize_arena_device is the form with no host read.)"""
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


def finalize_arena_device(arena: UCTree, nodes: torch.Tensor,
                          num_actions: torch.Tensor,
                          terminal: torch.Tensor) -> None:
    """finalize_arena without a host read, for the fused dispatch: int32
    [G, K] tensors on the arena's device, NULL-padded, no priors (the
    expand-all pools that produce priors never fuse).

    The writes are insert_arena's idiom: the node ids are distinct new
    nodes, so each written word takes one valid lane's value as a
    scatter-add of ``valid * (new - prior)``, and every NULL lane adds 0
    at its slot's node 0."""
    X = arena.num_actions.shape[1]
    valid = nodes != NULL
    idx = (_slots(arena)[:, None] * X
           + torch.where(valid, nodes, 0).long()).reshape(-1)
    v = valid.reshape(-1).to(i32)
    n_act, term = arena.num_actions.view(-1), arena.terminal.view(-1)
    d_act = v * (num_actions.reshape(-1) - n_act[idx])
    d_term = v * (terminal.reshape(-1) - term[idx])
    n_act.index_add_(0, idx, d_act)
    term.index_add_(0, idx, d_term)


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


def select_batch(cfg: TreeConfig, tree: UCTree, p: int,
                 variant: str = "faithful") -> SelectionResult:
    return select_arena(cfg, as_arena(tree), _one(tree), p,
                        variant).map(lambda a: a[0])


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
