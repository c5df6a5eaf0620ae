"""Sequential CPU reference for p-worker Tree-Parallel MCTS (paper Alg. 1/2).

The port's numpy copy of repro.core.ref_sequential: a single master
process doing the in-tree operations for p workers in worker order, with
virtual loss applied inside the critical region.  It is the correctness
oracle (the torch ops and CUDA kernels are tested bit-exactly against it)
and the CPU-only baseline.  Plain numpy, deliberately unvectorized across
workers; the scoring spec is the numpy form of core/scoring.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import fixedpoint as fx
from repro_torch.core.tree import NULL, TreeConfig


def edge_scores_np(cfg: TreeConfig, *, child, edge_N, edge_W, edge_VL,
                   edge_P, node_N, node_O, num_actions, log_table):
    """numpy form of core.scoring.edge_scores_fx (same op order)."""
    i32, f32 = np.int32, np.float32
    lane = np.arange(child.shape[-1], dtype=i32)
    valid = (lane < num_actions) & (child != NULL)
    if cfg.vl_mode == "wu":
        ne = edge_N + edge_VL
        ns = node_N + node_O
    else:
        ne = edge_N
        ns = node_N
    ns = np.minimum(ns, i32(2 * cfg.X + 3))
    ne_safe = np.maximum(ne, i32(1)).astype(f32)
    log_ns = np.take(log_table, ns, axis=0)
    if cfg.score_fn == "uct":
        q = (edge_W.astype(f32) * fx.FX_INV_SCALE) / ne_safe
        u = f32(cfg.beta) * np.sqrt(log_ns / ne_safe)
        base = fx.encode(q + u)
        base = np.where(ne == 0, fx.FX_FORCE_EXPLORE, base)
    else:
        q = (edge_W.astype(f32) * fx.FX_INV_SCALE) / ne_safe
        q = np.where(ne == 0, f32(0.0), q)
        sqrt_ns = np.sqrt(ns.astype(f32))
        p_f = edge_P.astype(f32) * fx.FX_INV_SCALE
        u = f32(cfg.beta) * p_f * sqrt_ns / (f32(1.0) + ne.astype(f32))
        base = fx.encode(q + u)
    if cfg.vl_mode == "constant":
        base = base - i32(cfg.vl_const_fx) * edge_VL
    return np.where(valid, base, fx.FX_NEG_INF)


@dataclasses.dataclass
class MutableTree:
    """Mutable numpy tree for the in-place sequential program."""

    child: np.ndarray
    edge_N: np.ndarray
    edge_W: np.ndarray
    edge_VL: np.ndarray
    edge_P: np.ndarray
    node_N: np.ndarray
    node_O: np.ndarray
    num_expanded: np.ndarray
    num_actions: np.ndarray
    node_depth: np.ndarray
    terminal: np.ndarray
    size: int
    root: int
    log_table: np.ndarray

    @classmethod
    def from_arrays(cls, a: dict) -> "MutableTree":
        """From a snapshot dict (copies)."""
        kw = {k: np.array(a[k], dtype=np.int32) for k in (
            "child", "edge_N", "edge_W", "edge_VL", "edge_P", "node_N",
            "node_O", "num_expanded", "num_actions", "node_depth",
            "terminal")}
        return cls(**kw, size=int(a["size"]), root=int(a["root"]),
                   log_table=np.array(a["log_table"], dtype=np.float32))

    def to_arrays(self) -> dict:
        """Snapshot dict (views of the live arrays)."""
        d = dataclasses.asdict(self)
        d["size"] = np.int32(self.size)
        d["root"] = np.int32(self.root)
        return d


def _node_scores(cfg: TreeConfig, t: MutableTree, node: int) -> np.ndarray:
    return edge_scores_np(
        cfg, child=t.child[node], edge_N=t.edge_N[node],
        edge_W=t.edge_W[node], edge_VL=t.edge_VL[node],
        edge_P=t.edge_P[node], node_N=t.node_N[node: node + 1],
        node_O=t.node_O[node: node + 1],
        num_actions=t.num_actions[node: node + 1], log_table=t.log_table)


def _is_leaf(cfg: TreeConfig, t: MutableTree, node: int, depth: int) -> bool:
    if cfg.leaf_mode == "partial":
        open_node = t.num_expanded[node] < t.num_actions[node]
    else:
        open_node = t.num_expanded[node] == 0
    return bool(open_node or t.terminal[node] != 0 or depth >= cfg.D
                or t.num_actions[node] == 0)


def select_one(cfg: TreeConfig, t: MutableTree):
    """Alg. 1 SELECTION for one worker: descend, applying virtual loss.
    Returns (path_nodes[D], path_actions[D], depth, leaf)."""
    path_nodes = np.full(cfg.D, NULL, dtype=np.int32)
    path_actions = np.full(cfg.D, NULL, dtype=np.int32)
    node = t.root
    t.node_O[node] += 1
    depth = 0
    while not _is_leaf(cfg, t, node, depth):
        scores = _node_scores(cfg, t, node)
        a = int(np.argmax(scores))                   # first maximum
        t.edge_VL[node, a] += 1                      # Alg. 1 line 5
        path_nodes[depth] = node
        path_actions[depth] = a
        node = int(t.child[node, a])
        t.node_O[node] += 1
        depth += 1
    return path_nodes, path_actions, depth, node


def selection_phase(cfg: TreeConfig, t: MutableTree, p: int):
    """All p workers' Selections in worker order, then the BSP
    expansion-assignment post-pass (see repro.core.ref_sequential)."""
    path_nodes = np.full((p, cfg.D), NULL, dtype=np.int32)
    path_actions = np.full((p, cfg.D), NULL, dtype=np.int32)
    depths = np.zeros(p, dtype=np.int32)
    leaves = np.zeros(p, dtype=np.int32)
    for j in range(p):
        pn, pa, d, leaf = select_one(cfg, t)
        path_nodes[j], path_actions[j] = pn, pa
        depths[j], leaves[j] = d, leaf

    expand_action = np.full(p, NULL, dtype=np.int32)
    n_insert = np.zeros(p, dtype=np.int32)
    budget = cfg.X - t.size
    pending: dict[int, int] = {}
    claimed: set[int] = set()
    for j in range(p):
        leaf = int(leaves[j])
        if t.terminal[leaf] or depths[j] >= cfg.D:
            continue
        if cfg.expand_all:
            if leaf in claimed or t.num_expanded[leaf] > 0:
                continue
            k = int(t.num_actions[leaf])
            if k == 0 or budget < k:
                continue
            claimed.add(leaf)
            expand_action[j] = -2
            n_insert[j] = k
            budget -= k
        else:
            a = int(t.num_expanded[leaf]) + pending.get(leaf, 0)
            if a >= int(t.num_actions[leaf]) or budget < 1:
                continue
            pending[leaf] = pending.get(leaf, 0) + 1
            expand_action[j] = a
            n_insert[j] = 1
            budget -= 1
    return dict(
        path_nodes=path_nodes, path_actions=path_actions, depths=depths,
        leaves=leaves, expand_action=expand_action, n_insert=n_insert,
    )


def insert_phase(cfg: TreeConfig, t: MutableTree, sel: dict) -> np.ndarray:
    """Alg. 1 EXPANSION tree half: allocate node ids, link edges.
    Returns new_nodes[p, Fp] (NULL-padded)."""
    p = sel["leaves"].shape[0]
    new_nodes = np.full((p, cfg.Fp), NULL, dtype=np.int32)
    for j in range(p):
        leaf = int(sel["leaves"][j])
        ea = int(sel["expand_action"][j])
        if ea == NULL:
            continue
        actions = range(int(t.num_actions[leaf])) if ea == -2 else [ea]
        for i, a in enumerate(actions):
            nid = t.size
            t.size += 1
            t.child[leaf, a] = nid
            t.node_depth[nid] = t.node_depth[leaf] + 1
            t.num_actions[nid] = cfg.F        # refined by finalize_expansion
            t.num_expanded[leaf] += 1
            new_nodes[j, i] = nid
    return new_nodes


def finalize_expansion(t: MutableTree, nodes, num_actions, terminal,
                       prior_parent=None, priors_fx=None):
    """Host metadata write-back after the 1-step simulations."""
    for i, n in enumerate(np.asarray(nodes, dtype=np.int64)):
        if n == NULL:
            continue
        t.num_actions[n] = num_actions[i]
        t.terminal[n] = terminal[i]
    if priors_fx is not None:
        for i, pa in enumerate(np.asarray(prior_parent, dtype=np.int64)):
            if pa == NULL:
                continue
            t.edge_P[pa] = priors_fx[i]


def backup_phase(cfg: TreeConfig, t: MutableTree, sel: dict, sim_nodes,
                 values_fx, alternating_signs: bool = False, dropped=None):
    """Alg. 1 BACKUP for all p workers in worker order, in exact Qm.16
    integer arithmetic; `dropped` workers only recover virtual loss."""
    p = sim_nodes.shape[0]
    for j in range(p):
        alive = dropped is None or not dropped[j]
        v = np.int32(values_fx[j])
        depth = int(sel["depths"][j])
        leaf = int(sel["leaves"][j])
        ea = int(sel["expand_action"][j])
        single = ea != NULL and ea != -2 and not cfg.expand_all
        sim_depth = depth + (1 if single else 0)
        for d in range(depth):
            node = int(sel["path_nodes"][j, d])
            a = int(sel["path_actions"][j, d])
            sign = -1 if (alternating_signs and (sim_depth - d) % 2 == 1) else 1
            if alive:
                t.edge_N[node, a] += 1
                t.edge_W[node, a:a + 1] += np.int32(sign) * v
                t.node_N[node] += 1
            t.edge_VL[node, a] -= 1
            t.node_O[node] -= 1
        if alive:
            t.node_N[leaf] += 1
        t.node_O[leaf] -= 1
        if alive and single:
            nid = int(sim_nodes[j])
            sign = -1 if (alternating_signs and (sim_depth - depth) % 2 == 1) else 1
            t.edge_N[leaf, ea] += 1
            t.edge_W[leaf, ea:ea + 1] += np.int32(sign) * v
            t.node_N[nid] += 1


def best_root_action(cfg: TreeConfig, t: MutableTree) -> int:
    """Agent action at an MCTS step boundary: robust child (max edge_N),
    ties to the lowest index."""
    n = t.edge_N[t.root].astype(np.int64)
    lane_ok = (np.arange(cfg.Fp) < t.num_actions[t.root]) & (t.child[t.root] != NULL)
    n = np.where(lane_ok, n, -1)
    return int(np.argmax(n))
