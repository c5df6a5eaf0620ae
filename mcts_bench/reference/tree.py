"""The plain tree oracle: p-worker tree-parallel MCTS done sequentially.

A frozen copy of the sequential oracle's arithmetic (paper Alg. 1/2):
one master does the in-tree operations of p workers in worker order,
virtual loss inside the critical region, Qm.16 fixed-point statistics,
first-maximum argmax.  Plain numpy, unvectorized across workers, and
independent of the program under test: it imports nothing of it.
"""

from __future__ import annotations

import numpy as np

NULL = -1
FRAC_BITS = 16
FX_SCALE = np.float32(1 << FRAC_BITS)
FX_INV_SCALE = np.float32(1.0 / (1 << FRAC_BITS))
FX_FORCE_EXPLORE = np.int32(1 << 28)
FX_NEG_INF = np.int32(-(1 << 30))
FX_MIN = np.float32(-(1 << 27))
FX_MAX = np.float32((1 << 27) - 1)     # rounds up to 2**27 in f32, as stored
EXPAND_ALL = -2                        # expand_action of an expand-all worker

TREE_KEYS = ("child", "edge_N", "edge_W", "edge_VL", "edge_P", "node_N",
             "node_O", "num_expanded", "num_actions", "node_depth",
             "terminal")


def encode(x) -> np.ndarray:
    """f32 -> Qm.16 int32: round half to even, then clip."""
    fx = np.round(np.asarray(x, dtype=np.float32) * FX_SCALE)
    return np.clip(fx, FX_MIN, FX_MAX).astype(np.int32)


def pad_fanout(f: int) -> int:
    p = 1
    while p < f:
        p <<= 1
    return p


class Shape:
    """The tree's static settings, read from a configuration's "tree"."""

    def __init__(self, X, F, D, beta=1.0, vl_mode="wu", vl_const=1.0,
                 score_fn="uct", leaf_mode="partial", expand_all=False):
        self.X, self.F, self.D = int(X), int(F), int(D)
        self.Fp = pad_fanout(self.F)
        self.beta = float(beta)
        self.vl_mode, self.score_fn = vl_mode, score_fn
        self.vl_const_fx = int(encode(np.float32(vl_const)))
        self.leaf_mode, self.expand_all = leaf_mode, bool(expand_all)


def log_table(X: int) -> np.ndarray:
    n = np.arange(2 * X + 4, dtype=np.float64)
    with np.errstate(divide="ignore"):
        t = np.log(n)
    t[0] = 0.0
    return t.astype(np.float32)


class Tree:
    """One tree's arrays, mutated in place."""

    def __init__(self, shape: Shape, root_num_actions: int, table=None):
        X, Fp = shape.X, shape.Fp
        self.shape = shape
        self.child = np.full((X, Fp), NULL, np.int32)
        for k in ("edge_N", "edge_W", "edge_VL", "edge_P"):
            setattr(self, k, np.zeros((X, Fp), np.int32))
        for k in ("node_N", "node_O", "num_expanded", "num_actions",
                  "node_depth", "terminal"):
            setattr(self, k, np.zeros(X, np.int32))
        self.num_actions[0] = root_num_actions
        self.size, self.root = 1, 0
        self.log_table = log_table(X) if table is None else table


def edge_scores(s: Shape, t: Tree, node: int) -> np.ndarray:
    i32, f32 = np.int32, np.float32
    child = t.child[node]
    lane = np.arange(child.shape[-1], dtype=i32)
    valid = (lane < t.num_actions[node]) & (child != NULL)
    ne, ns = t.edge_N[node], t.node_N[node: node + 1]
    if s.vl_mode == "wu":
        ne = ne + t.edge_VL[node]
        ns = ns + t.node_O[node: node + 1]
    ns = np.minimum(ns, i32(2 * s.X + 3))
    ne_safe = np.maximum(ne, i32(1)).astype(f32)
    q = (t.edge_W[node].astype(f32) * FX_INV_SCALE) / ne_safe
    if s.score_fn == "uct":
        u = f32(s.beta) * np.sqrt(np.take(t.log_table, ns, axis=0) / ne_safe)
        base = np.where(ne == 0, FX_FORCE_EXPLORE, encode(q + u))
    else:
        q = np.where(ne == 0, f32(0.0), q)
        sqrt_ns = np.sqrt(ns.astype(f32))
        prior = t.edge_P[node].astype(f32) * FX_INV_SCALE
        u = f32(s.beta) * prior * sqrt_ns / (f32(1.0) + ne.astype(f32))
        base = encode(q + u)
    if s.vl_mode == "constant":
        base = base - i32(s.vl_const_fx) * t.edge_VL[node]
    return np.where(valid, base, FX_NEG_INF)


def is_leaf(s: Shape, t: Tree, node: int, depth: int) -> bool:
    if s.leaf_mode == "partial":
        open_node = t.num_expanded[node] < t.num_actions[node]
    else:
        open_node = t.num_expanded[node] == 0
    return bool(open_node or t.terminal[node] != 0 or depth >= s.D
                or t.num_actions[node] == 0)


def select_one(s: Shape, t: Tree):
    path_nodes = np.full(s.D, NULL, np.int32)
    path_actions = np.full(s.D, NULL, np.int32)
    node = t.root
    t.node_O[node] += 1
    depth = 0
    while not is_leaf(s, t, node, depth):
        a = int(np.argmax(edge_scores(s, t, node)))      # first maximum
        t.edge_VL[node, a] += 1
        path_nodes[depth], path_actions[depth] = node, a
        node = int(t.child[node, a])
        t.node_O[node] += 1
        depth += 1
    return path_nodes, path_actions, depth, node


def selection(s: Shape, t: Tree, p: int) -> dict:
    """Every worker's Selection in worker order, then the superstep's
    expansion assignment (partial: one new child per worker, in action
    order; expand-all: a leaf's every child, claimed once)."""
    sel = dict(path_nodes=np.full((p, s.D), NULL, np.int32),
               path_actions=np.full((p, s.D), NULL, np.int32),
               depths=np.zeros(p, np.int32), leaves=np.zeros(p, np.int32),
               expand_action=np.full(p, NULL, np.int32),
               n_insert=np.zeros(p, np.int32))
    for j in range(p):
        pn, pa, d, leaf = select_one(s, t)
        sel["path_nodes"][j], sel["path_actions"][j] = pn, pa
        sel["depths"][j], sel["leaves"][j] = d, leaf
    budget = s.X - t.size
    pending, claimed = {}, set()
    for j in range(p):
        leaf = int(sel["leaves"][j])
        if t.terminal[leaf] or sel["depths"][j] >= s.D:
            continue
        if s.expand_all:
            k = int(t.num_actions[leaf])
            if leaf in claimed or t.num_expanded[leaf] > 0 or k == 0 \
                    or budget < k:
                continue
            claimed.add(leaf)
            sel["expand_action"][j], sel["n_insert"][j] = EXPAND_ALL, k
            budget -= k
        else:
            a = int(t.num_expanded[leaf]) + pending.get(leaf, 0)
            if a >= int(t.num_actions[leaf]) or budget < 1:
                continue
            pending[leaf] = pending.get(leaf, 0) + 1
            sel["expand_action"][j], sel["n_insert"][j] = a, 1
            budget -= 1
    return sel


def insert(s: Shape, t: Tree, sel: dict) -> np.ndarray:
    """Allocate node ids and link edges; returns new_nodes[p, Fp]."""
    p = len(sel["leaves"])
    new_nodes = np.full((p, s.Fp), NULL, np.int32)
    for j in range(p):
        leaf, ea = int(sel["leaves"][j]), int(sel["expand_action"][j])
        if ea == NULL:
            continue
        actions = range(int(t.num_actions[leaf])) if ea == EXPAND_ALL else [ea]
        for i, a in enumerate(actions):
            nid = t.size
            t.size += 1
            t.child[leaf, a] = nid
            t.node_depth[nid] = t.node_depth[leaf] + 1
            t.num_actions[nid] = s.F
            t.num_expanded[leaf] += 1
            new_nodes[j, i] = nid
    return new_nodes


def backup(s: Shape, t: Tree, sel: dict, sim_nodes, values_fx,
           alternating_signs: bool):
    """Every worker's BackUp in worker order, in exact Qm.16 arithmetic."""
    for j in range(len(sim_nodes)):
        v = np.int32(values_fx[j])
        depth, leaf = int(sel["depths"][j]), int(sel["leaves"][j])
        ea = int(sel["expand_action"][j])
        single = ea != NULL and ea != EXPAND_ALL and not s.expand_all
        sim_depth = depth + (1 if single else 0)
        for d in range(depth):
            node = int(sel["path_nodes"][j, d])
            a = int(sel["path_actions"][j, d])
            sign = -1 if (alternating_signs and (sim_depth - d) % 2 == 1) else 1
            t.edge_N[node, a] += 1
            t.edge_W[node, a:a + 1] += np.int32(sign) * v
            t.node_N[node] += 1
            t.edge_VL[node, a] -= 1
            t.node_O[node] -= 1
        t.node_N[leaf] += 1
        t.node_O[leaf] -= 1
        if single:
            sign = -1 if (alternating_signs
                          and (sim_depth - depth) % 2 == 1) else 1
            t.edge_N[leaf, ea] += 1
            t.edge_W[leaf, ea:ea + 1] += np.int32(sign) * v
            t.node_N[int(sim_nodes[j])] += 1


def best_action(t: Tree) -> int:
    """Robust child: most visits, ties to the lowest lane."""
    r = t.root
    n = t.edge_N[r].astype(np.int64)
    ok = (np.arange(t.shape.Fp) < t.num_actions[r]) & (t.child[r] != NULL)
    return int(np.argmax(np.where(ok, n, -1)))


def reroot(t: Tree, new_root: int) -> np.ndarray:
    """Keep the chosen child's subtree, its statistics and its breadth-
    first order as the new node ids; returns old -> new ids."""
    X = t.shape.X
    order, seen = [int(new_root)], {int(new_root)}
    for n in order:
        for c in t.child[n]:
            c = int(c)
            if c != NULL and c not in seen:
                seen.add(c)
                order.append(c)
    old2new = np.full(X, NULL, np.int32)
    old2new[order] = np.arange(len(order), dtype=np.int32)
    n = len(order)
    for k in TREE_KEYS:
        a = getattr(t, k)
        out = np.zeros_like(a) if k != "child" else np.full_like(a, NULL)
        if k == "child":
            ch = a[order]
            out[:n] = np.where(ch != NULL, old2new[np.clip(ch, 0, X - 1)], NULL)
        elif k == "node_depth":
            out[:n] = a[order] - a[new_root]
        else:
            out[:n] = a[order]
        setattr(t, k, out)
    t.size, t.root = n, 0
    return old2new
