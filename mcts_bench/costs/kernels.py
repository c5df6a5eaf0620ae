"""Bytes and operations of one launch of each tree kernel, from the paths
its workers walked (a copy of the counts that chip_smoke.py keeps beside
its kernel timings).

Each distinct input word is read once and each output word written once.
Selection reads the edge rows of the nodes on the paths (child, N, W, VL,
and P under PUCT: Fp lanes each) and six words of each node on them or at
a leaf, writes each (node, action) virtual loss once, each node's
in-flight count once and p x (2D + 5) words of results; it scores each
lane of a row in 12 f32 operations.  BackUp reads the selection's
p x (2D + 5) words and reads and writes three words of each edge and two
of each node it updates.

Where the paths are not visible (a launch inside a replayed CUDA graph),
`model_paths` stands in: every worker walks a distinct path of depth D
below the shared root, which counts more than a tree's shared upper
levels need.
"""

from __future__ import annotations

import numpy as np

from mcts_bench.reference.tree import NULL, pad_fanout  # noqa: F401


def select_cost(Fp: int, puct: bool, sel: dict, D: int) -> tuple:
    """(bytes, flops) of one Selection launch; `sel` holds [G, p, D]
    path_nodes and path_actions and [G, p] leaves of the active slots."""
    pn, pa, leaves = sel["path_nodes"], sel["path_actions"], sel["leaves"]
    G, p = leaves.shape
    n_edge_arrays = 5 if puct else 4
    rows = nodes = vl_words = 0
    for g in range(G):
        on = pn[g] >= 0
        visited = set(pn[g][on].tolist())
        rows += len(visited)
        nodes += len(visited | set(leaves[g].tolist()))
        vl_words += len(set(zip(pn[g][on].tolist(), pa[g][on].tolist())))
    read = (rows * n_edge_arrays * Fp + nodes * 6) * 4
    written = (vl_words + nodes + G * p * (2 * D + 5)) * 4
    return read + written, rows * Fp * 12


def backup_cost(sel: dict, D: int) -> tuple:
    """(bytes, operations) of one BackUp launch over the same paths."""
    pn, pa, leaves = sel["path_nodes"], sel["path_actions"], sel["leaves"]
    G, p = leaves.shape
    edges = nodes = 0
    for g in range(G):
        on = pn[g] >= 0
        edges += len(set(zip(pn[g][on].tolist(), pa[g][on].tolist()))) + p
        nodes += len(set(pn[g][on].tolist()) | set(leaves[g].tolist())) + p
    inputs = G * p * (2 * D + 5) * 4
    rmw = (edges * 3 + nodes * 2) * 4 * 2
    return inputs + rmw, edges * 3 + nodes * 2


def model_paths(G: int, p: int, D: int) -> dict:
    """Paths of depth D for every worker of G slots, distinct below the
    root (node ids are made up; only their sharing matters)."""
    pn = np.full((G, p, D), NULL, np.int64)
    pa = np.zeros((G, p, D), np.int64)
    pn[:, :, 0] = 0
    pa[:, :, 0] = np.arange(p)
    for d in range(1, D):
        pn[:, :, d] = 1 + (d - 1) * p + np.arange(p)
    leaves = np.broadcast_to(1 + (D - 1) * p + np.arange(p), (G, p)).copy()
    return dict(path_nodes=pn, path_actions=pa, leaves=leaves)
