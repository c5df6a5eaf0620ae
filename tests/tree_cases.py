"""Seeded tree states the tree kernels are held on against their plain
versions: random valid trees at any width, and the Selection kernel's
hazard cases.  chip_smoke.py (phase 2, with tests/ on its path),
tests/test_torch_cuda.py (the kernel against the plain version on the
card) and tests/test_torch_kernels.py (the plain version against the JAX
package on the CPU) all draw from here, so the three hold the same cases.
Test data, not part of the repro_torch package.

Every function returns numpy arrays in the snapshot form of
``core.tree.init_tree_arrays`` (one tree, no [G] axis) and draws only from
the numpy RandomState it is given.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.core.tree import NULL, TreeConfig, init_tree_arrays

PONG = dict(X=56_000, F=6, D=9)
GOMOKU = dict(X=48_000, F=36, D=5, score_fn="puct", leaf_mode="unexpanded",
              expand_all=True)


def random_tree(cfg: TreeConfig, n_nodes: int, rng) -> dict:
    """A structurally valid tree of `n_nodes` nodes grown breadth-first
    (children in lanes 0..k-1 as insertion puts them; expand-all nodes
    are all-or-nothing), with random statistics, small in-flight counts
    and a few node visit counts past the ln-table cap."""
    X, F, D, Fp = cfg.X, cfg.F, cfg.D, cfg.Fp
    a = init_tree_arrays(cfg)
    child, depth = a["child"], a["node_depth"]
    na, term, nexp = a["num_actions"], a["terminal"], a["num_expanded"]
    size, frontier = 1, deque([0])
    while frontier and size < n_nodes:
        node = frontier.popleft()
        if depth[node] >= D or term[node] or na[node] == 0:
            continue
        k = int(na[node])
        if cfg.expand_all:
            kids = k if rng.rand() < 0.85 else 0
            if kids > n_nodes - size:
                kids = 0
        else:
            kids = k if rng.rand() < 0.7 else rng.randint(0, k + 1)
            kids = min(kids, n_nodes - size)
        for lane in range(kids):
            c = size
            size += 1
            child[node, lane] = c
            depth[c] = depth[node] + 1
            term[c] = int(rng.rand() < 0.05)
            na[c] = 0 if term[c] else rng.randint(1, F + 1)
            frontier.append(c)
        nexp[node] = kids
    has = child != NULL
    a["edge_N"] = np.where(has & (rng.rand(X, Fp) < 0.9),
                           rng.randint(1, 60, (X, Fp)), 0).astype(np.int32)
    a["edge_W"] = (a["edge_N"] * rng.randint(-65536, 65537, (X, Fp))
                   ).astype(np.int32)
    a["edge_VL"] = np.where(has, rng.choice([0, 0, 0, 1, 2], (X, Fp)),
                            0).astype(np.int32)
    a["edge_P"] = np.where(np.arange(Fp) < na[:, None],
                           rng.randint(0, 65537, (X, Fp)), 0).astype(np.int32)
    live = np.arange(X) < size
    a["node_N"] = np.where(live, rng.randint(0, 400, X), 0).astype(np.int32)
    a["node_N"][rng.randint(0, size, 3)] = 3 * X      # past the ln-table cap
    a["node_O"] = np.where(live, rng.choice([0, 0, 1], X), 0).astype(np.int32)
    a["size"] = np.int32(size)
    return a


def random_arena(cfg: TreeConfig, G: int, rng, fill=None) -> dict:
    """G random trees stacked on a leading [G] axis; each holds `fill`
    nodes, or a random count in [X/2, X]."""
    slots = []
    for _ in range(G):
        n = fill if fill is not None else rng.randint(cfg.X // 2, cfg.X + 1)
        slots.append(random_tree(cfg, n, rng))
    return {k: np.stack([s[k] for s in slots]) for k in slots[0]}


def _fresh_expanded_root(cfg: TreeConfig) -> dict:
    """A root with all F children inserted and nothing visited yet."""
    a = init_tree_arrays(cfg)
    kids = np.arange(1, cfg.F + 1)
    a["child"][0, :cfg.F] = kids
    a["num_expanded"][0] = cfg.F
    a["num_actions"][kids] = cfg.F
    a["node_depth"][kids] = 1
    a["size"] = np.int32(cfg.F + 1)
    return a


def _inflight(cfg: TreeConfig, rng) -> dict:
    """Large in-flight counts at launch, as a BackUp that drops stragglers
    leaves them."""
    a = random_tree(cfg, cfg.X - 8, rng)
    has = a["child"] != NULL
    a["edge_VL"] = np.where(has, rng.randint(0, 6, has.shape), 0).astype(np.int32)
    live = np.arange(cfg.X) < int(a["size"])
    a["node_O"] = np.where(live, rng.randint(0, 5, cfg.X), 0).astype(np.int32)
    return a


def _ln_cap(cfg: TreeConfig, rng) -> dict:
    """The root and its children at node_N + node_O = 2X+2: the first
    visit makes them read ln-table entry 2X+3 (the cap), later ones read
    past it and are clamped there."""
    a = random_tree(cfg, cfg.X - 4, rng)
    top = 2 * cfg.X + 2
    nodes = np.concatenate([[0], a["child"][0][a["child"][0] != NULL]])
    a["node_N"][nodes] = top - a["node_O"][nodes]
    return a


def _ln_low(cfg: TreeConfig, rng) -> dict:
    """Visit counts at the low end of the ln table, where one in-flight
    visit more or less moves ln(n) most (ln 1 = 0, ln 2 = 0.69)."""
    a = random_tree(cfg, cfg.X - 4, rng)
    live = np.arange(cfg.X) < int(a["size"])
    a["node_N"] = np.where(live, rng.randint(0, 3, cfg.X), 0).astype(np.int32)
    a["node_O"] = np.where(live, rng.randint(0, 2, cfg.X), 0).astype(np.int32)
    return a


# name -> (TreeConfig kwargs, p, builder(cfg, rng) -> arrays)
HAZARDS = {
    "inflight-wu": (dict(X=128, F=4, D=5), 16, _inflight),
    "inflight-constant": (dict(X=128, F=6, D=4, vl_mode="constant",
                               vl_const=0.5), 16, _inflight),
    "p48": (dict(X=256, F=4, D=5), 48,
            lambda cfg, rng: random_tree(cfg, 200, rng)),
    "p48-expand-all": (dict(X=256, F=36, D=3, score_fn="puct",
                            leaf_mode="unexpanded", expand_all=True), 48,
                       lambda cfg, rng: random_tree(cfg, cfg.X - 40, rng)),
    "ln-cap": (dict(X=64, F=4, D=4), 16, _ln_cap),
    "ln-low": (dict(X=128, F=4, D=5), 16, _ln_low),
    "fresh-tie-wu": (dict(X=64, F=6, D=4), 16,
                     lambda cfg, rng: _fresh_expanded_root(cfg)),
    "fresh-tie-constant": (dict(X=64, F=6, D=4, vl_mode="constant"), 16,
                           lambda cfg, rng: _fresh_expanded_root(cfg)),
    "gomoku": (GOMOKU, 16, lambda cfg, rng: random_tree(cfg, cfg.X - 50, rng)),
}


def hazard(name: str, seed: int = 0) -> tuple[TreeConfig, dict, int]:
    """(cfg, one tree's arrays, p) of hazard case `name`, from `seed`."""
    kw, p, build = HAZARDS[name]
    cfg = TreeConfig(**kw)
    return cfg, build(cfg, np.random.RandomState(seed)), p


def as_slot(arrays: dict) -> dict:
    """One tree's arrays as an arena of one slot (a leading [1] axis)."""
    return {k: np.asarray(v)[None] for k, v in arrays.items()}
