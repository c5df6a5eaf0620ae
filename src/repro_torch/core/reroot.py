"""Subtree-reusing Tree Flush (beyond-paper).

The paper flushes the entire tree at each MCTS step ("the best child
becomes the new root while the rest of the tree are flushed") because the
FPGA statically banks SRAM per level — its own future-work section names
dynamic bank management as an open problem.  Off the FPGA the UCT is
just arrays, so we can re-root: extract the chosen child's subtree, compact
node ids, and keep all of its statistics — every simulation spent below
the chosen action carries over to the next step.

The BFS and relabelling run in numpy on the host snapshot at the step
boundary (off the hot superstep path), exactly as repro.core.reroot
does; `reroot_tree` hands the result back as a tree of tensors on the
executor's device.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.tree import NULL, TreeConfig, UCTree, from_numpy


def reroot(cfg: TreeConfig, snap: dict, new_root: int):
    """snap: numpy snapshot of a UCTree (executor.snapshot()).
    Returns (new UCTree arrays as numpy dict, old_to_new index map)."""
    X = cfg.X
    child = snap["child"]
    # BFS from new_root
    order = [int(new_root)]
    seen = {int(new_root)}
    for n in order:
        for c in child[n]:
            c = int(c)
            if c != NULL and c not in seen:
                seen.add(c)
                order.append(c)
    old2new = np.full(X, NULL, np.int32)
    for new_id, old_id in enumerate(order):
        old2new[old_id] = new_id

    fresh = {k: np.array(v) for k, v in snap.items()
             if k not in ("size", "root", "log_table")}
    out = {}
    for k in ("edge_N", "edge_W", "edge_VL", "edge_P",
              "num_expanded", "num_actions", "terminal",
              "node_N", "node_O"):
        dst = np.zeros_like(fresh[k])
        dst[: len(order)] = fresh[k][order]
        out[k] = dst
    ch = np.full_like(fresh["child"], NULL)
    remapped = np.where(child[order] != NULL,
                        old2new[np.clip(child[order], 0, X - 1)], NULL)
    ch[: len(order)] = remapped
    out["child"] = ch
    nd = np.zeros_like(fresh["node_depth"])
    nd[: len(order)] = fresh["node_depth"][order] - int(
        fresh["node_depth"][new_root])
    out["node_depth"] = nd
    out["size"] = np.int32(len(order))
    out["root"] = np.int32(0)
    out["log_table"] = np.array(snap["log_table"])
    return out, old2new


def reroot_tree(cfg: TreeConfig, snap: dict, new_root: int,
                device) -> tuple[UCTree, np.ndarray]:
    """reroot() with the new tree as tensors on `device`."""
    arrays, old2new = reroot(cfg, snap, new_root)
    return from_numpy(arrays, device), old2new
