"""Trees of tensors: nested dicts and lists (and tuples) with tensors or
other objects at the leaves, the containers the port's parameters,
optimizer state and checkpoints are made of (the JAX package uses
``jax.tree``).  Dict keys are visited in sorted order, as ``jax.tree``
visits them, so a tree's leaves come in the JAX package's order.
"""

from __future__ import annotations

_CONTAINERS = (dict, list, tuple)


def _children(node):
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    return list(node)


def tree_leaves(tree) -> list:
    """The leaves of `tree`, depth first (an empty container has none)."""
    if not isinstance(tree, _CONTAINERS):
        return [tree]
    return [l for c in _children(tree) for l in tree_leaves(c)]


def tree_structure(tree):
    """The tree with every leaf replaced by None (its "treedef")."""
    return tree_map(lambda _: None, tree)


def tree_unflatten(structure, leaves):
    """The tree of `structure` (from tree_structure) holding `leaves` in
    tree_leaves order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn, tree, *rest, is_leaf=None):
    """fn over the leaves of `tree` and the matching leaves of `rest`
    (trees of the same structure); returns a tree of that structure."""
    if (is_leaf is not None and is_leaf(tree)) or not isinstance(
            tree, _CONTAINERS):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError(f"tree structures differ: keys {sorted(tree)}")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    for r in rest:
        if not isinstance(r, (list, tuple)) or len(r) != len(tree):
            raise ValueError("tree structures differ: sequence lengths")
    return type(tree)(tree_map(fn, *cs, is_leaf=is_leaf)
                      for cs in zip(tree, *rest))
