"""One search request, worked out by the plain reference.

A request is a root state, a budget of supersteps a move and a number of
moves.  A move ends when its budget is spent, the tree is full, or a
superstep inserts nothing; the robust child is committed, and the chosen
child's subtree is kept as the next move's tree (or a fresh tree, where
the child was never expanded or subtree reuse is off).  Each superstep is
Selection of p workers, Node Insertion, the host's one-step expansions
(every child of a leaf in expand-all mode), one simulation batch, the
expansions' metadata (and priors), and BackUp.
"""

from __future__ import annotations

import numpy as np

from mcts_bench.reference import tree as T


def run_search(shape: T.Shape, env, evaluate, root_state, p: int,
               budget: int, moves: int, max_moves: int,
               reuse_subtree: bool = True,
               alternating_signs: bool = False) -> list:
    """[(action, root visit counts [F]), ...] of the first `max_moves`
    moves.  `evaluate(states [p, S]) -> (values [p] f32, priors [p, A]
    or None)`."""
    out: list = []
    na = env.num_actions(root_state)
    if na == 0 or max_moves <= 0:
        return out
    table = T.log_table(shape.X)
    t = T.Tree(shape, na, table)
    st = {0: np.asarray(root_state, np.float32)}
    state, move_supersteps, prev_size = st[0], 0, 1
    while True:
        sel = T.selection(shape, t, p)
        new_nodes = T.insert(shape, t, sel)
        leaves = sel["leaves"]
        sim_nodes = leaves.copy()
        sim_states = np.stack([st[int(n)] for n in leaves])
        fin, prior_rows = [], []
        for j in range(p):
            ea = int(sel["expand_action"][j])
            if ea == T.NULL:
                continue
            leaf_state = st[int(leaves[j])]
            if ea == T.EXPAND_ALL:
                for a in range(int(sel["n_insert"][j])):
                    s2, _, term = env.step(leaf_state, a)
                    nid = int(new_nodes[j, a])
                    st[nid] = s2
                    fin.append((nid, 0 if term else env.num_actions(s2), term))
                prior_rows.append((int(leaves[j]), j))
            else:
                s2, _, term = env.step(leaf_state, ea)
                nid = int(new_nodes[j, 0])
                st[nid] = s2
                fin.append((nid, 0 if term else env.num_actions(s2), term))
                sim_nodes[j], sim_states[j] = nid, s2
        values, priors = evaluate(sim_states)
        for nid, n_act, term in fin:
            t.num_actions[nid], t.terminal[nid] = n_act, int(term)
        for parent, j in prior_rows:
            row = np.zeros(shape.Fp, np.float32)
            row[:priors.shape[1]] = priors[j]
            t.edge_P[parent] = T.encode(row)
        T.backup(shape, t, sel, sim_nodes,
                 T.encode(np.asarray(values, np.float32)), alternating_signs)
        move_supersteps += 1
        done = (move_supersteps >= budget or t.size >= shape.X
                or t.size == prev_size)
        prev_size = t.size
        if not done:
            continue
        a = T.best_action(t)
        out.append((a, t.edge_N[t.root][:shape.F].astype(np.int64)))
        state, _, term = env.step(state, a)
        if term or len(out) >= min(moves, max_moves):
            return out
        move_supersteps = 0
        new_root = int(t.child[t.root, a])
        if reuse_subtree and new_root != T.NULL:
            old2new = T.reroot(t, new_root)
            st = {int(old2new[k]): v for k, v in st.items() if old2new[k] >= 0}
            prev_size = t.size
        else:
            t = T.Tree(shape, max(env.num_actions(state), 1), table)
            st = {0: state}
            prev_size = 1
