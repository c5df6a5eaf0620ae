"""Port vs JAX package: the batched in-tree ops, bit for bit.

Selection (faithful), Node Insertion, finalize, BackUp (alternating signs
on and off, with and without a straggler mask) and best_root_action of
repro_torch.core.intree against repro.core.intree, on trees grown with
the JAX ops (tests/test_kernels_uct.py grow_tree) for every TREE_SWEEP
config x p in {1, 4, 16}; then the arena forms at G=4 under random active
masks.  The port runs on the CPU; every array is int32 and compared with
zero tolerance.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixedpoint as jfx
from repro.core import intree as jintree
from repro.core.tree import stack_trees
from repro_torch.core import intree as tintree
from repro_torch.core.tree import NULL, TreeConfig as TCfg, from_numpy, to_numpy
from test_kernels_uct import TREE_SWEEP, grow_tree

CFG_IDS = lambda c: f"F{c.F}-D{c.D}-{c.vl_mode}-{c.score_fn}"
STATS = ("child", "edge_N", "edge_W", "edge_VL", "edge_P", "node_N", "node_O",
         "num_expanded", "num_actions", "node_depth", "terminal", "size",
         "root")


def jax_arrays(tree) -> dict:
    return {f.name: np.array(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def assert_trees_equal(jtree, ttree):
    a, b = jax_arrays(jtree), to_numpy(ttree)
    for k in STATS + ("log_table",):
        np.testing.assert_array_equal(b[k], a[k].astype(b[k].dtype), err_msg=k)


def assert_sel_equal(jsel, tsel, rows=None):
    for k in tintree.SEL_FIELDS:
        want = np.asarray(getattr(jsel, k)).astype(np.int32)
        got = getattr(tsel, k).numpy()
        if rows is not None:
            want, got = want[rows], got[rows]
        np.testing.assert_array_equal(got, want, err_msg=k)


def finalize_rows(cfg, new_nodes, sel_leaves, sel_ea, rng):
    """Per-tree finalize arguments: random legal-action counts and terminal
    flags for every inserted node; random prior rows for expand-all."""
    p, Fp = new_nodes.shape
    K = p * Fp if cfg.expand_all else p
    ins = new_nodes.reshape(-1)
    ins = ins[ins != NULL][:K]
    nodes = np.full(K, NULL, np.int32)
    nodes[:len(ins)] = ins
    na = np.zeros(K, np.int32)
    na[:len(ins)] = rng.randint(0, cfg.F + 1, len(ins))
    term = np.zeros(K, np.int32)
    term[:len(ins)] = (na[:len(ins)] == 0)
    pp = np.full(p, NULL, np.int32)
    pf = np.zeros((p, Fp), np.int32)
    parents = sel_leaves[sel_ea == -2]
    pp[:len(parents)] = parents
    pf[:len(parents)] = rng.randint(0, 65537, (len(parents), Fp))
    return nodes, na, term, pp, pf


@pytest.mark.parametrize("cfg", TREE_SWEEP, ids=CFG_IDS)
@pytest.mark.parametrize("p", [1, 4, 16])
def test_phases_match_jax(cfg, p):
    rng = np.random.RandomState(p)
    tcfg = TCfg(**dataclasses.asdict(cfg))
    jt = grow_tree(cfg, supersteps=2, p=4)
    tt = from_numpy(jax_arrays(jt), "cpu")

    jt, jsel = jintree.select_batch(cfg, jt, p)
    tsel = tintree.select_batch(tcfg, tt, p)
    assert_sel_equal(jsel, tsel)
    assert_trees_equal(jt, tt)

    jt, jnew = jintree.insert_batch(cfg, jt, jsel)
    tnew = tintree.insert_batch(tcfg, tt, tsel)
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
    assert_trees_equal(jt, tt)

    fin = finalize_rows(cfg, np.asarray(jnew), np.asarray(jsel.leaves),
                        np.asarray(jsel.expand_action), rng)
    priors = fin[3:] if cfg.expand_all else (None, None)
    jt = jintree.finalize_expansion_batch(jt, *map(jnp.asarray, fin[:3]),
                                          *[None if x is None else jnp.asarray(x)
                                            for x in priors])
    tintree.finalize_expansion_batch(tt, *fin[:3], *priors)
    assert_trees_equal(jt, tt)

    sim = np.where(np.asarray(jsel.expand_action) >= 0, np.asarray(jnew)[:, 0],
                   np.asarray(jsel.leaves)).astype(np.int32)
    vals = np.asarray(jfx.encode(rng.uniform(-1, 1, p).astype(np.float32)))
    drop = rng.rand(p) < 0.4
    for alternating in (False, True):
        for dropped in (None, drop):
            jb = jintree.backup_batch(
                cfg, jt, jsel, jnp.asarray(sim), jnp.asarray(vals), alternating,
                dropped is not None,
                None if dropped is None else jnp.asarray(dropped))
            tb = from_numpy(to_numpy(tt), "cpu")
            tintree.backup_batch(tcfg, tb, tsel, sim, vals, alternating, dropped)
            assert_trees_equal(jb, tb)
            assert int(tintree.best_root_action(tb)) == int(
                jintree.best_root_action(jb))


@pytest.mark.parametrize("cfg", TREE_SWEEP, ids=CFG_IDS)
def test_arena_forms_match_jax(cfg):
    G, p = 4, 4
    rng = np.random.RandomState(7)
    tcfg = TCfg(**dataclasses.asdict(cfg))
    jarena = stack_trees([grow_tree(cfg, supersteps=1 + g % 3, p=4, seed=g)
                          for g in range(G)])
    tarena = from_numpy(jax_arrays(jarena), "cpu")
    for step in range(3):
        active = rng.rand(G) < 0.6
        active[rng.randint(G)] = True
        rows = np.flatnonzero(active)
        jarena, jsel = jintree.select_arena(cfg, jarena, jnp.asarray(active), p)
        tsel = tintree.select_arena(tcfg, tarena, active, p)
        assert_sel_equal(jsel, tsel, rows)
        assert_trees_equal(jarena, tarena)

        jarena, jnew = jintree.insert_arena(cfg, jarena, jnp.asarray(active), jsel)
        tnew = tintree.insert_arena(tcfg, tarena, active, tsel)
        np.testing.assert_array_equal(tnew.numpy()[rows], np.asarray(jnew)[rows])
        assert_trees_equal(jarena, tarena)

        fins = []
        for g in range(G):
            if active[g]:
                fins.append(finalize_rows(
                    cfg, np.asarray(jnew)[g], np.asarray(jsel.leaves)[g],
                    np.asarray(jsel.expand_action)[g], rng))
            else:
                K = p * cfg.Fp if cfg.expand_all else p
                fins.append((np.full(K, NULL, np.int32), np.zeros(K, np.int32),
                             np.zeros(K, np.int32), np.full(p, NULL, np.int32),
                             np.zeros((p, cfg.Fp), np.int32)))
        fin = [np.stack([f[i] for f in fins]) for i in range(5)]
        jarena = jintree.finalize_arena(jarena, *map(jnp.asarray, fin))
        tintree.finalize_arena(tarena, *fin)
        assert_trees_equal(jarena, tarena)

        new = np.asarray(jnew)
        sim = np.where(np.asarray(jsel.expand_action) >= 0, new[:, :, 0],
                       np.asarray(jsel.leaves)).astype(np.int32)
        vals = np.asarray(jfx.encode(rng.uniform(-1, 1, (G, p)).astype(np.float32)))
        alternating = step == 2
        dropped = (rng.rand(G, p) < 0.3) if step == 1 else None
        jarena = jintree.backup_arena(
            cfg, jarena, jnp.asarray(active), jsel, jnp.asarray(sim),
            jnp.asarray(vals), alternating, dropped is not None, dropped)
        tintree.backup_arena(tcfg, tarena, active, tsel, sim, vals, alternating,
                             dropped)
        assert_trees_equal(jarena, tarena)
    np.testing.assert_array_equal(
        tintree.best_root_action_arena(tarena).numpy(),
        np.asarray(jintree.best_root_action_arena(jarena)))


def test_selection_variants_not_ported_raise():
    cfg = TCfg(X=16, F=2, D=2)
    from repro_torch.core.tree import init_arena
    arena = init_arena(cfg, 1, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tintree.select_arena(cfg, arena, torch.ones(1, dtype=torch.bool), 2,
                             variant="wavefront")
