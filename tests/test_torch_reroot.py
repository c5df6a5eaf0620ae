"""The re-root on the arena (kernels.reroot's plain twin, the executors'
``reroot_slot`` and the pool's move commit) against the JAX package, on
the CPU.

  * the twin equals ``repro.core.reroot.reroot`` on every field and on
    old2new, over trees grown by the port's searches at Pong's shape
    (F=6, Fp=8, D=9, UCT, partial expansion) and Gomoku's (F=36, Fp=64,
    D=5, PUCT, expand-all) at a reduced X: every child of the root as the
    new root (through ``TorchExecutor.reroot_slot``), a leaf with no
    children, a saturated tree (size == X), and a child never expanded
    (the slot left as it was); the arena's other slots are untouched;
  * the serving pools with subtree reuse: the stream equals the JAX
    package's, no commit reads the whole tree unless its request keeps
    it, and ``service_reroots_total{path="device"}`` counts the
    re-rooting commits.

The kernel itself against the twin: tests/test_torch_cuda.py (card).
"""

import functools

import numpy as np
import pytest

from repro.core.reroot import reroot as jax_reroot
from repro.core import TreeConfig as JCfg
from repro.envs import BanditTreeEnv as JEnv, BanditValueBackend as JValue
from repro.service import SearchClient as JClient, SearchRequest as JRequest
from repro_torch.core import TreeConfig, TreeParallelMCTS
from repro_torch.core.executor import TorchExecutor, make_intree_executor
from repro_torch.core.tree import FIELDS, NULL, from_numpy, init_tree_arrays
from repro_torch.envs import BanditTreeEnv, BanditValueBackend
from repro_torch.envs.gomoku import GomokuEnv, GomokuRolloutBackend
from repro_torch.kernels import reroot as kreroot
from repro_torch.service import SearchClient, SearchRequest

PONG = dict(F=6, D=9)
GOMOKU = dict(F=36, D=5, score_fn="puct", leaf_mode="unexpanded",
              expand_all=True)
# shape: (X, supersteps) of the grown tree and of the saturated one
GROWN = {"pong": ((2000, 30), (300, 25)), "gomoku": ((3000, 8), (270, 12))}


def cfg_of(shape: str, X: int) -> TreeConfig:
    return TreeConfig(X=X, **(PONG if shape == "pong" else GOMOKU))


@functools.lru_cache(maxsize=None)
def grown(shape: str, X: int, supersteps: int) -> dict:
    """A tree grown by the port's search (TreeParallelMCTS, p=16, on the
    CPU), in the snapshot form."""
    cfg = cfg_of(shape, X)
    if shape == "pong":
        env, sim, alt = BanditTreeEnv(fanout=6, terminal_depth=12), \
            BanditValueBackend(), False
    else:
        env = GomokuEnv()
        sim, alt = GomokuRolloutBackend(env, 1), True
    m = TreeParallelMCTS(cfg, env, sim, p=16, executor="faithful",
                         alternating_signs=alt, seed=3, device="cpu")
    for _ in range(supersteps):
        m.superstep()
    return m.exec.snapshot(m.tree)


def arena_of(cfg, tree: dict, g: int = 1, G: int = 3) -> TorchExecutor:
    """A G-slot CPU executor holding `tree` in slot g and fresh trees
    with their own root counts in the others."""
    ex = TorchExecutor(cfg, G, device="cpu")
    for h in range(G):
        arrays = tree if h == g else init_tree_arrays(cfg, 2 + h)
        ex.set_tree(from_numpy(arrays, "cpu"), h)
    return ex


def assert_tree_equal(got: dict, want: dict, label: str):
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f"{label}: {k}")


def leaf_of(tree: dict) -> int:
    """The deepest node with no children (the last one inserted)."""
    size = int(tree["size"])
    leaves = np.flatnonzero((tree["child"][:size] == NULL).all(axis=1))
    return int(leaves[np.argmax(tree["node_depth"][leaves])])


CASES = ([("pong", "child", a) for a in range(6)]
         + [("gomoku", "child", a) for a in range(36)]
         + [(s, c, None) for s in ("pong", "gomoku")
            for c in ("leaf", "saturated", "unexpanded")])


@pytest.mark.parametrize("shape,case,lane", CASES,
                         ids=[f"{s}-{c}" + ("" if a is None else f"{a}")
                              for s, c, a in CASES])
def test_twin_equals_jax_reroot(shape, case, lane):
    (X, steps), (Xs, steps_s) = GROWN[shape]
    if case == "saturated":
        X, steps = Xs, steps_s
    cfg = cfg_of(shape, X)
    if case == "unexpanded":
        tree = init_tree_arrays(cfg)
    else:
        tree = grown(shape, X, steps)
    if case == "saturated":
        assert int(tree["size"]) == X
    ex = arena_of(cfg, tree)
    others = [ex.slot_snapshot(h) for h in (0, 2)]
    root = int(tree["root"])
    if case == "leaf":
        new_root = leaf_of(tree)
        assert (tree["child"][new_root] == NULL).all()
        sc = kreroot.Scratch(cfg.X, cfg.Fp, "cpu")
        kreroot.reroot(ex.trees, 1, new_root, sc)
        old2new = kreroot.old2new_of(kreroot.read_order(sc), cfg.X)
        kreroot.write(ex.trees, 1, sc)
    else:
        # the child under `lane`; the saturated and unexpanded cases take
        # the root's most visited lane, as a move commit would
        a = int(np.argmax(tree["edge_N"][root])) if lane is None else lane
        new_root = int(tree["child"][root, a])
        if case != "unexpanded":
            assert new_root != NULL
        counts, got_root, old2new = ex.reroot_slot(1, a)
        np.testing.assert_array_equal(counts, tree["edge_N"][root][:cfg.F])
        assert got_root == new_root
    if new_root == NULL:
        assert old2new is None
        assert_tree_equal(ex.slot_snapshot(1), tree, "unexpanded")
    else:
        want, want_map = jax_reroot(cfg, tree, new_root)
        assert_tree_equal(ex.slot_snapshot(1), want, f"{shape}-{case}")
        np.testing.assert_array_equal(old2new, want_map)
    for h, before in zip((0, 2), others):
        assert_tree_equal(ex.slot_snapshot(h), before, f"slot {h}")


# -- the serving pools ------------------------------------------------------

CFG = dict(X=160, F=4, D=6)


def requests(keep_tree: bool) -> list:
    rng = np.random.RandomState(7)
    return [dict(uid=i, seed=int(rng.randint(100)),
                 budget=int(rng.randint(2, 6)), moves=int(rng.randint(2, 4)),
                 keep_tree=keep_tree) for i in range(7)]


def stream(client_cls, cfg_cls, env_cls, value_cls, request_cls, keep_tree,
           **kw):
    cl = client_cls(env_cls(fanout=4, terminal_depth=10), value_cls(), G=3,
                    p=4, default_cfg=cfg_cls(**CFG), **kw)
    try:
        hs = [cl.submit(request_cls(**r)) for r in requests(keep_tree)]
        return {h.uid: h.result() for h in hs}, cl
    finally:
        cl.close()


@functools.lru_cache(maxsize=None)
def jax_results(keep_tree: bool) -> dict:
    return stream(JClient, JCfg, JEnv, JValue, JRequest, keep_tree,
                  executor="reference")[0]


POOLS = {"masked": dict(), "compacted": dict(compact_threshold=0.5),
         "fused": dict(supersteps_per_dispatch=4),
         "shards": dict(n_shards=3), "overlap": dict(overlap=True)}


@pytest.mark.parametrize("keep_tree", [False, True], ids=["tree-off",
                                                          "tree-kept"])
@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("executor", ["faithful", "cuda"])
def test_pool_reroots_on_the_arena(executor, pool, keep_tree, monkeypatch):
    snapshots, reroots = [], []
    snapshot, reroot_slot = TorchExecutor.slot_snapshot, \
        TorchExecutor.reroot_slot

    def counted_snapshot(ex, g):
        if not keep_tree:
            raise AssertionError("a commit read the whole tree")
        snapshots.append(g)
        return snapshot(ex, g)

    def counted_reroot(ex, g, a, *args, **kw):
        out = reroot_slot(ex, g, a, *args, **kw)
        reroots.append(out[2] is not None)
        return out

    monkeypatch.setattr(TorchExecutor, "slot_snapshot", counted_snapshot)
    monkeypatch.setattr(TorchExecutor, "reroot_slot", counted_reroot)
    got, cl = stream(SearchClient, TreeConfig, BanditTreeEnv,
                     BanditValueBackend, SearchRequest, keep_tree,
                     executor=executor, device="cpu", metrics=True,
                     **POOLS[pool])
    want = jax_results(keep_tree)
    assert sorted(got) == sorted(want)
    for uid, b in want.items():
        a = got[uid]
        assert (a.actions, a.rewards, a.supersteps) == \
            (b.actions, b.rewards, b.supersteps), uid
        for va, vb in zip(a.visit_counts, b.visit_counts, strict=True):
            np.testing.assert_array_equal(va, vb)
        assert (a.tree_snapshot is None) == (not keep_tree)
        for k in b.tree_snapshot or {}:
            np.testing.assert_array_equal(
                a.tree_snapshot[k], np.asarray(b.tree_snapshot[k]).astype(
                    a.tree_snapshot[k].dtype), err_msg=f"uid={uid} {k}")
    # one whole-tree read per kept tree, at the request's last move
    assert len(snapshots) == (len(want) if keep_tree else 0)
    assert sum(reroots) == sum(len(r.actions) - 1 for r in want.values())
    series = cl.registry.snapshot()["service_reroots_total"]
    assert sum(v for k, v in series.items() if 'path="device"' in k) \
        == sum(reroots) > 0
    assert not any('path="host"' in k for k in series)


def test_reference_pool_counts_host_reroots():
    got, cl = stream(SearchClient, TreeConfig, BanditTreeEnv,
                     BanditValueBackend, SearchRequest, False,
                     executor="reference", device="cpu", metrics=True)
    want = jax_results(False)
    for uid, b in want.items():
        assert got[uid].actions == b.actions, uid
    series = cl.registry.snapshot()["service_reroots_total"]
    assert sum(v for k, v in series.items() if 'path="host"' in k) \
        == sum(len(r.actions) - 1 for r in want.values())


def test_wrapper_refuses_what_the_kernel_does_not_take():
    cfg = cfg_of("pong", 64)
    ex = arena_of(cfg, init_tree_arrays(cfg))
    with pytest.raises(ValueError, match="scratch is for"):
        kreroot.reroot(ex.trees, 0, 0, kreroot.Scratch(32, cfg.Fp, "cpu"))
    sc = kreroot.Scratch(cfg.X, cfg.Fp, "cpu")
    with pytest.raises(IndexError):
        kreroot.reroot(ex.trees, 3, 0, sc)
    with pytest.raises(IndexError):
        kreroot.reroot(ex.trees, 0, cfg.X, sc)
    n = kreroot.launches
    kreroot.reroot(ex.trees, 0, 0, sc)
    kreroot.write(ex.trees, 0, sc)
    assert kreroot.launches == n   # the plain twin launches nothing


def test_sharded_executor_reroots_on_the_owning_shard():
    cfg = cfg_of("pong", 2000)
    tree = grown("pong", *GROWN["pong"][0])
    ex = make_intree_executor(cfg, 4, "faithful", device="cpu", n_shards=2,
                              devices=["cpu", "cpu"])
    ex.set_tree(from_numpy(tree, "cpu"), 3)
    a = int(np.argmax(tree["edge_N"][0]))
    counts, new_root, old2new = ex.reroot_slot(3, a)
    want, want_map = jax_reroot(cfg, tree, new_root)
    assert ex.reroot_path == "device"
    assert_tree_equal(ex.slot_snapshot(3), want, "shard 1")
    np.testing.assert_array_equal(old2new, want_map)
    np.testing.assert_array_equal(ex.root_row(3)[1], want["child"][0])
