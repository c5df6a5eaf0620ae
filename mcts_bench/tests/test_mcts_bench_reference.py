"""The plain reference held against the port's CPU path at small sizes:
the environments, the net, and whole searches through SearchClient
(phase path and fused dispatch, re-rooting, expand-all with priors)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]

from mcts_bench.reference import envs as E  # noqa: E402
from mcts_bench.reference import net as N  # noqa: E402
from mcts_bench.reference import search as S  # noqa: E402
from mcts_bench.reference import tree as T  # noqa: E402
from mcts_bench.systems.gomoku_net import make_weights  # noqa: E402
from mcts_bench.traffic.openings import OpeningGomoku  # noqa: E402
from repro_torch.core import TreeConfig  # noqa: E402
from repro_torch.envs import BanditTreeEnv, BanditValueBackend, GomokuEnv  # noqa: E402
from repro_torch.envs.policy_net import NNSimBackend  # noqa: E402
from repro_torch.service import SearchClient, SearchRequest  # noqa: E402

PONG = dict(F=6, D=9, beta=1.0, vl_mode="wu", score_fn="uct",
            leaf_mode="partial", expand_all=False)
GOMOKU = dict(F=36, D=5, beta=5.0, vl_mode="wu", score_fn="puct",
              leaf_mode="unexpanded", expand_all=True)


def test_bandit_matches_the_port():
    rng = np.random.default_rng(0)
    port, ref = BanditTreeEnv(6, 12), E.BanditTree(6, 12)
    for seed in (0, 1, 2 ** 31 + 7):
        a, b = port.initial_state(seed), ref.initial_state(seed)
        for _ in range(12):
            assert np.array_equal(a, b)
            act = int(rng.integers(6))
            (a, ra, ta), (b, rb, tb) = port.step(a, act), ref.step(b, act)
            assert (ra, ta) == (rb, tb)
    states = np.stack([port.initial_state(s) for s in range(50)])
    v, _ = BanditValueBackend().evaluate(states)
    assert np.array_equal(v, E.BanditTree.values(states))
    low = E.BanditTree.values(states, "bfloat16")
    assert not np.array_equal(low, v) and np.abs(low - v).max() < 4e-3


def test_gomoku_rules_match_the_port():
    rng = np.random.default_rng(1)
    port, ref = GomokuEnv(), E.Gomoku()
    for _ in range(40):
        a = b = ref.empty()
        assert np.array_equal(a, port.initial_state(0))
        while ref.num_actions(b):
            assert ref.num_actions(b) == port.num_actions(a)
            act = int(rng.integers(ref.num_actions(b)))
            (a, ra, ta), (b, rb, tb) = port.step(a, act), ref.step(b, act)
            assert np.array_equal(a, b) and (ra, ta) == (rb, tb)
    env = OpeningGomoku()
    env.register(3, [5, 0, 7])
    assert np.array_equal(env.initial_state(3), ref.play([5, 0, 7]))


def playouts(n: int, seed: int) -> np.ndarray:
    """n positions of random legal play, terminal ones among them."""
    env, rng, out = E.Gomoku(), np.random.default_rng(seed), []
    for i in range(n):
        s = env.empty()
        for _ in range(i % 20):
            if not env.num_actions(s):
                break
            s, _, _ = env.step(s, int(rng.integers(env.num_actions(s))))
        out.append(s)
    return np.stack(out)


def test_net_matches_the_port_and_tf32_does_not():
    w = make_weights(32, 11, "cpu")
    states = playouts(80, 2)
    be = NNSimBackend(GomokuEnv(), w, device="cpu")
    pv, pp = be.evaluate(states)
    rv, rp = N.evaluate({k: v.numpy() for k, v in w.items()}, states)
    assert np.abs(pv - rv).max() < 1e-5 and np.abs(pp - rp).max() < 1e-5
    cv, cp = N.evaluate({k: v.numpy() for k, v in w.items()}, states, "tf32")
    assert np.abs(cv - rv).max() > 1e-4


def test_weights_are_he_normal_and_seeded():
    a, b = make_weights(32, 5, "cpu"), make_weights(32, 5, "cpu")
    c = make_weights(32, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["c2"], c["c2"])
    w = a["val_w1"]
    assert abs(float(w.std()) - (2.0 / w.shape[0]) ** 0.5) < 0.05 * (2.0 / w.shape[0]) ** 0.5
    assert float(w.abs().max()) <= 2.0 * (2.0 / w.shape[0]) ** 0.5 / 0.8796 + 1e-6


def test_reroot_matches_the_port():
    from repro_torch.core import reroot

    shape = T.Shape(X=400, **PONG)
    t = T.Tree(shape, 6)
    rng = np.random.default_rng(4)
    for _ in range(12):
        sel = T.selection(shape, t, 4)
        new = T.insert(shape, t, sel)
        sim = np.where(new[:, 0] >= 0, new[:, 0], sel["leaves"])
        for n in new[:, 0][new[:, 0] >= 0]:
            t.num_actions[n] = 6
        T.backup(shape, t, sel, sim.astype(np.int32),
                 T.encode(rng.uniform(-1, 1, 4).astype(np.float32)), False)
    child = int(t.child[0, T.best_action(t)])
    snap = {k: getattr(t, k).copy() for k in T.TREE_KEYS}
    snap.update(size=np.int32(t.size), root=np.int32(0),
                log_table=t.log_table)
    want, want_map = reroot.reroot(TreeConfig(X=400, **PONG), snap, child)
    got_map = T.reroot(t, child)
    assert np.array_equal(got_map, want_map) and t.size == int(want["size"])
    for k in T.TREE_KEYS:
        assert np.array_equal(getattr(t, k), want[k]), k


@pytest.mark.parametrize("K", [1, 8])
def test_pong_searches_match_the_client(K):
    X = 1500
    cfg = TreeConfig(X=X, **PONG)
    reqs = [(1, 30, 3), (2, 12, 6), (3, 40, 1), (4, 9, 12)]
    cl = SearchClient(BanditTreeEnv(6, 12), BanditValueBackend(), G=3, p=16,
                      device="cpu", default_cfg=cfg, expansion="vector",
                      policy="weighted-queue-depth", compact_threshold=0.5,
                      supersteps_per_dispatch=K)
    hs = [cl.submit(SearchRequest(uid=i, seed=s, budget=b, moves=m))
          for i, (s, b, m) in enumerate(reqs)]
    got = [h.result() for h in hs]
    cl.close()
    env = E.BanditTree(6, 12)
    for (s, b, m), r in zip(reqs, got):
        ref = S.run_search(T.Shape(X=X, **PONG), env,
                           lambda st: (E.BanditTree.values(st), None),
                           env.initial_state(s), 16, b, m, m)
        assert [a for a, _ in ref] == r.actions
        assert all(np.array_equal(v, w) for (_, v), w in
                   zip(ref, r.visit_counts))


def test_gomoku_searches_match_the_client():
    X = 1200
    w = make_weights(32, 3, "cpu")
    env = OpeningGomoku()
    openings = {0: [], 1: [3, 5], 2: [0, 1, 2, 3]}
    for k, v in openings.items():
        env.register(k, v)
    cl = SearchClient(env, NNSimBackend(env, w, device="cpu"), G=2, p=8,
                      device="cpu", default_cfg=TreeConfig(X=X, **GOMOKU),
                      alternating_signs=True, expansion="vector")
    reqs = [(0, 6, 3), (1, 9, 2), (2, 5, 4)]
    hs = [cl.submit(SearchRequest(uid=i, seed=s, budget=b, moves=m))
          for i, (s, b, m) in enumerate(reqs)]
    got = [h.result() for h in hs]
    cl.close()
    weights = {k: v.numpy() for k, v in w.items()}
    ref_env = E.Gomoku()
    for (s, b, m), r in zip(reqs, got):
        ref = S.run_search(
            T.Shape(X=X, **GOMOKU), ref_env,
            lambda st: tuple(x.astype(np.float32)
                             for x in N.evaluate(weights, st)),
            ref_env.play(openings[s]), 8, b, m, m, alternating_signs=True)
        assert [a for a, _ in ref] == r.actions
        assert all(np.array_equal(v, x) for (_, v), x in
                   zip(ref, r.visit_counts))
