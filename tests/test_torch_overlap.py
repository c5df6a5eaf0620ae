"""Port vs JAX package: sharded pools and pipelined gangs, bit for bit.

  * PoolVectorEnv's fused ``step_and_count_batch`` and its non-blocking
    ``submit_batch`` / ``collect`` split on BanditTreeEnv and
    PongLiteEnv, against repro.envs.PoolVectorEnv on the same seeded
    batches (two spawned workers each; the workers never touch CUDA);
  * ExpansionEngine.expand_submit / expand_collect in loop, vector and
    pool modes against the JAX engine, and against the port's own
    expand();
  * ShardedExecutor at D in {1, 2, 4} (every shard on the CPU) against
    repro.core.sharded: masked supersteps, then a compacted one on a
    session over per-shard sub-arenas;
  * a SearchClient stream at overlap=True, n_gangs in {2, 3}, K in {1, 4}
    and D in {1, 2} against the JAX client on the same stream (a
    deadline eviction included, whose tick depends on the gang
    schedule);
  * two gangs' fused dispatches in flight on one executor, each on its
    own FusedProgram, against the same dispatches one after the other.

Everything runs on the CPU.
"""

import numpy as np
import pytest

from repro.core import TreeConfig as JCfg
from repro.core import fixedpoint as jfx
from repro.core.expand import ExpansionEngine as JEngine
from repro.core.sharded import make_sharded_executor as j_make_sharded
from repro.core.state_table import StateTable as JTable
from repro.envs import BanditTreeEnv as JEnv, BanditValueBackend as JValue
from repro.envs import PongLiteEnv as JPong, PoolVectorEnv as JPool
from repro.service import SearchClient as JClient, SearchRequest as JRequest
from repro_torch.core import TreeConfig
from repro_torch.core import fixedpoint as fx
from repro_torch.core.executor import TorchExecutor
from repro_torch.core.expand import ExpansionEngine
from repro_torch.core.sharded import ShardedExecutor, make_sharded_executor
from repro_torch.core.state_table import StateTable
from repro_torch.core.tree import from_numpy, init_arena, to_numpy
from repro_torch.envs import (
    BanditTreeEnv, BanditValueBackend, PongLiteEnv, PoolVectorEnv,
    has_async_step, has_fused_step,
)
from repro_torch.launch.mesh import serving_devices
from repro_torch.service import SearchClient, SearchRequest
from test_executor_matrix import _SCHEDULE
from test_torch_service import assert_results_identical

CFG = dict(X=160, F=4, D=6)
G, P = 4, 4


def walk_batch(env, rng, n):
    """n reachable non-terminal states (random legal walks) and a legal
    action for each."""
    states, actions = [], []
    while len(states) < n:
        s = env.initial_state(int(rng.randint(100)))
        for _ in range(int(rng.randint(8))):
            k = env.num_actions(s)
            if k == 0:
                break
            s, _, _ = env.step(s, int(rng.randint(k)))
        k = env.num_actions(s)
        if k:
            states.append(s)
            actions.append(int(rng.randint(k)))
    return np.stack(states), np.asarray(actions, np.int64)


@pytest.mark.parametrize("name", ["bandit", "ponglite"])
def test_pool_vector_env_async_matches_jax(name):
    """submit_batch + collect, the fused step_and_count_batch and the
    two-call form agree with the JAX PoolVectorEnv on the same batch,
    each one batch_calls round trip; a one-row batch steps inline; the
    spawned workers never initialise CUDA."""
    make = {"bandit": (lambda: BanditTreeEnv(fanout=5, terminal_depth=6),
                       lambda: JEnv(fanout=5, terminal_depth=6)),
            "ponglite": (lambda: PongLiteEnv(max_t=24),
                         lambda: JPong(max_t=24))}[name]
    states, actions = walk_batch(make[0](), np.random.RandomState(3), 37)
    with PoolVectorEnv(make[0](), workers=2) as pv, \
            JPool(make[1](), workers=2) as jp:
        assert has_async_step(pv) and has_fused_step(pv)
        want = jp.step_and_count_batch(states, actions)
        pend = pv.submit_batch(states, actions)
        assert pend.futures is not None and len(pend.futures) == 2
        got = pv.collect(pend)
        fused = pv.step_and_count_batch(states, actions)
        nxt, rew, term = pv.step_batch(states, actions)
        na = pv.num_actions_batch(nxt)
        for g, w, f, two in zip(got, want, fused, (nxt, rew, term, na)):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(f, w)
            np.testing.assert_array_equal(two, w)
        assert pv.batch_calls == 4      # submit, fused, step, count
        inline = pv.submit_batch(states[:1], actions[:1])
        assert inline.futures is None
        for g, w in zip(pv.collect(inline),
                        jp.step_and_count_batch(states[:1], actions[:1])):
            np.testing.assert_array_equal(g, w)
        workers = pv.probe_workers()
    assert len(workers) == 2 and not any(workers.values())


def _expand_inputs(pkg, rng):
    """Three slots' (g, StateTable, selection dict, [p, Fp] new ids):
    seeded leaves with states, some workers expanding, some not."""
    env = pkg["env"](fanout=4, terminal_depth=10)
    out = []
    for g in range(3):
        st = pkg["table"](64, env.state_shape, env.state_dtype)
        st.flush(env.initial_state(g))
        s = env.initial_state(g)
        for nid in range(1, 5):
            s, _, _ = env.step(s, nid % 4)
            st.write(np.array([nid]), s[None])
        leaves = rng.randint(0, 5, P).astype(np.int32)
        ea = np.where(rng.rand(P) < 0.7, rng.randint(0, 4, P), -1)
        sel = {"leaves": leaves, "expand_action": ea.astype(np.int32),
               "n_insert": (ea >= 0).astype(np.int32)}
        new = np.full((P, 4), -1, np.int32)
        new[:, 0] = np.where(ea >= 0, 5 + np.cumsum(ea >= 0) - 1, -1)
        out.append((g, st, sel, new))
    return env, out


PORT = {"env": BanditTreeEnv, "table": StateTable, "engine": ExpansionEngine}
JAX = {"env": JEnv, "table": JTable, "engine": JEngine}


@pytest.mark.parametrize("mode", ["loop", "vector", "pool"])
def test_expand_submit_collect_matches_jax(mode):
    """expand_collect(expand_submit(slots)) gives the JAX engine's
    HostExpansions and ST writes, and the port's own expand()'s."""
    results = []
    for pkg, split in ((JAX, True), (PORT, True), (PORT, False)):
        env, slots = _expand_inputs(pkg, np.random.RandomState(5))
        with pkg["engine"](env, mode, pool_workers=2) as eng:
            if split:
                out = eng.expand_collect(eng.expand_submit(slots))
            else:
                out = eng.expand(slots)
        results.append((out, [st.data.copy() for _, st, _, _ in slots]))
    (want, want_st), *ports = results
    for out, sts in ports:
        assert sorted(out) == sorted(want)
        for g, w in want.items():
            h = out[g]
            np.testing.assert_array_equal(h.sim_nodes, w.sim_nodes)
            np.testing.assert_array_equal(h.sim_states, w.sim_states)
            for k in ("fin_nodes", "fin_na", "fin_term", "prior_parents",
                      "prior_workers"):
                assert [int(x) for x in getattr(h, k)] == \
                    [int(x) for x in getattr(w, k)], k
        for a, b in zip(sts, want_st):
            np.testing.assert_array_equal(a, b)


def _superstep(ex, active, rows, act_idx, sts, engine, sim, encode, p=P):
    """One BSP superstep through an executor, as service.pool runs it:
    Selection, Insertion, host expansion, Simulation, finalize, BackUp."""
    sel_dev = ex.selection(active, p)
    sel = ex.sel_to_host(sel_dev)
    new = ex.insert(active, sel_dev)
    hx = engine.expand([(g, sts[g], {k: v[r] for k, v in sel.items()},
                         new[r]) for r, g in zip(rows, act_idx)])
    values, _ = sim.evaluate(np.concatenate([hx[g].sim_states
                                             for g in act_idx]))
    vals_fx = np.asarray(encode(np.asarray(values)), np.int32).reshape(-1, p)
    Ge, Kw = ex.G, p
    fin = [np.full((Ge, Kw), -1, np.int32), np.zeros((Ge, Kw), np.int32),
           np.zeros((Ge, Kw), np.int32), np.full((Ge, p), -1, np.int32),
           np.zeros((Ge, p, 4), np.int32)]
    sim_nodes = np.zeros((Ge, p), np.int32)
    vals = np.zeros((Ge, p), np.int32)
    for i, (r, g) in enumerate(zip(rows, act_idx)):
        for a, b in zip(fin, hx[g].padded_finalize_args(Kw, p, 4, None)):
            a[r] = b
        sim_nodes[r] = hx[g].sim_nodes
        vals[r] = vals_fx[i]
    ex.finalize(*fin)
    ex.backup(active, sel_dev, sim_nodes, vals, False)


def run_sharded(pkg: str, D: int) -> dict:
    """Five masked supersteps of a D-sharded G=4 executor (slot 2 idle),
    then two on a compaction session over slots {0, 3}; returns every
    slot's snapshot, the sizes and the best actions."""
    jax = pkg == "jax"
    env = (JEnv if jax else BanditTreeEnv)(fanout=4, terminal_depth=10)
    sim = (JValue if jax else BanditValueBackend)()
    table = JTable if jax else StateTable
    if jax:
        ex = j_make_sharded(JCfg(**CFG), G, "faithful", D)
    else:
        ex = make_sharded_executor(TreeConfig(**CFG), G, "faithful", D,
                                   device="cpu")
        assert isinstance(ex, ShardedExecutor) and ex.n_shards == D
    engine = (JEngine if jax else ExpansionEngine)(env, "vector")
    encode = jfx.encode if jax else fx.encode
    sts = []
    for g in range(G):
        s0 = env.initial_state(7 + g)
        ex.reset_slot(g, env.num_actions(s0))
        st = table(CFG["X"], env.state_shape, env.state_dtype)
        st.flush(s0)
        sts.append(st)
    active = np.array([True, True, False, True])
    act_idx = np.flatnonzero(active)
    for _ in range(5):
        _superstep(ex, active, act_idx, act_idx, sts, engine, sim, encode)
    ses = ex.open_session(np.array([0, 3]), 2)
    for _ in range(2):
        ses.mark_superstep()
        _superstep(ses.sub, np.ones(2, bool), np.arange(2), np.array([0, 3]),
                   sts, engine, sim, encode)
    ses.close()
    return {"snap": [ex.slot_snapshot(g) for g in range(G)],
            "sizes": np.asarray(ex.sizes()),
            "best": np.asarray(ex.best_actions())}


@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_executor_matches_jax(D):
    """ShardedExecutor over D CPU shards computes every slot as JAX's
    repro.core.sharded does, masked and on per-shard sub-arenas."""
    got, want = run_sharded("port", D), run_sharded("jax", D)
    np.testing.assert_array_equal(got["sizes"], want["sizes"])
    np.testing.assert_array_equal(got["best"], want["best"])
    for g in range(G):
        for k, v in want["snap"][g].items():
            np.testing.assert_array_equal(
                got["snap"][g][k], np.asarray(v).astype(got["snap"][g][k].dtype),
                err_msg=f"slot {g} field {k}")


def test_serving_devices_wrap_and_stay_on_the_cpu():
    assert serving_devices(3, "cpu") == [serving_devices(1, "cpu")[0]] * 3
    assert str(serving_devices(2, "cpu")[1]) == "cpu"


_JAX_STREAMS: dict = {}


def run_client(port: bool, n_gangs: int, K: int, D: int):
    """The executor matrix's schedule (plus one request whose deadline
    falls mid-search) through an overlap-mode SearchClient; returns
    ({uid: SearchResult}, the pool)."""
    if port:
        cl = SearchClient(BanditTreeEnv(fanout=4, terminal_depth=10),
                          BanditValueBackend(), G=G, p=P, executor="cuda",
                          default_cfg=TreeConfig(**CFG), overlap=True,
                          n_gangs=n_gangs, supersteps_per_dispatch=K,
                          n_shards=D, device="cpu")
        req, cfg = SearchRequest, TreeConfig(**CFG)
    else:
        cl = JClient(JEnv(fanout=4, terminal_depth=10), JValue(), G=G, p=P,
                     executor="faithful", default_cfg=JCfg(**CFG),
                     overlap=True, n_gangs=n_gangs,
                     supersteps_per_dispatch=K, n_shards=D)
        req, cfg = JRequest, JCfg(**CFG)
    try:
        hs = [cl.submit(req(cfg=cfg, **kw)) for kw in _SCHEDULE]
        hs.append(cl.submit(req(uid=99, seed=3, budget=40, moves=2, cfg=cfg),
                            deadline_supersteps=9))
        done = {h.uid: h.result() for h in hs}
        (pool,) = cl.core.pools.values()
        return done, pool
    finally:
        cl.close()


@pytest.mark.parametrize("D", [1, 2], ids=["d1", "d2"])
@pytest.mark.parametrize("K", [1, 4], ids=["k1", "k4"])
@pytest.mark.parametrize("n_gangs", [2, 3], ids=["gangs2", "gangs3"])
def test_overlap_stream_matches_jax(n_gangs, K, D):
    """The overlap-mode client equals the JAX client with the same
    overlap, gang, dispatch and shard settings, request for request
    (the deadline eviction included); nothing stays in flight."""
    key = (n_gangs, K, D)
    if key not in _JAX_STREAMS:
        _JAX_STREAMS[key] = run_client(False, n_gangs, K, D)[0]
    got, pool = run_client(True, n_gangs, K, D)
    want = _JAX_STREAMS[key]
    assert_results_identical(got, want, f"overlap {key}")
    assert got[99].deadline_evicted
    # gangs partition within a shard: at most G // D of them
    assert pool.gangs.n_gangs == min(n_gangs, G // D) and pool.n_shards == D
    assert pool._inflight is None and pool._inflight_fused is None
    if K > 1:
        assert pool.stats.fused_dispatches > 0


def test_two_gangs_fused_dispatches_in_flight():
    """Two gangs' fused dispatches on one arena, each on its own
    FusedProgram, both submitted before either is collected, equal the
    same dispatches run one after the other; a second submit on one
    gang's program while its dispatch is in flight raises."""
    cfg = TreeConfig(**CFG)
    env, sim = BanditTreeEnv(fanout=4, terminal_depth=10), BanditValueBackend()
    arrays = to_numpy(init_arena(cfg, G, root_num_actions=4, device="cpu"))
    states = np.zeros((G, cfg.X, 8), np.float32)
    for g in range(G):
        states[g, 0] = env.initial_state(g)
    gangs = [np.array([True, False, True, False]),
             np.array([False, True, False, True])]
    budgets = np.array([3, 100, 100, 5], np.int32)

    def executor():
        return TorchExecutor(cfg, G, device="cpu",
                             _trees=from_numpy(arrays, "cpu"))

    a, b = executor(), executor()
    pend = [a.run_supersteps_submit(m, P, 8, env, sim, states, budgets,
                                    False, gang=i)
            for i, m in enumerate(gangs)]
    with pytest.raises(RuntimeError, match="in flight"):
        a.run_supersteps_submit(gangs[0], P, 8, env, sim, states, budgets,
                                False, gang=0)
    got = [a.run_supersteps_collect(x) for x in pend]
    assert set(a._fused) == {0, 1} and a._fused[0] is not a._fused[1]
    want = [b.run_supersteps(m, P, 8, env, sim, states, budgets, False)
            for m in gangs]
    for d, w, m in zip(got, want, gangs):
        assert (d.n, d.escape, d.replays) == (w.n, w.escape, w.replays)
        for k in ("size_pre", "sizes", "states_lo"):
            np.testing.assert_array_equal(getattr(d, k), getattr(w, k))
        for r in np.flatnonzero(m):
            np.testing.assert_array_equal(d.written(r)[1], w.written(r)[1])
    ta, tb = to_numpy(a.trees), to_numpy(b.trees)
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
