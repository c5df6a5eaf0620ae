"""Port vs JAX package: the fused K-superstep dispatch (repro_torch.core.fused)
and the env/sim device twins it runs, bit for bit, on the CPU.

  * the twins: hash24_device against the numpy _hash_batch and JAX's
    hash24_device over 4,096 24-bit hashes x the action codes of
    tests/test_fused_dispatch.py; step_device / num_actions_device
    against step_batch (fixed and varying fanout) and evaluate_device
    against evaluate, bitwise, and against JAX's twins;
  * the fused program against JAX's repro.core.fused.run_supersteps
    ("faithful") from identical arenas, ST images, masks and budgets,
    K in {1, 4, 16} x an input that runs all K, a budget that forces the
    commit escape, a tree that fills its arena (commit), and an env
    whose resolvable_device forces the expand escape: n, the escape,
    size_pre, sizes, every arena field of the active slots, the ST rows
    the pool reads, and on expand the SelectionResult and new node ids;
  * run == collect(submit) on the executor; the device finalize against
    the host one; a predicated superstep after the stop is a no-op;
  * the JAX package's own tests/test_fused_dispatch.py bodies on the
    port (tests/port_cases.py, with its jax.jit shim), but the two that
    check the JAX program lowers as one XLA program: the port's
    counterpart of that claim is the CUDA graph, held on the card
    (tests/test_torch_cuda.py::test_fused_graph_matches_eager_body).
"""

import numpy as np
import pytest
import torch

import port_cases
from repro.core import TreeConfig as JCfg
from repro.core import fused as jfused
from repro.core.tree import init_arena as j_init_arena
from repro.envs import BanditTreeEnv as JEnv, BanditValueBackend as JValue
from repro.envs import device as jdevice
from repro_torch.core import TreeConfig, fused, intree
from repro_torch.core.executor import CudaExecutor, TorchExecutor
from repro_torch.core.tree import FIELDS, NULL, from_numpy, init_arena, to_numpy
from repro_torch.envs import BanditTreeEnv, BanditValueBackend
from repro_torch.envs.bandit_tree import _hash_batch
from repro_torch.envs.device import (
    has_device_env, has_device_sim, hash24_device, resolvable_device,
)

ACTIONS = (0, 1, 5, 999, 4242, 7777, 12345)   # test_fused_dispatch.py


# -- the device twins ---------------------------------------------------------

def test_hash24_device_matches_numpy_and_jax():
    h = np.random.RandomState(7).randint(0, 1 << 24, size=4096).astype(np.int64)
    for a in ACTIONS:
        want = _hash_batch(h, a)
        got = hash24_device(torch.from_numpy(h), a).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"a={a}")
        np.testing.assert_array_equal(
            got, np.asarray(jdevice.hash24_device(h, np.int64(a))))
    codes = np.random.RandomState(8).randint(0, 36, size=4096)
    np.testing.assert_array_equal(
        hash24_device(torch.from_numpy(h), torch.from_numpy(codes)).numpy(),
        _hash_batch(h, codes))


@pytest.mark.parametrize("varying", [False, True],
                         ids=["fixed-fanout", "varying-fanout"])
def test_step_device_matches_step_batch_and_jax(varying):
    env = BanditTreeEnv(fanout=6, terminal_depth=5, varying_fanout=varying)
    jenv = JEnv(fanout=6, terminal_depth=5, varying_fanout=varying)
    rng = np.random.RandomState(3)
    states = np.stack([env.initial_state(s) for s in range(96)])
    for _ in range(6):   # walk to (past) the terminal depth
        na = env.num_actions_batch(states)
        live = na > 0
        a = np.where(live, rng.randint(0, np.maximum(na, 1)), 0)
        want_s, _, want_t = env.step_batch(states[live], a[live])
        got_s, got_t = env.step_device(torch.from_numpy(states),
                                       torch.from_numpy(a))
        np.testing.assert_array_equal(got_s.numpy()[live], want_s)
        np.testing.assert_array_equal(got_t.numpy()[live], want_t)
        np.testing.assert_array_equal(
            env.num_actions_device(got_s).numpy()[live],
            env.num_actions_batch(want_s))
        j_s, j_t = jenv.step_device(states, a)
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(j_s))
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(j_t))
        states = got_s.numpy().copy()
        states[~live] = 0   # parked rows: keep the walk total


def test_evaluate_device_matches_host_and_jax_bitwise():
    env, sim = BanditTreeEnv(fanout=4, terminal_depth=8), BanditValueBackend()
    states = np.stack([env.initial_state(s) for s in range(2048)])
    want, _ = sim.evaluate(states)
    got = sim.evaluate_device(torch.from_numpy(states)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    jgot = np.asarray(JValue().evaluate_device(states))
    np.testing.assert_array_equal(got.view(np.int32), jgot.view(np.int32))


def test_probes_and_escape_names():
    env, sim = BanditTreeEnv(fanout=4), BanditValueBackend()
    assert has_device_env(env) and has_device_sim(sim)
    assert not has_device_env(object()) and not has_device_sim(object())
    ok = resolvable_device(env, torch.zeros((3, 8)), torch.zeros(3, dtype=torch.int32))
    assert ok.dtype == torch.bool and bool(ok.all())
    assert fused.ESCAPE_NAMES == jfused.ESCAPE_NAMES
    assert (fused.ESC_RAN_K, fused.ESC_COMMIT, fused.ESC_EXPAND) == (
        jfused.ESC_RAN_K, jfused.ESC_COMMIT, jfused.ESC_EXPAND)


# -- the fused program against JAX's ------------------------------------------

class _PartialEnv(BanditTreeEnv):
    """tests/test_executor_matrix.py's _PartialDeviceEnv: the twin refuses
    transitions from depth >= 2 leaves (the expand escape)."""

    def resolvable_device(self, states, actions):
        return states[..., 0] < 2


class _JPartialEnv(JEnv):
    def resolvable_device(self, states, actions):
        return states[..., 0] < 2


CASES = {   # name: (tree config, budgets, partial env)
    "all-k": (dict(X=96, F=4, D=6), [100, 100, 100], False),
    "budget-commit": (dict(X=96, F=4, D=6), [3, 100, 9], False),
    "arena-full": (dict(X=24, F=4, D=6), [100, 100, 100], False),
    "expand": (dict(X=96, F=4, D=6), [100, 100, 100], True),
}
ACTIVE = np.array([True, False, True])
P = 4


def grown(cfg: dict, seed: int):
    """A numpy arena of 3 slots grown a few supersteps with the port's
    faithful fused program (identical on both sides by the test), and
    its ST image."""
    env = BanditTreeEnv(fanout=4, terminal_depth=10)
    arena = init_arena(TreeConfig(**cfg), 3, root_num_actions=4, device="cpu")
    states = np.zeros((3, cfg["X"], 8), np.float32)
    for r in range(3):
        states[r, 0] = env.initial_state(seed + r)
    _, d = fused.run_supersteps(TreeConfig(**cfg), "faithful", arena,
                                np.ones(3, bool), P, 2, env,
                                BanditValueBackend(), states,
                                np.full(3, 100, np.int32), False)
    for r in range(3):
        lo, rows = d.written(r)
        states[r, lo: lo + len(rows)] = rows
    return to_numpy(arena), states


def assert_dispatch_matches_jax(cfg, arrays, states, budgets, partial, K,
                                variant="faithful", executor_cls=None):
    env = (_PartialEnv if partial else BanditTreeEnv)(fanout=4, terminal_depth=10)
    jenv = (_JPartialEnv if partial else JEnv)(fanout=4, terminal_depth=10)
    jt = j_init_arena(JCfg(**cfg), 3)
    jt = type(jt)(**{k: np.asarray(arrays[k]).astype(np.asarray(getattr(jt, k)).dtype)
                     for k in FIELDS})
    budgets = np.asarray(budgets, np.int32)
    jt2, jd = jfused.run_supersteps(JCfg(**cfg), "faithful", jt, ACTIVE, P, K,
                                    jenv, JValue(), states, budgets, False)
    tt = from_numpy(arrays, "cpu")
    if executor_cls is None:
        _, td = fused.run_supersteps(TreeConfig(**cfg), variant, tt, ACTIVE, P,
                                     K, env, BanditValueBackend(), states,
                                     budgets, False)
    else:
        ex = executor_cls(TreeConfig(**cfg), 3, device="cpu", _trees=tt)
        td = ex.run_supersteps(ACTIVE, P, K, env, BanditValueBackend(),
                               states, budgets, False)
    assert (td.n, td.escape) == (int(jd.n), jd.escape)
    np.testing.assert_array_equal(td.size_pre, np.asarray(jd.size_pre))
    np.testing.assert_array_equal(td.sizes, np.asarray(jd.sizes))
    got = to_numpy(tt)
    for k in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(got[k])[ACTIVE],
            np.asarray(getattr(jt2, k))[ACTIVE].astype(got[k].dtype),
            err_msg=k)
    for r in np.flatnonzero(ACTIVE):
        lo, rows = td.written(r)
        assert lo == arrays["size"][r]
        end = int(jd.size_pre[r] if jd.escape == "expand" else jd.sizes[r])
        np.testing.assert_array_equal(rows, np.asarray(jd.states)[r, lo:end])
    if jd.escape == "expand":
        for k, v in jd.sel_host.items():
            np.testing.assert_array_equal(td.sel_host[k][ACTIVE],
                                          np.asarray(v)[ACTIVE], err_msg=k)
        np.testing.assert_array_equal(td.new_nodes[ACTIVE],
                                      np.asarray(jd.new_nodes)[ACTIVE])
    return td


@pytest.mark.parametrize("K", [1, 4, 16])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_program_matches_jax(case, K):
    """Acceptance: from the same arena, ST image, mask and budgets, the
    port's fused dispatch is the JAX program's, on every escape."""
    cfg, budgets, partial = CASES[case]
    arrays, states = grown(cfg, seed=K)
    d = assert_dispatch_matches_jax(cfg, arrays, states, budgets, partial, K)
    if K == 16:   # each case really reaches its escape
        want = {"all-k": "ran_k", "budget-commit": "commit",
                "arena-full": "commit", "expand": "expand"}[case]
        assert d.escape == want and (d.n == 16) == (want == "ran_k")


@pytest.mark.parametrize("executor_cls", [TorchExecutor, CudaExecutor],
                         ids=["faithful", "cuda"])
@pytest.mark.parametrize("case", ["budget-commit", "expand"])
def test_executor_run_supersteps_matches_jax(case, executor_cls):
    """The executors' run_supersteps (the cuda executor on a CPU arena
    runs the kernels' plain versions, eagerly) give the JAX program's
    dispatch."""
    cfg, budgets, partial = CASES[case]
    arrays, states = grown(cfg, seed=5)
    assert_dispatch_matches_jax(cfg, arrays, states, budgets, partial, 8,
                                executor_cls=executor_cls)


@pytest.mark.parametrize("case", list(CASES))
def test_run_equals_collect_of_submit(case):
    cfg, budgets, partial = CASES[case]
    arrays, states = grown(cfg, seed=2)
    env = (_PartialEnv if partial else BanditTreeEnv)(fanout=4, terminal_depth=10)
    sim = BanditValueBackend()
    args = (ACTIVE, P, 8, env, sim, states, np.asarray(budgets, np.int32), False)
    a = TorchExecutor(TreeConfig(**cfg), 3, device="cpu",
                      _trees=from_numpy(arrays, "cpu"))
    b = TorchExecutor(TreeConfig(**cfg), 3, device="cpu",
                      _trees=from_numpy(arrays, "cpu"))
    da = a.run_supersteps(*args)
    db = b.run_supersteps_collect(b.run_supersteps_submit(*args))
    for k in ("n", "escape", "replays"):
        assert getattr(da, k) == getattr(db, k)
    for k in ("size_pre", "sizes", "states_lo", "states"):
        np.testing.assert_array_equal(getattr(da, k), getattr(db, k))
    ta, tb = to_numpy(a.trees), to_numpy(b.trees)
    for k in FIELDS:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
    # the executor caches its (gang 0) program, and a second dispatch
    # reuses it
    prog = a._fused[0]
    a.run_supersteps(*args)
    assert a._fused == {0: prog}
    a.release()
    assert a._fused == {} and a.trees is None


def test_device_finalize_matches_host_finalize():
    cfg = TreeConfig(X=64, F=4, D=6)
    rng = np.random.RandomState(11)
    G, Kw = 3, 5
    arrays = to_numpy(init_arena(cfg, G, device="cpu"))
    arrays["num_actions"][:] = rng.randint(0, 5, arrays["num_actions"].shape)
    arrays["terminal"][:] = rng.randint(0, 2, arrays["terminal"].shape)
    nodes = np.full((G, Kw), NULL, np.int32)
    for g in range(G):
        k = rng.randint(0, Kw + 1)
        nodes[g, :k] = rng.choice(np.arange(1, cfg.X), k, replace=False)
    na = np.where(nodes != NULL, rng.randint(0, 5, nodes.shape), 0).astype(np.int32)
    term = np.where(nodes != NULL, rng.randint(0, 2, nodes.shape), 0).astype(np.int32)
    host, dev = from_numpy(arrays, "cpu"), from_numpy(arrays, "cpu")
    intree.finalize_arena(host, nodes, na, term)
    intree.finalize_arena_device(dev, torch.from_numpy(nodes),
                                 torch.from_numpy(na), torch.from_numpy(term))
    a, b = to_numpy(host), to_numpy(dev)
    for k in FIELDS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("variant", ["faithful", "relaxed", "wavefront"])
def test_superstep_after_stop_is_bit_frozen(variant):
    """Predication: once `stop` is set a superstep changes no arena
    field, no ST row and no carry buffer (the graph replays past a stop
    rely on it)."""
    cfg, _, partial = CASES["expand"]
    arrays, states = grown(cfg, seed=4)
    tt = from_numpy(arrays, "cpu")
    prog = fused.FusedProgram(TreeConfig(**cfg), variant, tt, P,
                              _PartialEnv(fanout=4, terminal_depth=10),
                              BanditValueBackend(), False)
    pend = prog.submit(ACTIVE, 8, states, np.full(3, 100, np.int32))
    d = prog.collect(pend)
    assert d.escape == "expand" and bool(prog.stop)
    before = to_numpy(tt)
    carry = {k: getattr(prog, k).clone() for k in ("n", "esc", "size_pre",
                                                   "budget", "new_nodes")}
    sel = prog.sel.map(torch.clone)
    st = prog.states[:, :cfg["X"]].clone()
    for _ in range(3):
        prog.superstep()
    after = to_numpy(tt)
    for k in FIELDS:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    for k, v in carry.items():
        assert torch.equal(getattr(prog, k), v), k
    for k in intree.SEL_FIELDS:
        assert torch.equal(getattr(prog.sel, k), getattr(sel, k)), k
    assert torch.equal(prog.states[:, :cfg["X"]], st)


def test_one_dispatch_in_flight_per_program():
    cfg, budgets, _ = CASES["all-k"]
    arrays, states = grown(cfg, seed=1)
    prog = fused.FusedProgram(TreeConfig(**cfg), "faithful",
                              from_numpy(arrays, "cpu"), P,
                              BanditTreeEnv(fanout=4, terminal_depth=10),
                              BanditValueBackend(), False)
    pend = prog.submit(ACTIVE, 2, states, np.asarray(budgets, np.int32))
    with pytest.raises(RuntimeError, match="in flight"):
        prog.submit(ACTIVE, 2, states, np.asarray(budgets, np.int32))
    prog.collect(pend)
    prog.collect(prog.submit(ACTIVE, 2, states, np.asarray(budgets, np.int32)))


# -- the JAX package's own fused-dispatch tests, run on the port -------------

UNPORTED = {
    "test_fused_program_lowers_single_program_faithful":
        "XLA lowering; the port's one program is the CUDA graph, held on "
        "the card by test_torch_cuda.py::test_fused_graph_matches_eager_body",
    "test_fused_program_lowers_with_interpret_off_pallas":
        "Pallas lowering; replaced by the same card test",
}
JAX_CASES = port_cases.cases("test_fused_dispatch", UNPORTED)


@pytest.mark.parametrize("fn,kwargs", [c[1:] for c in JAX_CASES],
                         ids=[c[0] for c in JAX_CASES])
def test_jax_fused_case_on_port(fn, kwargs, request):
    """One test of tests/test_fused_dispatch.py, its own body run
    against repro_torch (port_cases, with jax.jit / jnp shimmed to the
    port's torch twins)."""
    port_cases.run_case(fn, kwargs, request)
