"""Port vs JAX package: the paper's Gomoku benchmark (b), on the CPU.

  * GomokuEnv (repro_torch.envs.gomoku) against repro.envs.GomokuEnv on
    seeded random sweeps, terminal rows included: step, step_batch and
    num_actions_batch equal exactly; the rollout backend's values too;
  * PolicyValueNet with the JAX package's weights (carried by
    params_from_numpy) against repro.envs.policy_net.apply at C=8 and
    C=32, values and logits within 1e-5 (float32 nets of about 1e-6
    agreement; the two packages sum the convolutions in other orders);
    NNSimBackend.evaluate against JAX's: terminal values exactly, priors
    within 1e-5 in the identical legal-order layout;
  * a row's result does not depend on its batch (B in {1, 16, 256} and a
    permutation, bit for bit), and two dispatches in flight finalize to
    their own rows;
  * the slice as a whole: JAX's TreeParallelMCTS(faithful) at Gomoku
    shape (X=384, F=36, D=5, p=8, C=8, expand-all, PUCT, alternating
    signs) records every simulation batch; the port's driver on `cuda`
    (the kernel wrappers' plain versions on the CPU) and on `faithful`
    replays the recorded values and priors: every requested batch of
    states, every selection and the final tree must be identical, and
    the port's own net must be within 1e-5 of every recorded row.  The
    packages' nets agree only to about 1e-6, which can move a value's
    Qm.16 code, so the whole-slice comparison replays JAX's numbers;
    within the port, `cuda` against `reference` on the port's own net
    must be identical;
  * the JAX package's own tests/test_vector_env.py and the Gomoku and
    driver legs of tests/test_mcts_system.py, run on the port through
    tests/port_cases.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import port_cases
from repro.configs import gomoku_cfg as jgomoku_cfg, pong as jpong
from repro.core import TreeConfig as JCfg, TreeParallelMCTS as JMCTS
from repro.envs import GomokuEnv as JGomoku
from repro.envs import policy_net as jpn
from repro.envs.gomoku import GomokuRolloutBackend as JRollout
from repro_torch.configs import gomoku_cfg, pong
from repro_torch.core import TreeConfig, TreeParallelMCTS
from repro_torch.envs import GomokuEnv, GomokuRolloutBackend
from repro_torch.envs import policy_net as tpn

TOL = 1e-5
GOMOKU = dict(X=384, F=36, D=5, beta=5.0, score_fn="puct",
              leaf_mode="unexpanded", expand_all=True)
P, C = 8, 8


def gomoku_states(n, seed, max_plies=36):
    """n Gomoku states from random playouts (terminal rows kept)."""
    env = GomokuEnv()
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        s = env.initial_state(0)
        for _ in range(int(rng.integers(0, max_plies + 1))):
            k = env.num_actions(s)
            if k == 0:
                break
            s, _, _ = env.step(s, int(rng.integers(k)))
        out.append(s)
    return np.stack(out)


def jax_params(channels: int) -> dict:
    return jpn.init_params(jax.random.PRNGKey(0), channels)


def port_params(channels: int) -> dict:
    return tpn.params_from_numpy({k: np.asarray(v) for k, v in
                                  jax_params(channels).items()})


# ------------------------------------------------------------ configs, env

@pytest.mark.parametrize("name", ["TREE", "TREE_SMALL"])
def test_configs_match_jax(name):
    for port_mod, jax_mod in ((gomoku_cfg, jgomoku_cfg), (pong, jpong)):
        assert (dataclasses.asdict(getattr(port_mod, name))
                == dataclasses.asdict(getattr(jax_mod, name)))
    assert isinstance(gomoku_cfg.TREE, TreeConfig)
    assert (gomoku_cfg.TREE.X, gomoku_cfg.TREE.F, gomoku_cfg.TREE.D) == (
        48_000, 36, 5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_env_matches_jax(seed):
    """step, step_batch and num_actions_batch on a sweep of reachable
    states (terminal ones among them), exactly."""
    tenv, jenv = GomokuEnv(), JGomoku()
    states = gomoku_states(96, seed, max_plies=40)
    term = states[:, 1] != 0
    assert term.any() and (~term).any()
    np.testing.assert_array_equal(tenv.num_actions_batch(states),
                                  jenv.num_actions_batch(states))
    live = states[~term]
    rng = np.random.RandomState(seed)
    actions = np.array([rng.randint(tenv.num_actions(s)) for s in live])
    for a, b in zip(tenv.step_batch(live, actions),
                    jenv.step_batch(live, actions)):
        np.testing.assert_array_equal(a, b)
    for s, a in zip(live, actions):
        ts, tr, tt = tenv.step(s, int(a))
        js, jr, jt = jenv.step(s, int(a))
        np.testing.assert_array_equal(ts, js)
        assert (tr, tt) == (jr, jt)
        assert tenv.num_actions(ts) == jenv.num_actions(js)
    assert GomokuEnv.state_shape == (108,) and GomokuEnv.max_actions == 36


def test_rollout_backend_matches_jax():
    states = gomoku_states(24, 5)
    tv, tp = GomokuRolloutBackend(GomokuEnv(), seed=3).evaluate(states)
    jv, jp = JRollout(JGomoku(), seed=3).evaluate(states)
    np.testing.assert_array_equal(tv, jv)
    assert tp is None and jp is None


# ------------------------------------------------------------- the net

@pytest.mark.parametrize("channels", [8, 32])
def test_net_matches_jax_apply(channels):
    states = gomoku_states(128, channels)
    boards = (states[:, 3:39] * states[:, 0:1]).reshape(-1, 6, 6)
    jv, jl = jax.device_get(jpn.apply(jax_params(channels), boards))
    net = tpn.PolicyValueNet(port_params(channels))
    with torch.no_grad():
        tv, tl = net(torch.from_numpy(boards))
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=TOL)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=TOL)


@pytest.mark.parametrize("channels", [8, 32])
def test_backend_evaluate_matches_jax(channels):
    states = gomoku_states(160, 10 + channels)
    term = states[:, 1] != 0
    assert term.any()
    tv, tp = tpn.NNSimBackend(GomokuEnv(), port_params(channels),
                              device="cpu").evaluate(states)
    jv, jp = jpn.NNSimBackend(JGomoku(), jax_params(channels)).evaluate(states)
    np.testing.assert_array_equal(tv[term], jv[term])
    np.testing.assert_allclose(tv, jv, rtol=0, atol=TOL)
    np.testing.assert_array_equal(tp != 0, jp != 0)     # legal-order layout
    np.testing.assert_allclose(tp, jp, rtol=0, atol=TOL)
    assert tp.shape == (len(states), 36) and tp.dtype == np.float32


def test_backend_rows_independent_of_batch():
    be = tpn.NNSimBackend(GomokuEnv(), port_params(32), device="cpu")
    states = gomoku_states(256, 21)
    vals, pris = be.evaluate(states)
    for B in (1, 16, 256):
        v, p = be.evaluate(states[:B])
        np.testing.assert_array_equal(v, vals[:B])
        np.testing.assert_array_equal(p, pris[:B])
    perm = np.random.default_rng(0).permutation(len(states))
    v, p = be.evaluate(states[perm])
    np.testing.assert_array_equal(v, vals[perm])
    np.testing.assert_array_equal(p, pris[perm])


def test_dispatches_in_flight_finalize_their_own_rows():
    be = tpn.NNSimBackend(GomokuEnv(), port_params(8), device="cpu")
    a, b = gomoku_states(10, 31), gomoku_states(70, 32)
    ta, tb = be.dispatch(a), be.dispatch(b)
    vb, pb = be.finalize(tb, b)
    va, pa = be.finalize(ta, a)
    for (v, p), s in (((va, pa), a), ((vb, pb), b)):
        ev, ep = be.evaluate(s)
        np.testing.assert_array_equal(v, ev)
        np.testing.assert_array_equal(p, ep)


def test_init_params_shapes_and_scale():
    params = tpn.init_params(torch.Generator().manual_seed(0), channels=32)
    want = {k: tuple(v.shape) for k, v in port_params(32).items()}
    assert {k: tuple(v.shape) for k, v in params.items()} == want
    # He-normal: std sqrt(2 / fan_in) (val_w1's fan_in is 32 * 36)
    std = float(params["val_w1"].std())
    assert abs(std - np.sqrt(2.0 / (32 * 36))) < 0.1 * std


def test_backend_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpn.NNSimBackend(GomokuEnv(), port_params(8))


# ------------------------------------------------ the slice as a whole

class Recording:
    """JAX's NNSimBackend, logging every batch and its results."""

    def __init__(self, inner):
        self.inner, self.log = inner, []

    def evaluate(self, states):
        v, p = self.inner.evaluate(states)
        self.log.append((np.array(states), np.array(v), np.array(p)))
        return v, p


class Replay:
    """Hands the port's driver JAX's recorded values and priors, after
    checking that it asks for the recorded states and that the port's
    own net gives the same numbers within TOL."""

    def __init__(self, log, own):
        self.log, self.own, self.n = log, own, 0

    def evaluate(self, states):
        s, v, p = self.log[self.n]
        self.n += 1
        np.testing.assert_array_equal(states, s, err_msg=f"batch {self.n}")
        ov, op = self.own.evaluate(states)
        np.testing.assert_allclose(ov, v, rtol=0, atol=TOL)
        np.testing.assert_allclose(op, p, rtol=0, atol=TOL)
        return v.copy(), p.copy()


def fill(m, cap=40) -> list:
    """Supersteps until the tree holds X nodes (or stops growing)."""
    sels = []
    while m._size() < m.cfg.X and len(sels) < cap:
        size = m._size()
        sels.append(m.superstep())
        if m._size() == size:
            break
    return sels


_JAX_RUN: dict = {}


def jax_run() -> dict:
    if not _JAX_RUN:
        rec = Recording(jpn.NNSimBackend(JGomoku(), jax_params(C)))
        jm = JMCTS(JCfg(**GOMOKU), JGomoku(), rec, p=P, executor="faithful",
                   alternating_signs=True, expansion="vector")
        sels = fill(jm)
        _JAX_RUN.update(sels=sels, log=rec.log, action=jm.exec.best_action(jm.tree),
                        snap={k: np.asarray(v) for k, v in
                              jm.exec.snapshot(jm.tree).items()})
    return _JAX_RUN


def assert_same_run(sels_a, snap_a, sels_b, snap_b, label):
    assert len(sels_a) == len(sels_b), label
    for step, (a, b) in enumerate(zip(sels_a, sels_b)):
        for k in b:
            np.testing.assert_array_equal(
                np.asarray(a[k]), np.asarray(b[k]),
                err_msg=f"{label}: superstep {step}: {k}")
    for k in snap_b:
        np.testing.assert_array_equal(
            snap_a[k], np.asarray(snap_b[k]).astype(snap_a[k].dtype),
            err_msg=f"{label}: final tree {k}")


@pytest.mark.parametrize("executor", ["cuda", "faithful"])
def test_slice_replays_jax_faithful(executor):
    want = jax_run()
    assert int(want["snap"]["size"]) >= GOMOKU["X"] - GOMOKU["F"]
    replay = Replay(want["log"], tpn.NNSimBackend(GomokuEnv(), port_params(C),
                                                  device="cpu"))
    tm = TreeParallelMCTS(TreeConfig(**GOMOKU), GomokuEnv(), replay, p=P,
                          executor=executor, alternating_signs=True,
                          expansion="vector", device="cpu")
    sels = fill(tm)
    assert replay.n == len(want["log"])
    snap = tm.exec.snapshot(tm.tree)
    assert_same_run(sels, snap, want["sels"], want["snap"], executor)
    assert tm.exec.best_action(tm.tree) == want["action"]
    assert snap["edge_P"].any()                      # priors landed
    assert (snap["edge_VL"] == 0).all() and (snap["node_O"] == 0).all()


def test_cuda_matches_reference_on_port_net():
    """Within the port, on the port's own net (weights from a torch
    Generator): the cuda executor's run equals the numpy oracle's, every
    selection and the final tree, then one re-rooting run_step."""
    params = tpn.init_params(torch.Generator().manual_seed(1), channels=C)
    runs = {}
    for ex in ("cuda", "reference"):
        m = TreeParallelMCTS(
            TreeConfig(**GOMOKU), GomokuEnv(),
            tpn.NNSimBackend(GomokuEnv(), params, device="cpu"), p=P,
            executor=ex, alternating_signs=True, expansion="vector",
            device="cpu")
        sels = fill(m)
        runs[ex] = (sels, m.exec.snapshot(m.tree), m.run_step(max_supersteps=4))
    (sa, na, ra), (sb, nb, rb) = runs["cuda"], runs["reference"]
    assert_same_run(sa, na, sb, nb, "cuda vs reference")
    assert ra == rb


# ---------------------------------- the JAX package's own bodies on the port

UNPORTED_MCTS = {
    "test_mcts_beats_random_on_pong": "a Pong leg of about 20 s on the CPU; "
                                      "the Pong driver is held to JAX's by "
                                      "tests/test_torch_mcts.py",
}
CASES = (port_cases.cases("test_vector_env", {})
         + port_cases.cases("test_mcts_system", UNPORTED_MCTS))


@pytest.mark.parametrize("fn,kwargs", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_jax_env_case_on_port(fn, kwargs, request):
    """One test of tests/test_vector_env.py or tests/test_mcts_system.py,
    its own body run against repro_torch."""
    port_cases.run_case(fn, kwargs, request)
