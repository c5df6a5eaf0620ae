"""The slice as a whole: the port's TreeParallelMCTS against the JAX
package's, on the CPU.

The port's `reference` (numpy oracle), `faithful` (plain torch ops) and
`cuda` (the kernel wrappers, which run their plain versions on CPU
tensors) executors are paired with the JAX package's `reference` and
`faithful` executors (not `pallas`: ROADMAP.md queue C); the port's
beyond-paper `relaxed` and `wavefront` with the JAX package's.  Every
superstep's selection, the final tree, run_step actions across a
re-rooting step and a run under a straggler fault injector must be
identical.  Integers compare exactly.
"""

import numpy as np
import pytest
import torch

import port_cases

from repro.core import TreeConfig as JCfg, TreeParallelMCTS as JMCTS
from repro.core import RolloutBackend as JRollout
from repro.envs import BanditTreeEnv as JBandit, BanditValueBackend as JValue
from repro.envs import PongLiteEnv as JPong
from repro_torch.core import (
    RolloutBackend, TreeConfig, TreeParallelMCTS, make_executor,
)
from repro_torch.envs import BanditTreeEnv, BanditValueBackend, PongLiteEnv

CFG = dict(X=256, F=6, D=9)
P = 8
PAIRS = [("reference", "reference"), ("faithful", "faithful"),
         ("cuda", "faithful"), ("cuda", "reference"),
         ("relaxed", "relaxed"), ("wavefront", "wavefront")]


def _systems(port_ex, jax_ex, cfg=CFG, p=P, env="bandit"):
    if env == "bandit":
        jenv, tenv = JBandit(fanout=6, terminal_depth=12), BanditTreeEnv(fanout=6, terminal_depth=12)
        jsim, tsim = JValue(), BanditValueBackend()
    else:
        jenv, tenv = JPong(), PongLiteEnv()
        jsim, tsim = JRollout(jenv, max_steps=20, seed=3), RolloutBackend(tenv, max_steps=20, seed=3)
    jm = JMCTS(JCfg(**cfg), jenv, jsim, p=p, executor=jax_ex, expansion="vector")
    tm = TreeParallelMCTS(TreeConfig(**cfg), tenv, tsim, p=p, executor=port_ex,
                          expansion="vector", device="cpu")
    return jm, tm


def _assert_same_tree(jm, tm):
    a, b = jm.exec.snapshot(jm.tree), tm.exec.snapshot(tm.tree)
    for k in a:
        np.testing.assert_array_equal(b[k], np.asarray(a[k]).astype(b[k].dtype),
                                      err_msg=k)


def _assert_same_sel(ja, tb, step):
    for k in ja:
        np.testing.assert_array_equal(tb[k], np.asarray(ja[k]),
                                      err_msg=f"superstep {step}: {k}")


@pytest.mark.parametrize("port_ex,jax_ex", PAIRS)
def test_supersteps_match_jax(port_ex, jax_ex):
    jm, tm = _systems(port_ex, jax_ex)
    for step in range(40):
        _assert_same_sel(jm.superstep(), tm.superstep(), step)
    _assert_same_tree(jm, tm)
    assert int(tm.exec.sizes()[0]) == int(np.asarray(jm.tree.size))


@pytest.mark.parametrize("port_ex,jax_ex", [("reference", "reference"),
                                            ("faithful", "faithful"),
                                            ("cuda", "faithful")])
def test_run_steps_match_jax(port_ex, jax_ex):
    """Three MCTS steps (the second re-roots the tree where the executor
    supports it, exactly as the JAX package does)."""
    jm, tm = _systems(port_ex, jax_ex, cfg=dict(X=128, F=6, D=9))
    for reuse in (False, True, False):
        ja = jm.run_step(reuse_subtree=reuse)
        ta = tm.run_step(reuse_subtree=reuse)
        assert ta == ja
        _assert_same_tree(jm, tm)
        np.testing.assert_array_equal(tm.st.valid, jm.st.valid)


@pytest.mark.parametrize("port_ex,jax_ex", [("faithful", "faithful"),
                                            ("cuda", "faithful"),
                                            ("cuda", "reference")])
def test_fault_injector_matches_jax(port_ex, jax_ex):
    jm, tm = _systems(port_ex, jax_ex)
    jr, tr = np.random.RandomState(9), np.random.RandomState(9)
    for step in range(25):
        ja = jm.superstep(fault_injector=lambda p: jr.rand(p) > 0.3)
        tb = tm.superstep(fault_injector=lambda p: tr.rand(p) > 0.3)
        _assert_same_sel(ja, tb, step)
    _assert_same_tree(jm, tm)
    snap = tm.exec.snapshot(tm.tree)
    assert (snap["edge_VL"] == 0).all() and (snap["node_O"] == 0).all()


@pytest.mark.parametrize("expansion", ["loop", "pool"])
def test_expansion_modes_match_jax(expansion):
    """The port's loop and process-pool expansion engines against the JAX
    package's vector engine (all modes are bit-identical there)."""
    jm, _ = _systems("cuda", "faithful", cfg=dict(X=96, F=6, D=9))
    tm = TreeParallelMCTS(TreeConfig(X=96, F=6, D=9), BanditTreeEnv(fanout=6, terminal_depth=12),
                          BanditValueBackend(), p=P, expansion=expansion,
                          device="cpu")
    try:
        for step in range(12):
            _assert_same_sel(jm.superstep(), tm.superstep(), step)
        _assert_same_tree(jm, tm)
        np.testing.assert_array_equal(tm.st.data, jm.st.data)
    finally:
        tm.close()


def test_ponglite_rollout_matches_jax():
    jm, tm = _systems("cuda", "faithful", cfg=dict(X=128, F=6, D=9), p=4,
                      env="pong")
    for step in range(20):
        _assert_same_sel(jm.superstep(), tm.superstep(), step)
    _assert_same_tree(jm, tm)
    np.testing.assert_array_equal(tm.st.data, jm.st.data)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        TreeParallelMCTS(TreeConfig(**CFG), BanditTreeEnv(), BanditValueBackend(), p=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TreeParallelMCTS(TreeConfig(**CFG), BanditTreeEnv(), BanditValueBackend(),
                         p=2, executor="faithful")


def test_unported_executor_names_raise():
    """The port has every executor of the JAX package but `pallas`, whose
    place its `cuda` executor takes; an unknown name raises, naming the
    port's executors."""
    with pytest.raises(NotImplementedError, match="cuda"):
        TreeParallelMCTS(TreeConfig(**CFG), BanditTreeEnv(), BanditValueBackend(),
                         p=2, executor="pallas", device="cpu")
    with pytest.raises(NotImplementedError, match="wavefront"):
        make_executor(TreeConfig(**CFG), "pallas", device="cpu")
    for name in ("faithful", "relaxed", "wavefront"):
        assert make_executor(TreeConfig(**CFG), name, device="cpu").G == 1


# ------------------------- the JAX package's main-path suites on the port

UNPORTED: dict = {}
CASES = [c for m in ("test_reroot", "test_equivalence", "test_fixedpoint")
         for c in port_cases.cases(m, UNPORTED)]


@pytest.mark.parametrize("fn,kwargs", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_jax_main_path_case_on_port(fn, kwargs, request):
    """One test of tests/test_reroot.py, test_equivalence.py (the paper's
    claim: the system equals the sequential oracle bit for bit) or
    test_fixedpoint.py, its own body run against repro_torch
    (port_cases)."""
    port_cases.run_case(fn, kwargs, request)
