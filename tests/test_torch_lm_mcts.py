"""The LM serving slice as a whole on the CPU: the port's
ContinuousBatcher, LMTreeEnv, LMContinuationBackend, the paper's MCTS with
the LM as its simulation, and the serve entry point, against the JAX
package (repro.serving, repro.sim.lm, repro.core.mcts).

Weights are the JAX package's smoke llama3.2-1b, carried across with
from_jax_params.  Tokens and run_step actions are identical; logprobs and
values agree to 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import TreeConfig as JCfg, TreeParallelMCTS as JMCTS
from repro.models import lm as jlm
from repro.serving import ContinuousBatcher as JBatcher, Request as JRequest
from repro.sim import LMContinuationBackend as JBackend, LMTreeEnv as JEnv
from repro_torch import configs as tconfigs
from repro_torch.core import TreeConfig, TreeParallelMCTS
from repro_torch.launch import serve
from repro_torch.models import lm as tlm
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving import ContinuousBatcher, Request
from repro_torch.sim import LMContinuationBackend, LMTreeEnv
from test_serving import greedy_reference


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_config("llama3.2-1b", smoke=True)
    tcfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tlm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _prompts(vocab, n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=3 + i % 4).astype(np.int32)
            for i in range(n)]


def _drive(batcher, request_cls, prompts, late):
    """Submit `prompts`, step 3 times, admit `late` mid-decode, drain."""
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        batcher.submit(r)
    for _ in range(3):
        batcher.step()
    batcher.submit(request_cls(uid=99, prompt=late, max_new_tokens=6))
    return {r.uid: r for r in batcher.run(max_steps=200)}


@pytest.mark.parametrize("pool_size", [1, 2])
def test_batcher_matches_jax(model, pool_size):
    """Mid-decode admission through pools of 1 and 2 slots.  The JAX
    batcher's splice skips a pool of one slot (its ``_splice_slot`` needs
    ``dst.shape[1] > 1``), so its pool-1 decode attends over an empty
    cache; the port is held to the JAX pool-2 stream there, and to
    tests/test_serving.py's greedy_reference."""
    jcfg, tcfg, jp, tp = model
    prompts = _prompts(jcfg.vocab, 3, seed=1)
    late = np.array([4, 7, 11], np.int32)
    reg = MetricsRegistry()
    jd = _drive(JBatcher(jcfg, jp, pool_size=max(pool_size, 2), max_seq=64,
                         impl="naive", record_logprobs=True),
                JRequest, prompts, late)
    td = _drive(ContinuousBatcher(tcfg, tp, pool_size=pool_size, max_seq=64,
                                  impl="flash", record_logprobs=True,
                                  metrics=reg),
                Request, prompts, late)
    assert sorted(td) == sorted(jd) == [0, 1, 2, 99]
    for uid in jd:
        assert td[uid].tokens == jd[uid].tokens, uid
        np.testing.assert_allclose(td[uid].logprobs, jd[uid].logprobs,
                                   atol=1e-5, rtol=1e-5)
        if pool_size == 1:
            assert td[uid].tokens == greedy_reference(
                jcfg, jp, td[uid].prompt, 6), uid
    assert reg.get("serving_admitted_total").value == 4
    assert reg.get("serving_evictions_total", reason="max_tokens").value == 4


def test_lm_env_top_actions_match_jax(model):
    jcfg, tcfg, jp, tp = model
    je, te = JEnv(jcfg, jp, fanout=6, horizon=5), LMTreeEnv(tcfg, tp, fanout=6, horizon=5)
    s = te.initial_state(3)
    for a in (2, 0, 5):
        np.testing.assert_array_equal(te.top_actions(s), je.top_actions(s))
        s2, r, term = te.step(s, a)
        j2, jr, jterm = je.step(s, a)
        np.testing.assert_array_equal(s2, j2)
        assert (r, term) == (jr, jterm)
        s = s2


def test_lm_backend_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    je, te = JEnv(jcfg, jp, fanout=4, horizon=2), LMTreeEnv(tcfg, tp, fanout=4, horizon=2)
    states = np.stack([te.initial_state(s) for s in range(5)])
    states[2] = te.step(states[2], 1)[0]
    jv, _ = JBackend(je, pool_size=4).evaluate(states)
    backend = LMContinuationBackend(te, pool_size=4)
    tv, _ = backend.evaluate(states)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=1e-5)
    # the batcher drains fully between calls
    np.testing.assert_array_equal(backend.evaluate(states)[0], tv)


TREE = dict(X=64, F=4, D=4)


def _port_mcts(tcfg, tp, executor):
    env = LMTreeEnv(tcfg, tp, fanout=4, horizon=2)
    return TreeParallelMCTS(TreeConfig(**TREE), env,
                            LMContinuationBackend(env, pool_size=4), p=4,
                            executor=executor, expansion="loop", device="cpu")


def test_mcts_over_lm_cuda_executor_matches_reference(model):
    """The slice whole: the cuda executor (its kernels' plain versions on
    CPU tensors) against the numpy oracle, bit for bit per superstep."""
    _, tcfg, _, tp = model
    mc, mr = _port_mcts(tcfg, tp, "cuda"), _port_mcts(tcfg, tp, "reference")
    steps = 0
    while mc._size() < TREE["X"] and steps < 40:
        a, b = mc.superstep(), mr.superstep()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{steps}: {k}")
        steps += 1
    sc, sr = mc.exec.snapshot(mc.tree), mr.exec.snapshot(mr.tree)
    for k in sr:
        np.testing.assert_array_equal(sc[k], sr[k], err_msg=k)
    assert steps > 4


def test_mcts_over_lm_run_steps_match_jax(model):
    """Two moves of the paper's MCTS with the LM as simulation: the same
    actions as the JAX package's faithful executor."""
    jcfg, tcfg, jp, tp = model
    jenv = JEnv(jcfg, jp, fanout=4, horizon=2)
    jm = JMCTS(JCfg(**TREE), jenv, JBackend(jenv, pool_size=4), p=4,
               executor="faithful", expansion="loop")
    tm = _port_mcts(tcfg, tp, "cuda")
    for _ in range(2):
        assert tm.run_step() == jm.run_step()
        np.testing.assert_array_equal(tm.root_state, jm.root_state)


def test_serve_main_runs_on_cpu_only_when_asked(monkeypatch):
    argv = ["--arch", "llama3.2-1b", "--smoke", "--batch", "2",
            "--prefill", "9", "--tokens", "3"]
    out = serve.main(argv + ["--device", "cpu"])
    assert out["device"] == "cpu" and out["tokens"].shape == (2, 4)
    assert out["req_per_s"] > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(argv)
