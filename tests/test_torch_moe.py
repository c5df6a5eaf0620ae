"""The port's MoE layer (repro_torch.models.moe) and the mixtral /
deepseek-v3 models it serves against the JAX package's on the CPU.

The JAX package computes its dispatch inside ``_moe_dense``; its integers
come from its own source lines (``jax_dispatch`` runs the lines from the
top-k to the slots on given probabilities), so both packages route the
same probabilities and every integer must be equal (compared as
``np.int32``), the gates within 1e-7.  Ties in the probabilities and
pairs past capacity are part of the cases.  Whole layers: f32 within
1e-5, bf16 within 2e-2 (tests/test_flash_kernel.py:47's bf16 bound).
Serving, the batcher and MCTS over mixtral at SMOKE size against the
JAX package's tokens, log-probs (1e-4) and actions.
"""

import dataclasses
import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jconfigs
from repro.core import TreeConfig as JCfg, TreeParallelMCTS as JMCTS
from repro.models import lm as jlm
from repro.models import moe as JM
from repro.serving import ContinuousBatcher as JBatcher, Request as JRequest
from repro.sim import LMContinuationBackend as JBackend, LMTreeEnv as JEnv
from repro_torch import configs as tconfigs
from repro_torch.core import TreeConfig, TreeParallelMCTS
from repro_torch.launch import serve
from repro_torch.models import lm as tlm
from repro_torch.models import moe as TM
from repro_torch.serving import ContinuousBatcher, Request
from repro_torch.sim import LMContinuationBackend, LMTreeEnv

MIXTRAL, DEEPSEEK = "mixtral-8x22b", "deepseek-v3-671b"
ARCHS = (MIXTRAL, DEEPSEEK)


def cfgs(arch, **kw):
    j, t = (jconfigs.get_config(arch, smoke=True),
            tconfigs.get_config(arch, smoke=True))
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def close(t, j, tol):
    np.testing.assert_allclose(np.asarray(t, np.float32),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def _dispatch_lines() -> str:
    """The JAX package's dispatch: the lines of ``_moe_dense`` from the
    top-k to the slots."""
    src = inspect.getsource(JM._moe_dense)
    return textwrap.dedent(src[src.index("    gate, eidx = jax.lax.top_k"):
                               src.index("    xe = ")])


DISPATCH_LINES = _dispatch_lines()


def jax_dispatch(probs: np.ndarray, K: int, cf: float) -> dict:
    T, E = probs.shape
    ns = dict(jax=jax, jnp=jnp, np=np, probs=jnp.asarray(probs), T=T, E=E,
              K=K, capacity_factor=cf)
    exec(DISPATCH_LINES, ns)
    return {k: np.asarray(ns[k]) for k in ("gate", "eidx", "order", "slot",
                                            "keep", "C")}


def assert_dispatch_equal(probs: np.ndarray, K: int, cf: float) -> dict:
    want = jax_dispatch(probs, K, cf)
    got = TM.dispatch(torch.tensor(probs), K, cf)
    assert got.C == int(want["C"])
    for name in ("eidx", "order", "slot", "keep"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy().astype(np.int32),
            want[name].astype(np.int32), err_msg=name)
    close(got.gate, want["gate"], 1e-7)
    return want


def probs_of(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(-1, keepdims=True)
    e = np.exp(z.astype(np.float32))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------- dispatch

@settings(max_examples=30, deadline=None)
@given(T=st.integers(1, 96), E=st.integers(2, 16), k=st.integers(1, 8),
       cf=st.sampled_from([0.25, 0.5, 1.0, 1.25, 2.0]),
       levels=st.sampled_from([2, 3, 0]), seed=st.integers(0, 2**31 - 1))
def test_dispatch_matches_jax_property(T, E, k, cf, levels, seed):
    """T tokens, E experts, top-K, any capacity factor; with `levels` > 0
    the logits take only that many values, so most rows hold exact ties
    (the lower expert index must win), and small capacity factors drop
    pairs (the same pairs must drop)."""
    K = min(k, E)
    rng = np.random.RandomState(seed % 2**31)
    logits = (rng.randint(0, levels, (T, E)).astype(np.float32) if levels
              else rng.randn(T, E).astype(np.float32))
    assert_dispatch_equal(probs_of(logits), K, cf)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ties", [False, True])
def test_dispatch_at_published_widths_matches_jax(arch, ties):
    """The published E and K (mixtral 8 / 2, deepseek 256 / 8) at T=512
    with a skewed router: some experts overflow, so pairs drop; with
    ties, the router's columns duplicated in pairs."""
    cfg = jconfigs.get_config(arch)
    E, K = cfg.n_experts, cfg.top_k
    rng = np.random.RandomState(3)
    logits = rng.randn(512, E).astype(np.float32) + np.linspace(0, 2, E,
                                                               dtype=np.float32)
    if ties:
        logits = np.repeat(logits[:, ::2], 2, axis=1)
    want = assert_dispatch_equal(probs_of(logits), K, 1.25)
    assert not want["keep"].all()


@pytest.mark.parametrize("T", [1, 7, 64, 100, 32768])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch, T):
    cfg = jconfigs.get_config(arch)
    E, K = cfg.n_experts, cfg.top_k
    probs = np.full((1, E), 1.0 / E, np.float32)
    ns = dict(np=np, T=T, K=K, E=E, capacity_factor=1.25)
    exec(DISPATCH_LINES[DISPATCH_LINES.index("C = "):
                        DISPATCH_LINES.index("fe = ")], ns)
    assert TM.capacity(T, K, E, 1.25) == ns["C"]
    assert TM.dispatch(torch.tensor(probs), K).C == TM.capacity(1, K, E, 1.25)


# ------------------------------------------------------------------ layer

def moe_params(jcfg, tcfg, seed):
    """One MoE layer of the JAX package's init, carried across."""
    jp = JM.init_moe(jcfg, jax.random.PRNGKey(seed))[0]
    return jp, tlm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_jax(arch, dtype, cf):
    """moe_forward's y and aux against the JAX package's at SMOKE width,
    48 tokens; at capacity factor 0.5 pairs drop."""
    jcfg, tcfg = cfgs(arch, dtype=dtype)
    jp, tp = moe_params(jcfg, tcfg, 1)
    x = np.random.RandomState(4).randn(2, 24, jcfg.d_model).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.tensor(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    jy, jaux = JM.moe_forward(jcfg, jp, jx, capacity_factor=cf)
    ty, taux = TM.moe_forward(tcfg, tp, tx, capacity_factor=cf)
    assert ty.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 2e-2
    close(ty.float(), np.asarray(jy.astype(jnp.float32)), tol)
    close(taux, jaux, 1e-5)
    keep = TM.dispatch(TM.route(tp, tx.reshape(48, -1)), tcfg.top_k, cf).keep
    assert bool(keep.all()) == (cf > 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_equals_per_token_experts(arch):
    """An independent reference: each token's y is the sum over its kept
    pairs of gate * expert_e(x), plus the shared expert (f32, 1e-5); a
    dropped pair adds nothing."""
    _, tcfg = cfgs(arch)
    gen = torch.Generator().manual_seed(2)
    p = TM.init_moe(tcfg, gen)
    x = torch.randn(1, 40, tcfg.d_model, generator=gen)
    y, _ = TM.moe_forward(tcfg, p, x, capacity_factor=0.5)
    xf = x[0]
    dsp = TM.dispatch(TM.route(p, xf), tcfg.top_k, 0.5)
    kept = torch.zeros_like(dsp.keep)
    kept[dsp.order] = dsp.keep
    want = torch.zeros_like(xf)
    for t in range(40):
        for k in range(tcfg.top_k):
            if kept[t * tcfg.top_k + k]:
                e = int(dsp.eidx[t, k])
                h = torch.nn.functional.silu(xf[t] @ p["wg"][e]) * (xf[t] @ p["wi"][e])
                want[t] += dsp.gate[t, k] * (h @ p["wo"][e])
    if tcfg.n_shared_experts:
        s = p["shared"]
        want += (torch.nn.functional.silu(xf @ s["wg"]) * (xf @ s["wi"])) @ s["wo"]
    close(y[0], want, 1e-5)
    assert not bool(kept.all())


def test_router_ties_route_to_the_lower_expert():
    """A router with its columns duplicated in pairs: every score ties
    with its neighbour's, so each token's top 2 is one tied pair, the
    lower expert first, at equal gates; both packages' forwards agree."""
    jcfg, tcfg = cfgs(MIXTRAL)
    jp, tp = moe_params(jcfg, tcfg, 5)
    r = np.repeat(np.asarray(jp["router"])[:, ::2], 2, axis=1)
    jp = dict(jp, router=jnp.asarray(r))
    tp = dict(tp, router=torch.tensor(r))
    x = np.random.RandomState(6).randn(1, 16, jcfg.d_model).astype(np.float32)
    dsp = TM.dispatch(TM.route(tp, torch.tensor(x[0])), tcfg.top_k)
    assert (dsp.eidx[:, 0] % 2 == 0).all()
    assert (dsp.eidx[:, 1] == dsp.eidx[:, 0] + 1).all()
    assert (dsp.gate == 0.5).all()
    jy, _ = JM.moe_forward(jcfg, jp, jnp.asarray(x))
    ty, _ = TM.moe_forward(tcfg, tp, torch.tensor(x))
    close(ty, jy, 1e-5)


# -------------------------------------------------- serving and MCTS over MoE

@pytest.fixture(scope="module")
def models():
    """arch -> (jax cfg, port cfg, jax params, port params), f32."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = cfgs(arch)
        jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        tp = tlm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
        out[arch] = (jcfg, tcfg, jp, tp)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_the_moe_archs(arch, monkeypatch):
    """The serve entry point at SMOKE size on the CPU (a prefill past
    mixtral's 16-token SMOKE window); without a card and without
    device="cpu" it raises."""
    out = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                      "--prefill", "20", "--tokens", "4", "--device", "cpu"])
    cfg = tconfigs.get_config(arch, smoke=True)
    assert out["device"] == "cpu" and out["peak_bytes"] is None
    assert out["tokens"].shape == (2, 5)
    assert out["tokens"].min() >= 0 and out["tokens"].max() < cfg.padded_vocab
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", arch, "--smoke"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_takes_a_depth_cut_config(arch):
    """serve.serve serves a ModelConfig it is given: here the SMOKE config
    cut to one layer (chip_smoke.py serves the published widths at cut
    depth this way); the same tokens as serve.main on that config."""
    cfg = tconfigs.get_config(arch, smoke=True)
    cut = dataclasses.replace(cfg, groups=((cfg.groups[-1][0], 1),))
    out = serve.serve(cut, batch=2, prefill=9, tokens=3, device="cpu")
    assert out["tokens"].shape == (2, 4)
    again = serve.serve(cut, batch=2, prefill=9, tokens=3, device="cpu")
    np.testing.assert_array_equal(out["tokens"], again["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_matches_jax(models, arch):
    """A pool of 2 with five requests (MoE routing over the pool's rows,
    deepseek's latent cache ``c`` per row): the port's batcher against
    the JAX package's, the same tokens, log-probs within 1e-4."""
    jcfg, tcfg, jp, tp = models[arch]
    rng = np.random.RandomState(10)
    prompts = [rng.randint(1, jcfg.vocab, size=2 + 3 * i % 7).astype(np.int32)
               for i in range(5)]
    jb = JBatcher(jcfg, jp, pool_size=2, max_seq=48, impl="naive",
                  record_logprobs=True)
    tb = ContinuousBatcher(tcfg, tp, pool_size=2, max_seq=48, impl="flash",
                           record_logprobs=True)
    for i, p in enumerate(prompts):
        jb.submit(JRequest(uid=i, prompt=p, max_new_tokens=5))
        tb.submit(Request(uid=i, prompt=p, max_new_tokens=5))
    jd = {r.uid: r for r in jb.run(max_steps=200)}
    td = {r.uid: r for r in tb.run(max_steps=200)}
    assert sorted(td) == sorted(jd) == list(range(5))
    for i in range(5):
        assert td[i].tokens == jd[i].tokens, i
        np.testing.assert_allclose(td[i].logprobs, jd[i].logprobs,
                                   atol=1e-4, rtol=1e-4)


def test_mcts_over_mixtral_matches_jax(models):
    """The paper's MCTS with mixtral (SMOKE) as the simulation: top
    actions from MoE forwards past the 16-token window, continuations
    decoded through the batcher: two moves, the same actions and root
    states as the JAX package's faithful executor."""
    jcfg, tcfg, jp, tp = models[MIXTRAL]
    tree = dict(X=64, F=4, D=4)
    jenv = JEnv(jcfg, jp, fanout=4, horizon=2)
    jm = JMCTS(JCfg(**tree), jenv, JBackend(jenv, pool_size=4), p=4,
               executor="faithful", expansion="loop")
    tenv = LMTreeEnv(tcfg, tp, fanout=4, horizon=2)
    tm = TreeParallelMCTS(TreeConfig(**tree), tenv,
                          LMContinuationBackend(tenv, pool_size=4), p=4,
                          executor="cuda", expansion="loop", device="cpu")
    for _ in range(2):
        assert tm.run_step() == jm.run_step()
        np.testing.assert_array_equal(tm.root_state, jm.root_state)
