"""The port's recurrent LM families (repro_torch.models.ssd / rglru and
layers.causal_conv1d) against the JAX package's on the CPU, at SMOKE size.

Inputs are numpy arrays from seeds handed to both packages; weights are
the JAX package's (its init, with every bias-like vector perturbed so the
bias paths count), carried across unchanged.  Tolerances (atol and rtol):
the conv 1e-6 (the same shifted sum in the same order); SSD 1e-5 (the
same chunked algorithm, its einsums contracted in another order); RG-LRU
1e-4 (a chunked linear scan where the JAX package runs an associative
scan: the same products, reassociated); whole SMOKE models 1e-4 in f32
and 2e-2 in bf16 (the flash kernel's bf16 tolerance); decode against the
teacher-forced forward 2e-3 (tests/test_models_smoke.py's bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import TreeConfig as JCfg, TreeParallelMCTS as JMCTS
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models import rglru as JR
from repro.models import ssd as JS
from repro.serving import ContinuousBatcher as JBatcher, Request as JRequest
from repro.sim import LMContinuationBackend as JBackend, LMTreeEnv as JEnv
from repro_torch import configs as tconfigs
from repro_torch.core import TreeConfig, TreeParallelMCTS
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.models import rglru as TR
from repro_torch.models import ssd as TS
from repro_torch.models import steps as tsteps
from repro_torch.serving import ContinuousBatcher, Request
from repro_torch.serving import batcher as tbatcher
from repro_torch.sim import LMContinuationBackend, LMTreeEnv

MAMBA, RGEMMA = "mamba2-2.7b", "recurrentgemma-9b"
SEQS = (1, 7, 33, 300)          # 300 crosses SMOKE's ssd_chunk=32 and the
                                # RG-LRU scan's 64-step chunks


def cfgs(arch, **kw):
    j, t = (jconfigs.get_config(arch, smoke=True),
            tconfigs.get_config(arch, smoke=True))
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def close(t, j, tol):
    np.testing.assert_allclose(np.asarray(t, np.float32),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def to_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.array(a)), tree)


def perturbed(tree, seed):
    """The tree as numpy, each 1-D leaf (biases, A_log, dt_bias, D, lam)
    moved by 0.3 N(0, 1): zero biases would hide their paths."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.3 * rng.randn(*a.shape).astype(np.float32)
                   if a.ndim == 1 else np.asarray(a)), tree)


def mixer_case(kind, S, with_cache, seed):
    """(jax cfg, port cfg, params, u, cache) as numpy for one mixer."""
    jcfg, tcfg = cfgs(MAMBA if kind == "ssd" else RGEMMA)
    key = jax.random.PRNGKey(seed)
    init = JS.init_ssd if kind == "ssd" else JR.init_rglru
    params = perturbed(init(jcfg, key)[0], seed)
    rng = np.random.RandomState(seed)
    u = rng.randn(2, S, jcfg.d_model).astype(np.float32)
    cache = None
    if with_cache:
        c = (JS.init_ssd_cache if kind == "ssd" else JR.init_rglru_cache)(jcfg, 2)
        cache = {k: (0.5 * rng.randn(*v.shape)).astype(np.float32)
                 if v.ndim else np.asarray(5, np.int32) for k, v in c.items()}
    return jcfg, tcfg, params, u, cache


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", SEQS)
def test_causal_conv1d(S, with_state):
    rng = np.random.RandomState(S)
    p = {"w": rng.randn(4, 24).astype(np.float32),
         "b": rng.randn(24).astype(np.float32)}
    x = rng.randn(2, S, 24).astype(np.float32)
    st = rng.randn(2, 3, 24).astype(np.float32) if with_state else None
    jy, js = JL.causal_conv1d(p, jnp.asarray(x),
                              None if st is None else jnp.asarray(st))
    ty, ts = TL.causal_conv1d(to_torch(p), torch.tensor(x),
                              None if st is None else torch.tensor(st))
    close(ty, jy, 1e-6)
    close(ts, js, 1e-6)


def _run_mixer(kind, S, with_cache, seed):
    jcfg, tcfg, params, u, cache = mixer_case(kind, S, with_cache, seed)
    jfwd = JS.ssd_forward if kind == "ssd" else JR.rglru_forward
    tfwd = TS.ssd_forward if kind == "ssd" else TR.rglru_forward
    jy, jc = jfwd(jcfg, params, jnp.asarray(u),
                  None if cache is None else jax.tree.map(jnp.asarray, cache))
    tc = None if cache is None else to_torch(cache)
    ty, tc = tfwd(tcfg, to_torch(params), torch.tensor(u), tc)
    return jy, jc, ty, tc


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("S", SEQS)
def test_ssd_forward_matches_jax(S, with_cache):
    """Chunked prefill (S > 1, and S = 1 without a cache) and the
    recurrent decode step (S = 1 with a cache), the cache's conv context
    and f32 state carried in: output and updated cache within 1e-5."""
    jy, jc, ty, tc = _run_mixer("ssd", S, with_cache, seed=S)
    close(ty, jy, 1e-5)
    if with_cache:
        for k in ("conv", "state", "pos"):
            close(tc[k], jc[k], 1e-5)


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("S", SEQS)
def test_rglru_forward_matches_jax(S, with_cache):
    """The chunked linear scan against the JAX associative scan, and the
    decode step, within 1e-4."""
    jy, jc, ty, tc = _run_mixer("rglru", S, with_cache, seed=100 + S)
    close(ty, jy, 1e-4)
    if with_cache:
        for k in ("conv", "h", "pos"):
            close(tc[k], jc[k], 1e-4)


def test_linear_scan_matches_the_recurrence():
    """linear_scan at several chunk lengths against the step-by-step
    recurrence (f64), including a leftover partial chunk and decays down
    to exp(-10.5) a step, whose products leave f32's range within a few
    chunks."""
    rng = np.random.RandomState(7)
    a = np.exp(-10.5 * rng.rand(2, 150, 8))
    b = rng.randn(2, 150, 8)
    h0 = rng.randn(2, 8)
    h, want = h0, []
    for t in range(150):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    want = np.stack(want, 1)
    for chunk in (1, 8, 64, 150, 400):
        got = TR.linear_scan(torch.tensor(a, dtype=torch.float32),
                             torch.tensor(b, dtype=torch.float32),
                             torch.tensor(h0, dtype=torch.float32), chunk)
        close(got, want, 1e-5)


# ------------------------------------------------------------ whole models

@pytest.fixture(scope="module")
def models():
    """arch -> (jax cfg, port cfg, jax params, port params), f32."""
    out = {}
    for arch in (MAMBA, RGEMMA):
        jcfg, tcfg = cfgs(arch)
        jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        tp = tlm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
        out[arch] = (jcfg, tcfg, jp, tp)
    return out


@pytest.mark.parametrize("arch", [MAMBA, RGEMMA])
def test_forward_logits_match_jax(models, arch):
    """70 tokens: two SSD chunk boundaries, past recurrentgemma's 16-token
    SMOKE window and across one 64-step scan chunk."""
    jcfg, tcfg, jp, tp = models[arch]
    tok = np.random.RandomState(5).randint(0, jcfg.vocab, (2, 70)).astype(np.int32)
    jl = np.asarray(jlm.forward(jcfg, jp, jnp.asarray(tok), impl="naive")[0])
    for impl in ("naive", "blockwise", "flash"):
        tl = tlm.forward(tcfg, tp, torch.tensor(tok), impl=impl)[0].numpy()
        close(tl, jl, 1e-4)
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))


@pytest.mark.parametrize("arch", [MAMBA, RGEMMA])
def test_forward_logits_bf16_match_jax(arch):
    """The published dtype: bf16 weights and activations, f32 state."""
    jcfg, tcfg = cfgs(arch, dtype="bfloat16")
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    tp = tlm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    tok = np.random.RandomState(6).randint(0, jcfg.vocab, (2, 40)).astype(np.int32)
    jl = np.asarray(jlm.forward(jcfg, jp, jnp.asarray(tok), impl="naive")[0])
    tl = tlm.forward(tcfg, tp, torch.tensor(tok), impl="naive")[0].numpy()
    close(tl, jl, 2e-2)


def at_window(tcfg, window):
    """tcfg with its local-attention layers' window set to `window`."""
    groups = tuple((tuple(dataclasses.replace(spec, window=window)
                          if spec.kind == "attn" else spec for spec in pattern),
                    repeats) for pattern, repeats in tcfg.groups)
    return dataclasses.replace(tcfg, groups=groups)


@pytest.mark.parametrize("arch,window", [(MAMBA, None), (RGEMMA, None),
                                         (RGEMMA, 40)])
def test_prefill_then_decode_matches_teacher_forced_forward(models, arch, window):
    """Prefill 40 tokens through the caches (SSD: the chunked scan seeds
    the recurrent state; recurrentgemma: the ring buffer past its 16-token
    SMOKE window, and at a window of exactly the prompt's 40 tokens, the
    edge the published config's 2,048 meets at the serve prefill: decode
    wraps the ring at once), then decode 8 tokens; every row against the
    full forward."""
    _, tcfg, _, tp = models[arch]
    if window is not None:
        tcfg = at_window(tcfg, window)
    tok = torch.tensor(np.random.RandomState(8).randint(
        0, tcfg.vocab, (2, 48)).astype(np.int64))
    full = tlm.forward(tcfg, tp, tok, impl="naive")[0]
    caches = tlm.init_caches(tcfg, 2, 64, "cpu")
    lg, caches = tsteps.make_prefill_step(tcfg, impl="flash")(tp, tok[:, :40], caches)
    close(lg, full[:, 39], 2e-3)
    dec = tsteps.make_decode_step(tcfg, impl="flash")
    for i in range(40, 48):
        lg, caches = dec(tp, caches, tok[:, i:i + 1], torch.tensor(i))
        close(lg, full[:, i], 2e-3)


# ------------------------------------------------------------- slot reuse

def _prompts(vocab, n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=2 + 3 * i % 7).astype(np.int32)
            for i in range(n)]


def _serve(tcfg, tp, prompts, pool_size):
    b = ContinuousBatcher(tcfg, tp, pool_size=pool_size, max_seq=48,
                          impl="flash", record_logprobs=True)
    for i, p in enumerate(prompts):
        b.submit(Request(uid=i, prompt=p, max_new_tokens=5))
    return {r.uid: r for r in b.run(max_steps=200)}


@pytest.mark.parametrize("arch", [MAMBA, RGEMMA])
def test_reused_slot_equals_fresh_batcher(models, arch, monkeypatch):
    """Five requests through two slots, so three start in a slot another
    request left: each gives the tokens and log-probs of a fresh batcher
    that serves it alone.  With the recurrent leaves left as the last
    occupant left them (the clearing patched out), a reused slot's tokens
    change and its log-probs move far beyond the tolerance: the check is
    not vacuous."""
    _, tcfg, _, tp = models[arch]
    prompts = _prompts(tcfg.vocab, 5, seed=9)
    fresh = {i: _serve(tcfg, tp, [p], 2)[0] for i, p in enumerate(prompts)}
    pooled = _serve(tcfg, tp, prompts, 2)
    assert sorted(pooled) == list(range(5))
    for i in range(5):
        assert pooled[i].tokens == fresh[i].tokens, i
        np.testing.assert_allclose(pooled[i].logprobs, fresh[i].logprobs,
                                   atol=1e-4, rtol=1e-4, err_msg=str(i))
    monkeypatch.setattr(tbatcher, "_clear_recurrent", lambda row: None)
    dirty = _serve(tcfg, tp, prompts, 2)
    reused = range(2, 5)
    assert any(dirty[i].tokens != fresh[i].tokens for i in reused)
    moved = [max(abs(x - y) for x, y in zip(dirty[i].logprobs, fresh[i].logprobs))
             for i in reused]
    assert max(moved) > 1e-2, moved


@pytest.mark.parametrize("arch", [MAMBA, RGEMMA])
def test_batcher_matches_jax(models, arch):
    """The port's batcher (in-place prefill into a cleared row) against
    the JAX package's (prefill into a zeroed scratch, then splice), pool
    of 2 with five requests: the same tokens, log-probs within 1e-4."""
    jcfg, tcfg, jp, tp = models[arch]
    prompts = _prompts(jcfg.vocab, 5, seed=10)
    jb = JBatcher(jcfg, jp, pool_size=2, max_seq=48, impl="naive",
                  record_logprobs=True)
    for i, p in enumerate(prompts):
        jb.submit(JRequest(uid=i, prompt=p, max_new_tokens=5))
    jd = {r.uid: r for r in jb.run(max_steps=200)}
    td = _serve(tcfg, tp, prompts, 2)
    for i in range(5):
        assert td[i].tokens == jd[i].tokens, i
        np.testing.assert_allclose(td[i].logprobs, jd[i].logprobs,
                                   atol=1e-4, rtol=1e-4)


# ------------------------------------------------- serve and MCTS over LM

@pytest.mark.parametrize("arch", [MAMBA, RGEMMA])
def test_serve_main_runs_the_recurrent_archs(arch, monkeypatch):
    """The serve entry point at SMOKE size on the CPU: a prefill past
    recurrentgemma's 16-token window, then decode; without a card and
    without device="cpu" it raises."""
    out = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                      "--prefill", "20", "--tokens", "4", "--device", "cpu"])
    cfg = tconfigs.get_config(arch, smoke=True)
    assert out["device"] == "cpu" and out["peak_bytes"] is None
    assert out["tokens"].shape == (2, 5)
    assert out["tokens"].min() >= 0 and out["tokens"].max() < cfg.padded_vocab
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", arch, "--smoke"])


def test_mcts_over_mamba2_matches_jax(models):
    """The paper's MCTS with mamba2 as the simulation (top actions from
    the chunked scan, continuations decoded through the batcher's
    recurrent state): two moves, the same actions and root states as the
    JAX package's faithful executor."""
    jcfg, tcfg, jp, tp = models[MAMBA]
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
