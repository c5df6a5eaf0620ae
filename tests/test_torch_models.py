"""The port's LM (repro_torch.models) against the JAX package's
(repro.models) on the CPU, at smoke size.

Inputs are numpy arrays from seeds, handed to both packages; weights are
the JAX package's init_params carried across with from_jax_params.
Layers agree to 1e-6, attention and the caches to 2e-5, whole forwards to
1e-4 with identical argmax (2e-2 in bf16, the flash kernel's bf16
tolerance), greedy decoding token for token.  granite-3-8b's SMOKE vocab
(515) is padded to 768 (``padded_vocab``).  mixtral-8x22b and
deepseek-v3-671b (MoE, MLA) join the whole-forward checks with their aux
loss, the weight carry (deepseek's MTP head included) and the MTP head's
logits (1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import port_cases
from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.models import steps as tsteps
from test_serving import greedy_reference

# the layer test's three cover every layer variant (granite's are llama's)
LAYER_ARCHS = ("llama3.2-1b", "gemma3-12b", "starcoder2-3b")
DENSE_ARCHS = LAYER_ARCHS + ("granite-3-8b",)
MOE_ARCHS = ("mixtral-8x22b", "deepseek-v3-671b")
ARCHS = DENSE_ARCHS + MOE_ARCHS


def cfgs(arch, **kw):
    j, t = jconfigs.get_config(arch, smoke=True), tconfigs.get_config(arch, smoke=True)
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


@pytest.fixture(scope="module")
def models():
    """arch -> (jax cfg, port cfg, jax params, port params): one JAX
    param tree per arch for the whole module."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = cfgs(arch)
        jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        tp = tlm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
        out[arch] = (jcfg, tcfg, jp, tp)
    return out


def close(t, j, tol):
    np.testing.assert_allclose(np.asarray(t, np.float32),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("arch", LAYER_ARCHS)
def test_norm_mlp_embed_unembed(arch):
    """rmsnorm/layernorm, gated and plain (silu / tanh-gelu) MLPs, the
    (scaled) embedding and the unembedding, with and without softcap."""
    jcfg, tcfg = cfgs(arch, logit_softcap=30.0)
    rng = np.random.RandomState(1)
    d, f = jcfg.d_model, jcfg.d_ff
    x = rng.randn(2, 5, d).astype(np.float32)
    nrm = {"scale": rng.randn(d).astype(np.float32),
           "bias": rng.randn(d).astype(np.float32)}
    if jcfg.norm != "layernorm":
        del nrm["bias"]
    close(TL.norm(tcfg, {k: torch.tensor(v) for k, v in nrm.items()},
                  torch.tensor(x)),
          JL.norm(jcfg, nrm, jnp.asarray(x)), 1e-6)

    mp = {"wi": rng.randn(d, f).astype(np.float32) / 8,
          "wo": rng.randn(f, d).astype(np.float32) / 11}
    if jcfg.gated_mlp:
        mp["wg"] = rng.randn(d, f).astype(np.float32) / 8
    close(TL.mlp(tcfg, {k: torch.tensor(v) for k, v in mp.items()},
                 torch.tensor(x)),
          JL.mlp(jcfg, mp, jnp.asarray(x)), 1e-6)

    emb = {"tok": rng.randn(jcfg.padded_vocab, d).astype(np.float32)}
    tok = rng.randint(0, jcfg.vocab, (2, 5)).astype(np.int32)
    temb = {"tok": torch.tensor(emb["tok"])}
    close(TL.embed(tcfg, temb, torch.tensor(tok)),
          JL.embed(jcfg, emb, jnp.asarray(tok)), 1e-6)
    close(TL.unembed(tcfg, temb, torch.tensor(x)),
          JL.unembed(jcfg, emb, jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope(per_row):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    pos = (rng.randint(0, 5000, (2, 7)) if per_row
           else np.arange(100, 107)).astype(np.int32)
    close(TL.rope(torch.tensor(x), torch.tensor(pos), 500000.0),
          JL.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0), 1e-6)


# --------------------------------------------------------------- attention

def qkv(B, Sq, Sk, H, Hkv, dh, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, dh).astype(np.float32),
            rng.randn(B, Sk, Hkv, dh).astype(np.float32),
            rng.randn(B, Sk, Hkv, dh).astype(np.float32))


@pytest.mark.parametrize("window,prefix", [(None, 0), (96, 0), (None, 32)])
def test_naive_and_blockwise_attention(window, prefix):
    """S=600 spans two 512-blocks, so the blockwise loop's causal and
    window block ranges are exercised."""
    q, k, v = qkv(1, 600, 600, 4, 2, 16)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = JA.naive_attention(jq, jk, jv, causal=True, window=window, prefix=prefix)
    close(TA.naive_attention(tq, tk, tv, causal=True, window=window, prefix=prefix),
          ref, 2e-5)
    close(TA.blockwise_attention(tq, tk, tv, causal=True, window=window, prefix=prefix),
          JA.blockwise_attention(jq, jk, jv, causal=True, window=window, prefix=prefix),
          2e-5)
    # decode-style: non-causal with an offset and a validity mask
    kv_valid = np.random.RandomState(3).rand(1, 600) < 0.8
    close(TA.naive_attention(tq[:, :1], tk, tv, causal=False, q_offset=599,
                             kv_valid=torch.tensor(kv_valid)),
          JA.naive_attention(jq[:, :1], jk, jv, causal=False, q_offset=599,
                             kv_valid=jnp.asarray(kv_valid)), 2e-5)


CACHE_CASES = [  # (window, buf max_seq, positions kind)
    (None, 24, "shared"), (None, 24, "per_row"), (8, 24, "shared"),
    (8, 24, "per_row"),
]


@pytest.mark.parametrize("window,max_seq,kind", CACHE_CASES)
def test_cache_update_and_decode_attend(window, max_seq, kind):
    """A 13-token prefill (longer than the 8-slot ring when windowed), then
    3 decode steps; caches and decode attention against JAX."""
    jcfg, tcfg = cfgs("llama3.2-1b")
    jspec = dataclasses.replace(jcfg.groups[0][0][0], window=window)
    tspec = dataclasses.replace(tcfg.groups[0][0][0], window=window)
    B, Hkv, dh = 3, jcfg.n_kv_heads, jcfg.head_dim
    rng = np.random.RandomState(4)
    jc = JA.init_cache(jcfg, jspec, B, max_seq)
    tc = TA.init_cache(tcfg, tspec, B, max_seq, "cpu")
    pos0 = np.arange(13, dtype=np.int32)
    if kind == "per_row":
        pos0 = pos0[None] + np.array([[0], [2], [5]], np.int32)
    k = rng.randn(B, 13, Hkv, dh).astype(np.float32)
    v = rng.randn(B, 13, Hkv, dh).astype(np.float32)
    jc = JA._cache_update(jcfg, jspec, jc, jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(pos0))
    tc = TA._cache_update(tcfg, tspec, tc, torch.tensor(k), torch.tensor(v),
                          torch.tensor(pos0))
    for name in ("k", "v", "pos"):
        close(tc[name], jc[name], 0)
    for step in range(3):
        cur = (pos0[..., -1:] + 1 + step).astype(np.int32)   # [1] or [B, 1]
        k1 = rng.randn(B, 1, Hkv, dh).astype(np.float32)
        v1 = rng.randn(B, 1, Hkv, dh).astype(np.float32)
        q1 = rng.randn(B, 1, jcfg.n_heads, dh).astype(np.float32)
        jc = JA._cache_update(jcfg, jspec, jc, jnp.asarray(k1), jnp.asarray(v1),
                              jnp.asarray(cur))
        tc = TA._cache_update(tcfg, tspec, tc, torch.tensor(k1), torch.tensor(v1),
                              torch.tensor(cur))
        for name in ("k", "v", "pos"):
            close(tc[name], jc[name], 0)
        close(TA._decode_attend(tcfg, tspec, torch.tensor(q1), tc, torch.tensor(cur)),
              JA._decode_attend(jcfg, jspec, jnp.asarray(q1), jc, jnp.asarray(cur)),
              2e-5)
        close(TA._slot_positions(jc["k"].shape[1], torch.tensor(cur[..., -1])),
              JA._slot_positions(jc["k"].shape[1], jnp.asarray(cur[..., -1])), 0)


# ------------------------------------------------------------------ forward

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits(models, arch):
    """Logits and the MoE layers' summed aux loss (zero for dense archs)."""
    jcfg, tcfg, jp, tp = models[arch]
    tok = np.random.RandomState(5).randint(0, jcfg.vocab, (2, 40)).astype(np.int32)
    jl, _, jaux = jlm.forward(jcfg, jp, jnp.asarray(tok), impl="naive")
    jl = np.asarray(jl)
    for impl in ("naive", "blockwise", "flash"):
        tl, _, taux = tlm.forward(tcfg, tp, torch.tensor(tok), impl=impl)
        close(tl.numpy(), jl, 1e-4)
        np.testing.assert_array_equal(tl.numpy().argmax(-1), jl.argmax(-1))
        close(taux, jaux, 1e-4)
    assert (float(jaux) > 0) == (arch in MOE_ARCHS)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_logits_bf16(arch):
    """The published dtype: bf16 weights and activations.  Not the MoE
    archs: there a bf16 rounding upstream of a router can flip a route
    whose top-k scores nearly tie, which moves that token's row by O(1);
    their bf16 legs are per layer (tests/test_torch_moe.py,
    tests/test_torch_mla.py)."""
    jcfg, tcfg = cfgs(arch, dtype="bfloat16")
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    tp = tlm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    tok = np.random.RandomState(6).randint(0, jcfg.vocab, (2, 40)).astype(np.int32)
    jl = np.asarray(jlm.forward(jcfg, jp, jnp.asarray(tok), impl="naive")[0])
    tl = tlm.forward(tcfg, tp, torch.tensor(tok), impl="naive")[0].numpy()
    assert tl.shape == (2, 40, jcfg.padded_vocab)
    close(tl, jl, 2e-2)


def test_prefill_then_decode_matches_greedy_reference(models):
    """tests/test_serving.py::greedy_reference, 8 tokens, two prompts."""
    jcfg, tcfg, jp, tp = models["llama3.2-1b"]
    pre = tsteps.make_prefill_step(tcfg, impl="flash")
    dec = tsteps.make_decode_step(tcfg, impl="flash")
    rng = np.random.RandomState(6)
    for n in (5, 9):
        prompt = rng.randint(1, jcfg.vocab, n).astype(np.int32)
        caches = tlm.init_caches(tcfg, 1, 64, "cpu")
        lg, caches = pre(tp, torch.tensor(prompt)[None], caches)
        out = [int(torch.argmax(lg[0]))]
        for i in range(7):
            lg, caches = dec(tp, caches, torch.tensor([[out[-1]]]),
                             torch.tensor(n + i))
            out.append(int(torch.argmax(lg[0])))
        assert out == greedy_reference(jcfg, jp, prompt, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_params_round_trips_bit_for_bit(dtype):
    jcfg, tcfg = cfgs("gemma3-12b", dtype=dtype)
    tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(1)))
    tp = tlm.from_jax_params(tcfg, tree, "cpu")

    def back(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(back, tp, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    n_bf16 = 0
    for (path, a), (_, b) in zip(flat_j, flat_t):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        n_bf16 += a.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=str(path))
    assert (n_bf16 > 0) == (dtype == "bfloat16")


def back_to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_from_jax_params_carries_moe_mla_and_mtp_bit_for_bit(arch, dtype):
    """The whole tree: the experts, the router, the shared expert, MLA's
    projections and deepseek's MTP head (proj, its unstacked block and
    norm), leaf for leaf and bit for bit."""
    jcfg, tcfg = cfgs(arch, dtype=dtype)
    tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(1)))
    tp = tlm.from_jax_params(tcfg, tree, "cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    flat_t = jax.tree_util.tree_leaves_with_path(jax.tree.map(
        back_to_numpy, tp, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_j, flat_t):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=str(path))
    names = {jax.tree_util.keystr(p) for p, _ in flat_j}
    assert any("'moe'" in n and "'router'" in n for n in names)
    assert any("'mtp'" in n for n in names) == (arch == "deepseek-v3-671b")
    # the port's own init builds the same tree, shapes and dtypes included
    own = tlm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
                        for p, x in jax.tree_util.tree_leaves_with_path(t)]
    assert shapes(jax.tree.map(back_to_numpy, own, is_leaf=lambda x: isinstance(
        x, torch.Tensor))) == shapes(tree)


def test_mtp_logits_match_jax(models):
    """deepseek-v3's multi-token-prediction head on the trunk's hidden
    states and the next tokens' embeddings, within 1e-5."""
    jcfg, tcfg, jp, tp = models["deepseek-v3-671b"]
    tok = np.random.RandomState(7).randint(0, jcfg.vocab, (2, 17)).astype(np.int32)
    pos = np.arange(16, dtype=np.int32)
    _, _, _, jh = jlm.forward(jcfg, jp, jnp.asarray(tok[:, :16]), impl="naive",
                              return_hidden=True)
    tl, _, _, th = tlm.forward(tcfg, tp, torch.tensor(tok[:, :16]), impl="naive",
                               return_hidden=True)
    close(th, jh, 1e-5)
    jn = JL.embed(jcfg, jp["embed"], jnp.asarray(tok[:, 1:]))
    tn = TL.embed(tcfg, tp["embed"], torch.tensor(tok[:, 1:]))
    want = jlm.mtp_logits(jcfg, jp, jh, jn, jnp.asarray(pos))
    got = tlm.mtp_logits(tcfg, tp, th, tn, torch.tensor(pos))
    assert got.shape == (2, 16, jcfg.padded_vocab)
    close(got, want, 1e-5)


# ------------------------------------- test_models_smoke.py on the port

SMOKE_CASES = port_cases.cases("test_models_smoke", {})


@pytest.mark.parametrize("fn,kwargs", [c[1:] for c in SMOKE_CASES],
                         ids=[c[0] for c in SMOKE_CASES])
def test_jax_models_smoke_case_on_port(fn, kwargs, request):
    """One test of tests/test_models_smoke.py, its own body run against
    repro_torch over the ported archs (port_cases: JAX's weights and
    tokens, the port's prefill, decode, forward and train step)."""
    port_cases.run_case(fn, kwargs, request)
