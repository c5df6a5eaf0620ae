"""The port's encoder, cross-attention and VLM prefix (whisper-small,
paligemma-3b) against the JAX package's on the CPU, at SMOKE size.

Frames, patches and tokens are numpy arrays from seeds, handed to both
packages; weights are the JAX package's init_params carried across with
from_jax_params.  Tolerances: 1e-5 per module in f32 (the encoder, the
cross K/V, cross-attention), whole forwards 1e-4 in f32 with identical
argmax and 2e-2 in bf16, prefill plus decode 1e-4; the weight carry is
bit for bit.  A P=32 variant of paligemma's SMOKE holds both packages
together with the JAX launcher's cache size (prompt + new tokens + 8,
which a 32-patch prefix overruns) and with the serve entry point's
(P more): only the second decodes what the teacher-forced forward gives.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import lm as jlm
from repro.models import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.launch import serve
from repro_torch.models import attention as TA
from repro_torch.models import lm as tlm
from repro_torch.models import steps as tsteps

WHISPER, PALIGEMMA = "whisper-small", "paligemma-3b"
ARCHS = (WHISPER, PALIGEMMA)


def cfgs(arch, **kw):
    j, t = jconfigs.get_config(arch, smoke=True), tconfigs.get_config(arch, smoke=True)
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def carried(jcfg, tcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, tlm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def models():
    """arch -> (jax cfg, port cfg, jax params, port params), f32."""
    return {arch: cfgs(arch) + carried(*cfgs(arch)) for arch in ARCHS}


def close(t, j, tol):
    np.testing.assert_allclose(np.asarray(t, np.float32),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def stub_inputs(cfg, B, seed) -> dict:
    """Seeded non-zero frames [B, T, d] (whisper) or patches [B, P, d]
    (paligemma), as numpy."""
    rng = np.random.RandomState(seed)
    out = {}
    if cfg.encoder is not None:
        out["frames"] = rng.randn(B, cfg.encoder.n_frames,
                                  cfg.d_model).astype(np.float32)
    if cfg.vlm_patches:
        out["patches"] = rng.randn(B, cfg.vlm_patches,
                                   cfg.d_model).astype(np.float32)
    return out


def as_jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def as_torch(d):
    return {k: torch.tensor(v) for k, v in d.items()}


def layer_mix(jp, tp, i=0):
    """Row i of the first decoder group's attention params (cross leaves
    included), in each package."""
    return (jax.tree.map(lambda a: a[i], jp["g0"][0]["mix"]),
            tlm._at(tp["g0"][0], i)["mix"])


def back_to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


# ----------------------------------------------------------------- modules

@pytest.mark.parametrize("T", [32, 2100])
def test_encode_matches_jax(models, T):
    """The whisper encoder over seeded frames: T=32 runs naive attention
    in the JAX package, T=2,100 (past 2,048) blockwise; the port's
    naive, blockwise and flash (the plain version here) within 1e-5."""
    jcfg, tcfg, jp, tp = models[WHISPER]
    frames = np.random.RandomState(T).randn(1, T, jcfg.d_model).astype(np.float32)
    want = jlm.encode(jcfg, jp, jnp.asarray(frames))
    for impl in TA.IMPLS:
        got = tlm.encode(tcfg, tp, torch.tensor(frames), impl=impl)
        assert got.shape == (1, T, jcfg.d_model) and got.dtype == torch.float32
        close(got, want, 1e-5)


@pytest.mark.parametrize("Sk", [32, 2100])
def test_cross_kv_and_cross_attention_match_jax(models, Sk):
    """encode_cross_kv, then cross_attn_forward for a 9-token prefill and a
    1-token decode step over Sk encoder positions (naive up to 2,048 keys,
    blockwise past them in the JAX package), every impl, within 1e-5."""
    jcfg, tcfg, jp, tp = models[WHISPER]
    jm, tm = layer_mix(jp, tp, 1)
    rng = np.random.RandomState(Sk)
    enc = rng.randn(2, Sk, jcfg.d_model).astype(np.float32)
    jk, jv = JA.encode_cross_kv(jcfg, jm, jnp.asarray(enc))
    tk, tv = TA.encode_cross_kv(tcfg, tm, torch.tensor(enc))
    assert tk.shape == (2, Sk, jcfg.n_kv_heads, jcfg.head_dim)
    close(tk, jk, 1e-5)
    close(tv, jv, 1e-5)
    for S in (9, 1):
        x = rng.randn(2, S, jcfg.d_model).astype(np.float32)
        want = JA.cross_attn_forward(jcfg, jm, jnp.asarray(x), (jk, jv))
        for impl in TA.IMPLS:
            got = TA.cross_attn_forward(tcfg, tm, torch.tensor(x), (tk, tv), impl)
            assert got.shape == (2, S, jcfg.d_model)
            close(got, want, 1e-5)


# ----------------------------------------------------------------- forward

def impls(arch):
    # paligemma's prefix has no flash route (test_flash_with_a_prefix_raises)
    return ("naive", "blockwise") if arch == PALIGEMMA else TA.IMPLS


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(models, arch):
    """Logits over 2 x 20 tokens with seeded frames / patches (positions
    cover P + S), each impl within 1e-4 with identical argmax; whisper's
    forward given the encoder output (enc_out) equals its forward given
    the frames."""
    jcfg, tcfg, jp, tp = models[arch]
    tok = np.random.RandomState(5).randint(0, jcfg.vocab, (2, 20)).astype(np.int32)
    extra = stub_inputs(jcfg, 2, 6)
    jl = np.asarray(jlm.forward(jcfg, jp, jnp.asarray(tok), impl="naive",
                                **as_jax(extra))[0])
    assert jl.shape == (2, 20 + jcfg.vlm_patches, jcfg.padded_vocab)
    for impl in impls(arch):
        tl = tlm.forward(tcfg, tp, torch.tensor(tok), impl=impl,
                         **as_torch(extra))[0].numpy()
        close(tl, jl, 1e-4)
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    if arch == WHISPER:
        enc = tlm.encode(tcfg, tp, torch.tensor(extra["frames"]))
        via_enc = tlm.forward(tcfg, tp, torch.tensor(tok), enc_out=enc)[0]
        via_frames = tlm.forward(tcfg, tp, torch.tensor(tok),
                                 frames=torch.tensor(extra["frames"]))[0]
        assert torch.equal(via_enc, via_frames)
        with pytest.raises(ValueError, match="cross-attention needs"):
            tlm.forward(tcfg, tp, torch.tensor(tok))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_bf16_match_jax(arch):
    """The published dtype (bf16 weights and activations): each impl
    within 2e-2 of the JAX package's naive forward."""
    jcfg, tcfg = cfgs(arch, dtype="bfloat16")
    jp, tp = carried(jcfg, tcfg, 1)
    tok = np.random.RandomState(7).randint(0, jcfg.vocab, (2, 20)).astype(np.int32)
    extra = stub_inputs(jcfg, 2, 8)
    jl = np.asarray(jlm.forward(jcfg, jp, jnp.asarray(tok), impl="naive",
                                **as_jax(extra))[0])
    for impl in impls(arch):
        tl = tlm.forward(tcfg, tp, torch.tensor(tok), impl=impl,
                         **as_torch(extra))[0].numpy()
        assert tl.shape == jl.shape
        close(tl, jl, 2e-2)


# (arch, vlm_patches override or None, cache size): whisper; paligemma's
# SMOKE (P=8) at the serve size; a P=32 variant at the JAX launcher's
# size (prompt + new + 8, overrun by the prefix) and at the serve size
DECODE_CASES = [(WHISPER, None, "serve"), (PALIGEMMA, None, "serve"),
                (PALIGEMMA, 32, "launcher"), (PALIGEMMA, 32, "serve")]


@pytest.mark.parametrize("arch,P,size", DECODE_CASES,
                         ids=[f"{a}-P{p}-{s}" for a, p, s in DECODE_CASES])
def test_prefill_then_decode_matches_jax(arch, P, size):
    """A 16-token prefill (with frames / patches) then 4 teacher-forced
    decode steps in both packages at the same max_seq: the prefill's
    logits and every step's within 1e-4, the cross K/V the prefill
    stored within 1e-5.  Against the teacher-forced forward, the serve
    size decodes the same rows (1e-4); the launcher size with P=32 has
    overwritten the patch keys, so its rows move by more than 1e-2."""
    kw = {} if P is None else {"vlm_patches": P}
    jcfg, tcfg = cfgs(arch, **kw)
    jp, tp = carried(jcfg, tcfg, 2)
    S, n = 16, 4
    seq = np.random.RandomState(9).randint(0, jcfg.vocab, (2, S + n)).astype(np.int32)
    extra = stub_inputs(jcfg, 2, 10)
    max_seq = (S + n + 8 if size == "launcher"
               else serve.cache_len(tcfg, S, n))
    jc = jlm.init_caches(jcfg, 2, max_seq)
    tc = tlm.init_caches(tcfg, 2, max_seq, "cpu")
    jlg, jc = jsteps.make_prefill_step(jcfg, impl="naive")(
        jp, jnp.asarray(seq[:, :S]), jc, **as_jax(extra))
    tlg, tc = tsteps.make_prefill_step(tcfg, impl="blockwise")(
        tp, torch.tensor(seq[:, :S]), tc, **as_torch(extra))
    if arch == WHISPER:
        close(tc["g0"][0]["xk"], jc["g0"][0]["xk"], 1e-5)
        close(tc["g0"][0]["xv"], jc["g0"][0]["xv"], 1e-5)
    got, want = [tlg], [jlg]
    jdec = jsteps.make_decode_step(jcfg, impl="naive")
    tdec = tsteps.make_decode_step(tcfg, impl="blockwise")
    for i in range(S, S + n):
        jlg, jc = jdec(jp, jc, jnp.asarray(seq[:, i:i + 1]), jnp.asarray(i))
        tlg, tc = tdec(tp, tc, torch.tensor(seq[:, i:i + 1]), torch.tensor(i))
        got.append(tlg)
        want.append(jlg)
    got = torch.stack(got, 1).numpy()
    close(got, np.stack([np.asarray(w) for w in want], 1), 1e-4)
    fwd = tlm.forward(tcfg, tp, torch.tensor(seq), **as_torch(extra))[0].numpy()
    rows = fwd[:, tcfg.vlm_patches + S - 1:tcfg.vlm_patches + S + n]
    if size == "serve":
        close(got, rows, 1e-4)
    else:
        assert np.abs(got[:, 0] - rows[:, 0]).max() < 1e-4   # the prefill
        assert np.abs(got[:, 1:] - rows[:, 1:]).max() > 1e-2


# ------------------------------------------------------------ weight carry

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_params_carries_encoder_and_cross_leaves_bit_for_bit(arch, dtype):
    """The whole tree (whisper's encoder subtree and each decoder layer's
    xq/xk/xv/xo/xnorm) leaf for leaf and bit for bit; the port's own
    init builds the same paths, shapes and dtypes."""
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
    assert any("'encoder'" in n for n in names) == (arch == WHISPER)
    assert any("'xnorm'" in n for n in names) == (arch == WHISPER)
    own = tlm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
                        for p, x in jax.tree_util.tree_leaves_with_path(t)]
    assert shapes(jax.tree.map(back_to_numpy, own, is_leaf=lambda x: isinstance(
        x, torch.Tensor))) == shapes(tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_jax(arch):
    """Cache leaves, shapes and dtypes as the JAX package's (whisper's
    [B, n_frames, Hkv, dh] cross K/V beside each layer's k/v)."""
    jcfg, tcfg = cfgs(arch)
    jc = jax.tree.map(np.asarray, jlm.init_caches(jcfg, 3, 40))
    tc = jax.tree.map(lambda t: t.numpy(), tlm.init_caches(tcfg, 3, 40, "cpu"),
                      is_leaf=lambda x: isinstance(x, torch.Tensor))
    shapes = lambda t: [(jax.tree_util.keystr(p), x.shape, x.dtype)
                        for p, x in jax.tree_util.tree_leaves_with_path(t)]
    assert shapes(tc) == shapes(jc)
    assert any("'xk'" in k for k, _, _ in shapes(tc)) == (arch == WHISPER)


# ------------------------------------------------------------------- serve

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_runs_on_cpu(arch, monkeypatch):
    """The serve entry point at SMOKE size on the CPU with the JAX
    launcher's stub inputs (zeros) and with seeded ones passed in: the
    route it names (flash for whisper, blockwise for the prefix), the
    tokens' shape and range, the same tokens again from the same seed;
    without a card and without device="cpu" it raises."""
    cfg = tconfigs.get_config(arch, smoke=True)
    out = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                      "--prefill", "12", "--tokens", "4", "--device", "cpu"])
    assert out["device"] == "cpu" and out["peak_bytes"] is None
    assert out["prefill_impl"] == ("blockwise" if arch == PALIGEMMA else "flash")
    assert out["tokens"].shape == (2, 5)
    assert out["tokens"].min() >= 0 and out["tokens"].max() < cfg.padded_vocab
    extra = as_torch(stub_inputs(cfg, 2, 11))
    a = serve.serve(cfg, batch=2, prefill=12, tokens=4, device="cpu", **extra)
    b = serve.serve(cfg, batch=2, prefill=12, tokens=4, device="cpu", **extra)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", arch, "--smoke"])


def test_flash_with_a_prefix_raises(models):
    """Neither flash kernel has a prefix mask: impl="flash" on paligemma
    raises, and serve routes prefixes (and MLA) to blockwise."""
    jcfg, tcfg, jp, tp = models[PALIGEMMA]
    extra = as_torch(stub_inputs(tcfg, 1, 12))
    with pytest.raises(NotImplementedError, match="no prefix mask"):
        tlm.forward(tcfg, tp, torch.zeros((1, 4), dtype=torch.long),
                    impl="flash", **extra)
    routes = {arch: serve.prefill_impl(tconfigs.get_config(arch))
              for arch in ARCHS + ("llama3.2-1b", "deepseek-v3-671b")}
    assert routes == {WHISPER: "flash", PALIGEMMA: "blockwise",
                      "llama3.2-1b": "flash", "deepseek-v3-671b": "blockwise"}
