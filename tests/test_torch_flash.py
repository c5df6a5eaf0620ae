"""The port's flash-attention wrapper (kernels/flash_attention.py) on the
CPU, where it runs its plain version.

Held against the JAX package's naive_attention over the sweep of
tests/test_flash_kernel.py (SHAPES x f32/bf16 x window) at that test's
tolerances (f32 2e-5, bf16 2e-2), and against the Pallas kernel in
interpret mode where this jax can run it.  The wrapper must refuse what
the kernel does not take, and the bf16 kernel's TMA layout check must
accept the LM's layouts and name the stride it refuses.  The CUDA kernel
itself is held against the plain version by tests/test_torch_cuda.py and
chip_smoke.py, on the card.

The bf16 kernel's numerics design is checked here by emulating its
arithmetic in torch: with P split into bf16 hi + lo halves it stays within
one bf16 rounding of the f32 reference (the bound the card's tests hold
the kernel to), while a single bf16 P, the textbook FlashAttention-3 step,
does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import naive_attention as jax_naive
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.ref import flash_attention_plain
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import steps as tsteps
from test_flash_kernel import SHAPES

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def inputs(shape, dtype, seed=0):
    B, Sq, Sk, H, Hkv, dh = shape
    rng = np.random.RandomState(seed)
    arrs = (rng.randn(B, Sq, H, dh), rng.randn(B, Sk, Hkv, dh),
            rng.randn(B, Sk, Hkv, dh))
    tdt, jdt, tol = DTYPES[dtype]
    t = [torch.tensor(a, dtype=torch.float32).to(tdt) for a in arrs]
    j = [jnp.asarray(a, jnp.float32).astype(jdt) for a in arrs]
    return t, j, tol


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32), np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", [None, 64])
def test_wrapper_and_plain_match_jax_naive(shape, dtype, window):
    (tq, tk, tv), (jq, jk, jv), tol = inputs(shape, dtype)
    ref = f32(jax_naive(jq, jk, jv, causal=True, window=window))
    plain = flash_attention_plain(tq, tk, tv, causal=True, window=window)
    out = FA.flash_attention(tq, tk, tv, causal=True, window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(f32(plain), ref, atol=tol, rtol=tol)
    np.testing.assert_allclose(f32(out), ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [None, 64])
def test_plain_matches_pallas_interpret(window):
    from jax.experimental import pallas as pl
    if not hasattr(pl, "load"):
        pytest.skip("the JAX package's Pallas kernels call pl.load, which this "
                    "jax no longer has (ROADMAP.md queue C)")
    from repro.kernels.flash_attention import flash_attention as pallas_flash
    (tq, tk, tv), (jq, jk, jv), tol = inputs(SHAPES[2], "float32")
    ref = f32(pallas_flash(jq, jk, jv, causal=True, window=window,
                           blk_q=64, blk_k=64, interpret=True))
    np.testing.assert_allclose(
        f32(FA.flash_attention(tq, tk, tv, causal=True, window=window)),
        ref, atol=tol, rtol=tol)


def test_non_causal_and_strided_inputs():
    """Non-causal with Sq != Sk, and q/k/v read through a [B,S,H,dh] view
    of a fused projection (strided, head_dim contiguous)."""
    (tq, tk, tv), (jq, jk, jv), tol = inputs((2, 70, 130, 4, 2, 32), "float32")
    ref = f32(jax_naive(jq, jk, jv, causal=False, window=40))
    np.testing.assert_allclose(
        f32(FA.flash_attention(tq, tk, tv, causal=False, window=40)),
        ref, atol=tol, rtol=tol)
    fused = torch.cat([tk, tv], dim=2)           # [B, Sk, 2*Hkv, dh]
    k_view, v_view = fused[:, :, :2], fused[:, :, 2:]
    assert not k_view.is_contiguous()
    np.testing.assert_allclose(
        f32(FA.flash_attention(tq, k_view, v_view, causal=False, window=40)),
        ref, atol=tol, rtol=tol)


BAD = {
    "dtype": (dict(q=(1, 8, 2, 16), kv=(1, 8, 1, 16), dtype=torch.float16), TypeError),
    "mixed_dtype": (dict(q=(1, 8, 2, 16), kv=(1, 8, 1, 16), kv_dtype=torch.bfloat16), TypeError),
    "head_dim": (dict(q=(1, 8, 2, 48), kv=(1, 8, 1, 48)), ValueError),
    "h_not_multiple": (dict(q=(1, 8, 3, 16), kv=(1, 8, 2, 16)), ValueError),
    "causal_sq_ne_sk": (dict(q=(1, 8, 2, 16), kv=(1, 12, 1, 16)), ValueError),
    "rank": (dict(q=(8, 2, 16), kv=(1, 8, 1, 16)), ValueError),
    "window_zero": (dict(q=(1, 8, 2, 16), kv=(1, 8, 1, 16), window=0), ValueError),
    "last_dim_strided": (dict(q=(1, 8, 2, 16), kv=(1, 8, 1, 16), strided=True), ValueError),
}


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_refuses(case):
    kw, err = BAD[case]
    dtype = kw.get("dtype", torch.float32)
    q = torch.zeros(kw["q"], dtype=dtype)
    k = torch.zeros(kw["kv"], dtype=kw.get("kv_dtype", dtype))
    v = k.clone()
    if kw.get("strided"):
        q = torch.zeros(kw["q"][:-1] + (2 * kw["q"][-1],))[..., ::2]
    with pytest.raises(err):
        FA.flash_attention(q, k, v, causal=True, window=kw.get("window"))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-12b"])
def test_flash_prefill_equals_naive_prefill_on_cpu(arch):
    """On CPU tensors the flash path is the plain version, so the whole
    prefill (logits and caches) is the naive prefill, bit for bit."""
    cfg = tconfigs.get_config(arch, smoke=True)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.tensor(np.random.RandomState(7).randint(0, cfg.vocab, (2, 37)))
    outs = []
    for impl in ("flash", "naive"):
        caches = tlm.init_caches(cfg, 2, 48, "cpu")
        lg, caches = tsteps.make_prefill_step(cfg, impl=impl)(params, tok, caches)
        outs.append((lg, caches))
    (lf, cf), (ln, cn) = outs
    assert torch.equal(lf, ln)
    for gf, gn in zip(cf["g0"], cn["g0"]):
        for name in ("k", "v", "pos"):
            assert torch.equal(gf[name], gn[name])


# ----------------------------------------------- the bf16 kernel's numerics

NEG = -2.0e38


def emulate_bf16_kernel(q, k, v, *, causal, window, split_p, blk=64):
    """csrc/flash_attention.cu's bf16 arithmetic in torch: bf16 q, k, v;
    S = Q.K^T in f32 (products of bf16 values are exact), scaled in f32
    afterwards; an online softmax in f32 over the kernel's key tiles
    (causal stop, window skip, the -2e38 sentinel); P.V with P split into
    bf16 hi + lo (split_p) or rounded once to bf16, accumulated in f32, l
    summing the f32 p; one bf16 rounding of acc / max(l, 1e-30)."""
    B, Sq, H, dh = q.shape
    Sk, g = k.shape[1], H // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)                      # [B, H, Sq, dh]
    kf, vf = (t.float().repeat_interleave(g, 2).permute(0, 2, 1, 3)
              for t in (k, v))
    scale = float(1.0 / np.sqrt(dh))
    out = torch.empty(B, H, Sq, dh)
    nk = -(-Sk // blk)
    for q0 in range(0, Sq, blk):
        rows = torch.arange(q0, min(q0 + blk, Sq))
        hi = min(nk, int(rows[-1]) // blk + 1) if causal else nk
        lo = max(0, (q0 - window) // blk) if window else 0
        m = torch.full((B, H, len(rows)), NEG)
        l = torch.zeros(B, H, len(rows))
        acc = torch.zeros(B, H, len(rows), dh)
        for kt in range(lo, hi):
            keys = torch.arange(kt * blk, min((kt + 1) * blk, Sk))
            s = (qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)) * scale
            ok = torch.ones(len(rows), len(keys), dtype=torch.bool)
            if causal:
                ok &= keys[None, :] <= rows[:, None]
            if window:
                ok &= keys[None, :] > rows[:, None] - window
            s = torch.where(ok, s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            p_hi = p.bfloat16().float()
            pv = p_hi @ vf[:, :, keys]
            if split_p:
                pv = pv + (p - p_hi).bfloat16().float() @ vf[:, :, keys]
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).bfloat16()


def share_of_round_tol(out, wide) -> float:
    """The worst |out - wide| as a share of the one-rounding bound."""
    atol, rtol = FA.BF16_ROUND_TOL
    return float((np.abs(f32(out) - wide) / (atol + rtol * np.abs(wide))).max())


def bf16_inputs(shape, window):
    """bf16 q, k, v (torch) and the JAX naive attention run in f32 on the
    same bf16 values, causal."""
    (tq, tk, tv), (jq, jk, jv), _ = inputs(shape, "bfloat16")
    wide = f32(jax_naive(*(a.astype(jnp.float32) for a in (jq, jk, jv)),
                         causal=True, window=window))
    return (tq, tk, tv), wide


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("window", [None, 64])
def test_split_p_emulation_within_one_bf16_rounding_of_f32(shape, window):
    """The kernel's design (split P) against the JAX naive attention in f32
    on the same bf16 inputs, over the JAX flash sweep."""
    (tq, tk, tv), wide = bf16_inputs(shape, window)
    out = emulate_bf16_kernel(tq, tk, tv, causal=True, window=window,
                              split_p=True)
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape
    assert share_of_round_tol(out, wide) <= 1.0


@pytest.mark.parametrize("dh", [64, 128])
def test_single_bf16_p_breaks_the_bound_on_short_rows(dh):
    """A single bf16 P (rounded before P.V) lands far outside one bf16
    rounding of the f32 result, on the short causal rows where a few
    weights carry the output; the split P on the same inputs does not.
    So the check on the card tells the two designs apart."""
    (tq, tk, tv), wide = bf16_inputs((2, 256, 256, 4, 2, dh), None)
    single = share_of_round_tol(emulate_bf16_kernel(
        tq, tk, tv, causal=True, window=None, split_p=False), wide)
    split = share_of_round_tol(emulate_bf16_kernel(
        tq, tk, tv, causal=True, window=None, split_p=True), wide)
    assert split <= 1.0 < 4.0 < single


# ------------------------------------------------ the bf16 kernel's TMA layout

def lm_qkv(arch="llama3.2-1b", B=2, S=37):
    """q, k, v as the LM's attention forward makes them, in bf16."""
    import dataclasses
    cfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                              dtype="bfloat16")
    p = tattn.init_attn(cfg, torch.Generator().manual_seed(0),
                        cfg.layer_specs()[0])
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(1)
                    ).bfloat16()
    pos = torch.arange(S)
    q = tlayers.rope(tattn._proj_in(x, p["wq"]), pos, cfg.rope_theta)
    k = tlayers.rope(tattn._proj_in(x, p["wk"]), pos, cfg.rope_theta)
    return q, k, tattn._proj_in(x, p["wv"])


def test_tma_layout_check_accepts_the_lm_layouts():
    q, k, v = lm_qkv()
    assert q.dtype == torch.bfloat16
    for name, t in (("q", q), ("k", k), ("v", v)):
        FA.check_tma_layout(name, t)
    B, S, H, Hkv, dh = 2, 37, 8, 2, 64
    fused = torch.zeros(B, S, H + 2 * Hkv, dh, dtype=torch.bfloat16)
    views = fused[:, :, :H], fused[:, :, H:H + Hkv], fused[:, :, H + Hkv:]
    assert not any(t.is_contiguous() for t in views)
    for name, t in zip("qkv", views):
        FA.check_tma_layout(name, t)
    # a dimension of size 1 is never stepped: its stride is not checked
    FA.check_tma_layout("q", torch.zeros(1, 1, 3, 16, dtype=torch.bfloat16)
                        .as_strided((1, 1, 3, 16), (5, 7, 16, 1)))


@pytest.mark.parametrize("case,match", [
    ("seq", r"k: seq stride 516 elements \(1032 bytes\)"),
    ("head", r"k: head stride 68 elements \(136 bytes\)"),
    ("batch", r"k: batch stride 19458 elements \(38916 bytes\)"),
    ("base", r"k: base address 0x[0-9a-f]+ is not 16-byte aligned"),
])
def test_tma_layout_check_names_what_it_refuses(case, match):
    """Each view breaks one rule and keeps the others (S even keeps the
    seq-stride case's batch stride aligned)."""
    B, S, H, dh = 2, 38, 8, 64
    bf = torch.bfloat16
    if case == "seq":
        t = torch.zeros(B, S, H * dh + 4, dtype=bf)[:, :, :H * dh].unflatten(2, (H, dh))
    elif case == "head":
        t = torch.zeros(B, S, H, dh + 4, dtype=bf)[..., :dh]
    elif case == "batch":
        t = torch.zeros(B * S * H * dh + 2, dtype=bf).as_strided(
            (B, S, H, dh), (S * H * dh + 2, H * dh, dh, 1))
    else:
        t = torch.zeros(B * S * H * dh + 1, dtype=bf)[1:].view(B, S, H, dh)
    with pytest.raises(ValueError, match=match):
        FA.check_tma_layout("k", t)
