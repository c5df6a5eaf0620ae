"""The port's flash-attention wrapper (kernels/flash_attention.py) on the
CPU, where it runs its plain version.

Held against the JAX package's naive_attention over the sweep of
tests/test_flash_kernel.py (SHAPES x f32/bf16 x window) at that test's
tolerances (f32 2e-5, bf16 2e-2), and against the Pallas kernel in
interpret mode where this jax can run it.  The wrapper must refuse what
the kernel does not take.  The CUDA kernel itself is held against the
plain version by tests/test_torch_cuda.py and chip_smoke.py, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import naive_attention as jax_naive
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.ref import flash_attention_plain
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
