"""The port's multi-head latent attention (repro_torch.models.attention's
MLA, deepseek-v3) against the JAX package's on the CPU, at SMOKE width.

One MLA layer from the JAX package's init_attn, carried across, on
numpy inputs from seeds: the prefill (the port's naive and blockwise
against the JAX package's naive: at S <= 2,048 the JAX package runs
naive whatever ``impl`` says, the port runs blockwise for ``impl`` in
{"blockwise", "flash"}); the latent cache ``c`` after a prefill and
each decode step (f32 within 1e-5; slots not yet written stay zero);
decode through the decompressed cache and absorbed (``mla_absorb``),
with shared and per-row positions and through a ring buffer, each
against the JAX package's.  Tolerances: f32 1e-5 for a layer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.models import attention as TA
from repro_torch.models import lm as tlm

DEEPSEEK = "deepseek-v3-671b"


def cfgs(**kw):
    j, t = (jconfigs.get_config(DEEPSEEK, smoke=True),
            tconfigs.get_config(DEEPSEEK, smoke=True))
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def close(t, j, tol):
    np.testing.assert_allclose(np.asarray(t, np.float32),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def layer(jcfg, tcfg, window=None, seed=0):
    """(jax spec, port spec, jax params, port params) of one MLA layer."""
    jspec = dataclasses.replace(jcfg.groups[0][0][0], window=window)
    tspec = dataclasses.replace(tcfg.groups[0][0][0], window=window)
    jp = JA.init_attn(jcfg, jax.random.PRNGKey(seed), jspec)[0]
    tp = tlm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jspec, tspec, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 7, 40, 600])
def test_mla_prefill_matches_jax(S, dtype):
    """No cache: the port's naive and blockwise (and "flash", which is
    blockwise on MLA) against the JAX package's naive, f32 within 1e-5 and
    bf16 within 2e-2; S=600 spans two 512-query blocks."""
    jcfg, tcfg = cfgs(dtype=dtype)
    jspec, tspec, jp, tp = layer(jcfg, tcfg)
    x = np.random.RandomState(S).randn(2, S, jcfg.d_model).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.tensor(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    want = JA.attn_forward(jcfg, jspec, jp, jx, jnp.asarray(pos), None,
                           impl="naive")[0]
    outs = {impl: TA.attn_forward(tcfg, tspec, tp, tx, torch.tensor(pos), None,
                                  impl=impl)[0]
            for impl in TA.IMPLS}
    for impl, out in outs.items():
        close(out.float(), np.asarray(want.astype(jnp.float32)),
              1e-5 if dtype == "float32" else 2e-2)
    assert torch.equal(outs["flash"], outs["blockwise"])


CACHE_CASES = [  # (window, positions kind, absorb)
    (None, "shared", False), (None, "shared", True),
    (None, "per_row", False), (None, "per_row", True),
    (8, "shared", False), (8, "per_row", True),
]


@pytest.mark.parametrize("window,kind,absorb", CACHE_CASES)
def test_mla_cache_and_decode_match_jax(window, kind, absorb):
    """A 13-token prefill into a 24-slot cache (into an 8-slot ring when
    windowed: the prefill keeps its last 8 latents), then 3 decode steps,
    decompressed or absorbed: the cache ``c`` and every output against
    the JAX package's."""
    jcfg, tcfg = cfgs(mla_absorb=absorb)
    jspec, tspec, jp, tp = layer(jcfg, tcfg, window, seed=1)
    B, d = 3, jcfg.d_model
    rng = np.random.RandomState(4)
    jc = JA.init_cache(jcfg, jspec, B, 24)
    tc = TA.init_cache(tcfg, tspec, B, 24, "cpu")
    assert tc["c"].shape == jc["c"].shape
    pos0 = np.arange(13, dtype=np.int32)
    if kind == "per_row":
        pos0 = pos0[None] + np.array([[0], [2], [5]], np.int32)
    x = rng.randn(B, 13, d).astype(np.float32)
    jo, jc = JA.attn_forward(jcfg, jspec, jp, jnp.asarray(x), jnp.asarray(pos0),
                             jc, impl="naive")
    to, tc = TA.attn_forward(tcfg, tspec, tp, torch.tensor(x),
                             torch.tensor(pos0), tc, impl="naive")
    close(to, jo, 1e-5)
    written = np.asarray(jc["c"]).any(-1)
    close(tc["c"], jc["c"], 1e-5)
    assert not tc["c"].numpy()[~written].any()
    assert int(tc["pos"]) == int(jc["pos"])
    for step in range(3):
        cur = (pos0[..., -1:] + 1 + step).astype(np.int32)   # [1] or [B, 1]
        x1 = rng.randn(B, 1, d).astype(np.float32)
        jo, jc = JA.attn_forward(jcfg, jspec, jp, jnp.asarray(x1),
                                 jnp.asarray(cur), jc, impl="naive")
        to, tc = TA.attn_forward(tcfg, tspec, tp, torch.tensor(x1),
                                 torch.tensor(cur), tc, impl="naive")
        close(tc["c"], jc["c"], 1e-5)
        close(to, jo, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absorbed_decode_equals_decompressed(dtype):
    """The port's two decodes of one prefilled cache agree (the same math,
    reordered matmuls): within 1e-5 in f32, 2e-2 in bf16."""
    _, tcfg = cfgs(dtype=dtype)
    gen = torch.Generator().manual_seed(3)
    spec = tcfg.groups[0][0][0]
    p = TA.init_attn(tcfg, gen, spec)
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    x = torch.randn(2, 10, tcfg.d_model, generator=gen).to(dt)
    cache = TA.init_cache(tcfg, spec, 2, 16, "cpu")
    TA.attn_forward(tcfg, spec, p, x, torch.arange(10), cache)
    x1 = torch.randn(2, 1, tcfg.d_model, generator=gen).to(dt)
    outs = []
    for absorb in (False, True):
        c = {k: v.clone() for k, v in cache.items()}
        cfg = dataclasses.replace(tcfg, mla_absorb=absorb)
        outs.append(TA.attn_forward(cfg, spec, p, x1, torch.tensor([10]), c)[0])
    close(outs[1].float(), outs[0].float(), 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("arch,absorb", [(DEEPSEEK, False), (DEEPSEEK, True),
                                         ("mixtral-8x22b", False)])
def test_model_decode_matches_teacher_forced_forward(arch, absorb, monkeypatch):
    """The whole SMOKE model (deepseek: MLA, MoE with a shared expert;
    mixtral: GQA past its 16-token window, MoE): prefill 20 tokens
    through the caches, decode 6; every row within 2e-3 of the full
    forward (tests/test_models_smoke.py's bound).  The prefill, the
    decode steps and the forward route different token counts, so their
    capacities differ; capacity is made unbounded here (no pair drops)
    so that the three compute the same function."""
    from repro_torch.models import moe as TM
    from repro_torch.models import steps as tsteps

    monkeypatch.setattr(TM, "capacity", lambda T, K, E, cf: T * K)
    tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                               mla_absorb=absorb)
    jcfg = jconfigs.get_config(arch, smoke=True)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(2))
    tp = tlm.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    tok = torch.tensor(np.random.RandomState(8).randint(
        0, tcfg.vocab, (2, 26)).astype(np.int64))
    full = tlm.forward(tcfg, tp, tok, impl="naive")[0]
    caches = tlm.init_caches(tcfg, 2, 32, "cpu")
    lg, caches = tsteps.make_prefill_step(tcfg, impl="flash")(tp, tok[:, :20], caches)
    close(lg, full[:, 19], 2e-3)
    dec = tsteps.make_decode_step(tcfg, impl="flash")
    for i in range(20, 26):
        lg, caches = dec(tp, caches, tok[:, i:i + 1], torch.tensor(i))
        close(lg, full[:, i], 2e-3)
