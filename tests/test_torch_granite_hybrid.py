"""granite-4.0-h-small on the port (SMOKE: two periods of Mamba-2,
NoPE attention, Mamba-2, 8 experts top-2 and a shared expert, float32)
against the benchmark's plain reference (mcts_bench/reference/
granite_hybrid.py), on seeded random weights drawn by the reference.

Tolerances, all float32 against float32: logits 5e-7 absolute (they are
about 0.05 here; the two sides contract the same products in other
orders, the SSD in other chunkings, and differ by up to 4e-8 — a bf16
activation anywhere moves them by about 1e-4); the published Mamba-2
mixer and the NoPE attention 2e-5 (outputs of order 1, the same
reassociation); continuation values 2e-5 (a mean log-prob of about -6.2
from numpy's float32 logaddexp against the reference's float64
log-softmax).  The JAX-default fields are held bit for bit: the SMOKE
outputs of mamba2-2.7b, mixtral-8x22b and llama3.2-1b hash as they did
before the fields were added.
"""

import dataclasses
import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO)]

from mcts_bench.reference import granite_hybrid as ref  # noqa: E402
from mcts_bench.systems import granite_hybrid as gh  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import lm, steps  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import ssd as SSD  # noqa: E402
from repro_torch.models.config import param_count  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.sim.lm import LMContinuationBackend, LMTreeEnv  # noqa: E402

ARCH = "granite-4.0-h-small"
SEED = 11
LOGITS_TOL = 5e-7
MIXER_TOL = 2e-5


@pytest.fixture(scope="module")
def model():
    cfg = configs.get_config(ARCH, smoke=True)
    dims = gh.dims_of(cfg)
    return cfg, dims, gh.make_params(cfg, dims, SEED, "cpu")


def tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, n)


def reference(dims, toks, at):
    return ref.logits_at(dims, SEED, [toks], [at], "cpu")[0]


def test_param_count_is_the_published_size():
    assert abs(param_count(configs.get_config(ARCH)) - 32.21e9) <= 0.01e9


def test_config_is_the_published_one():
    """CONFIG under the published config.json's keys is the catalog's
    configuration (the benchmark file holds those keys)."""
    import json

    cfg = json.loads((REPO / "mcts_bench/configs/granite4h_small.json")
                     .read_text())
    gh.model_config(cfg)               # raises where a key differs
    assert gh.dims_of(configs.get_config(ARCH))["layer_types"] == \
        cfg["layer_types"]


def test_forward_logits(model):
    cfg, dims, p = model
    toks = tokens(cfg, 50)
    got = lm.forward(cfg, p, torch.as_tensor(toks)[None], impl="naive")[0][0]
    want = reference(dims, toks, np.arange(50))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGITS_TOL,
                               rtol=0)


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_prefill_then_decode_through_the_caches(model, impl):
    """A prefill of 30 tokens, then 20 decode steps through the caches,
    each position's logits against the reference's full forward."""
    cfg, dims, p = model
    toks = tokens(cfg, 50, seed=2)
    t = torch.as_tensor(toks)[None]
    want = reference(dims, toks, np.arange(50))
    caches = lm.init_caches(cfg, 1, 64, "cpu")
    last, caches = steps.make_prefill_step(cfg, impl)(p, t[:, :30], caches)
    got = [last[0]]
    decode = steps.make_decode_step(cfg, impl)
    for i in range(30, 49):
        lg, caches = decode(p, caches, t[:, i:i + 1], torch.tensor(i))
        got.append(lg[0])
    np.testing.assert_allclose(torch.stack(got).numpy(), want[29:49].numpy(),
                               atol=LOGITS_TOL, rtol=0)


def test_extend_continues_a_cache(model):
    """A cache of 30 tokens extended by 11 and then by 1: the last
    positions' logits against the reference's full forward."""
    cfg, dims, p = model
    toks = tokens(cfg, 42, seed=3)
    t = torch.as_tensor(toks)[None]
    want = reference(dims, toks, np.array([40, 41]))
    caches = lm.init_caches(cfg, 1, 64, "cpu")
    steps.make_prefill_step(cfg, "naive")(p, t[:, :30], caches)
    extend = steps.make_extend_step(cfg, "naive")
    a, caches = extend(p, t[:, 30:41], caches,
                       torch.arange(30, 41, dtype=torch.int32))
    b, caches = extend(p, t[:, 41:42], caches, torch.tensor([41],
                                                             dtype=torch.int32))
    np.testing.assert_allclose(torch.cat([a, b]).numpy(), want.numpy(),
                               atol=LOGITS_TOL, rtol=0)


def _envs(cfg, p, prompt):
    snap = LMTreeEnv(cfg, p, fanout=4, horizon=3, impl="naive", max_len=64,
                     snapshots=True)
    plain = LMTreeEnv(cfg, p, fanout=4, horizon=3, impl="naive", max_len=64)
    for env in (snap, plain):
        env.register(7, prompt)
    return snap, plain


def test_snapshot_path_against_a_forward_from_scratch(model):
    """Root plus suffix from the snapshot, and again after a commit's
    advance, against one forward of the whole sequence; continuations
    admitted from the snapshot against ones prefilled whole."""
    cfg, _, p = model
    snap, plain = _envs(cfg, p, tokens(cfg, 30, seed=4))
    reg = MetricsRegistry()
    snap.bind_metrics(reg)
    s0 = snap.initial_state(7)
    snap.root_changed(None, s0)
    s1 = snap.step(s0, 1)[0]
    s2 = snap.step(s1, 2)[0]
    s3 = snap.step(s2, 0)[0]
    for s in (s0, s1, s2, s3):
        np.testing.assert_allclose(snap.logits(s), plain.logits(s),
                                   atol=LOGITS_TOL, rtol=0)
    before = snap.logits(s3)
    snap.root_changed(s0, s1)                   # commit: advance by s1's token
    assert snap.live_snapshots == 1
    np.testing.assert_allclose(snap.logits(s1), plain.logits(s1),
                               atol=LOGITS_TOL, rtol=0)
    np.testing.assert_allclose(snap.logits(s3), before, atol=LOGITS_TOL,
                               rtol=0)
    states = np.stack([s1, s2, s3, s2])
    got, _ = LMContinuationBackend(snap, pool_size=2).evaluate(states)
    want, _ = LMContinuationBackend(plain, pool_size=2).evaluate(states)
    np.testing.assert_allclose(got, want, atol=MIXER_TOL, rtol=0)
    assert got[1] == got[3]
    assert reg.get("lm_tokens_forwarded_total", phase="prompt").value == 30
    assert reg.get("lm_prefix_tokens_reused_total").value > 0
    snap.root_changed(s1, None)                 # the search ends
    assert snap.live_snapshots == 0


def test_batched_admission_against_a_forward_from_scratch(model,
                                                          monkeypatch):
    """A wave of 16 continuations from two root snapshots (30 and 21
    tokens), two a root and suffix length 1-4, admits as one extend
    forward of 4 rows a suffix length: each row's first logits against
    the reference's forward of its whole prompt, and the rows'
    continuation values against ones prefilled whole."""
    cfg, dims, p = model
    snap, plain = _envs(cfg, p, tokens(cfg, 30, seed=5))
    for env in (snap, plain):
        env.register(8, tokens(cfg, 21, seed=6))
    roots = [snap.initial_state(7), snap.initial_state(8)]
    for s in roots:
        snap.root_changed(None, s)
    rng = np.random.default_rng(7)
    states = []
    for S in (1, 2, 3, 4):
        for root in roots:
            for _ in range(2):
                s, n = root.copy(), int(root[0])
                s[1 + n:1 + n + S] = rng.integers(0, cfg.vocab, S)
                s[0] = n + S
                states.append(s)
    states = np.stack(states)
    reg = MetricsRegistry()
    got, _ = LMContinuationBackend(snap, pool_size=16,
                                   metrics=reg).evaluate(states)
    want, _ = LMContinuationBackend(plain, pool_size=16).evaluate(states)
    np.testing.assert_allclose(got, want, atol=MIXER_TOL, rtol=0)
    assert reg.get("lm_admit_forwards_total").value == 4
    assert reg.get("lm_admit_forward_rows_total").value == 16
    assert reg.get("moe_tokens_dropped_total").value == 0

    from repro_torch.serving import batcher as B
    monkeypatch.setattr(B, "_logprob", lambda row, tok: np.array(row))
    b = B.ContinuousBatcher(cfg, p, pool_size=16, max_seq=64, impl="naive",
                            record_logprobs=True, extender=snap.extender)
    prompts = [snap.tokens(s) for s in states]
    for uid, toks in enumerate(prompts):
        b.submit(B.Request(uid=uid, prompt=toks.astype(np.int32),
                           max_new_tokens=1, prefix=snap.snapshot_of(toks)))
    b._admit()
    first = {r.uid: r.logprobs[0] for r in b.slots}
    want = ref.logits_at(dims, SEED, prompts,
                         [[len(t) - 1] for t in prompts], "cpu")
    for uid, row in first.items():
        np.testing.assert_allclose(row, want[uid][0].numpy(),
                                   atol=LOGITS_TOL, rtol=0, err_msg=str(uid))


def test_snapshots_refuse_windowed_attention():
    cfg = configs.get_config("mixtral-8x22b", smoke=True)
    p = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="snapshots"):
        LMTreeEnv(cfg, p, snapshots=True)


def test_published_mamba2_block(model):
    """One SSD layer of the published block (conv, then SiLU, then the
    gated RMSNorm) against the reference's mixer, over two chunks and a
    ragged end, from zero state and continued through a cache."""
    cfg, dims, p = model
    w = ref.draw_layer(dims, SEED, 0, "cpu")
    layer = {k: v[0] for k, v in p["g0"][0]["mix"].items()
             if not isinstance(v, dict)}
    layer["conv"] = {k: v[0] for k, v in p["g0"][0]["mix"]["conv"].items()}
    u = torch.randn(1, 21, cfg.d_model, generator=torch.Generator().manual_seed(5))
    want = ref.mamba(dims, w, u[0])
    got, _ = SSD.ssd_forward(cfg, layer, u)
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), atol=MIXER_TOL,
                               rtol=MIXER_TOL)
    cache = SSD.init_ssd_cache(cfg, 1, "cpu")
    a, cache = SSD.ssd_forward(cfg, layer, u[:, :13], cache)
    b, cache = SSD.ssd_forward(cfg, layer, u[:, 13:20], cache)
    c, cache = SSD.ssd_forward(cfg, layer, u[:, 20:], cache)
    np.testing.assert_allclose(torch.cat([a, b, c], 1)[0].numpy(),
                               want.numpy(), atol=MIXER_TOL, rtol=MIXER_TOL)


def test_nope_attention_and_its_scale(model):
    """The attention layer without RoPE at attention_multiplier against
    the reference's; every path (naive, blockwise, flash's plain version)
    takes the configured scale, and positions move nothing."""
    cfg, dims, p = model
    w = ref.draw_layer(dims, SEED, 1, "cpu")
    spec = cfg.layer_specs()[1]
    layer = {k: v[0] for k, v in p["g0"][1]["mix"].items()}
    x = torch.randn(1, 19, cfg.d_model, generator=torch.Generator().manual_seed(6))
    want = ref.attention(dims, w, x[0]).numpy()
    pos = torch.arange(19, dtype=torch.int32)
    for impl in A.IMPLS:
        got, _ = A.attn_forward(cfg, spec, layer, x, pos, impl=impl)
        np.testing.assert_allclose(got[0].numpy(), want, atol=MIXER_TOL,
                                   rtol=MIXER_TOL, err_msg=impl)
    moved, _ = A.attn_forward(cfg, spec, layer, x, pos + 100, impl="naive")
    np.testing.assert_allclose(moved[0].numpy(), want, atol=MIXER_TOL,
                               rtol=MIXER_TOL)
    q, k, v = (torch.randn(1, 9, 4, 16), torch.randn(1, 9, 2, 16),
               torch.randn(1, 9, 2, 16))
    from repro_torch.kernels import flash_attention as FA

    np.testing.assert_allclose(
        FA.flash_attention(q, k, v, scale=1 / 16).numpy(),
        A.naive_attention(q, k, v, causal=True, scale=1 / 16).numpy(),
        atol=1e-6)
    assert not np.allclose(FA.flash_attention(q, k, v, scale=1 / 16).numpy(),
                           FA.flash_attention(q, k, v).numpy())


def test_dropless_routing_keeps_every_pair(model):
    """Eight tokens that all pick the same two experts: the dropless layer
    keeps all 16 pairs (moe_tokens_dropped_total stays 0) and gives the
    reference's output; the capacity path drops and counts them."""
    cfg, dims, p = model
    w = ref.draw_layer(dims, SEED, 0, "cpu")
    moe = {k: (v[0] if not isinstance(v, dict) else
               {kk: vv[0] for kk, vv in v.items()})
           for k, v in p["g0"][0]["moe"].items()}
    bias = torch.zeros(cfg.d_model, cfg.n_experts)
    x = torch.randn(1, 8, cfg.d_model, generator=torch.Generator().manual_seed(7))
    bias[:, 3] = 5.0 * x[0].sign().mean(0)          # experts 3 and 5 win
    bias[:, 5] = 4.0 * x[0].sign().mean(0)
    moe["router"] = moe["router"] + bias
    w["router"] = moe["router"]
    idx = (x[0] @ moe["router"]).topk(2).indices
    assert (idx.sort(-1).values == torch.tensor([3, 5])).all()
    reg = MetricsRegistry()
    from repro_torch.serving.batcher import LMCounters

    counters = LMCounters("cpu", reg)
    with counters.counting():
        y, _ = M.moe_forward(cfg, moe, x)
    counters.fold()
    assert reg.get("moe_tokens_dropped_total").value == 0
    np.testing.assert_allclose(y[0].numpy(), ref.moe(dims, w, x[0]).numpy(),
                               atol=MIXER_TOL, rtol=MIXER_TOL)
    capped = dataclasses.replace(cfg, moe_dropless=False)
    xs = x.repeat(1, 2, 1)                          # 16 tokens: C = 8
    with counters.counting():
        M.moe_forward(capped, moe, xs)
    counters.fold()
    assert reg.get("moe_tokens_dropped_total").value == 16


def _golden(arch: str) -> str:
    cfg = configs.get_config(arch, smoke=True)
    p = lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 40)))
    logits = lm.forward(cfg, p, toks, impl="naive")[0]
    caches = lm.init_caches(cfg, 2, 48, "cpu")
    last, caches = steps.make_prefill_step(cfg, "naive")(p, toks[:, :30],
                                                        caches)
    dec, _ = steps.make_decode_step(cfg, "naive")(p, caches, toks[:, 30:31],
                                                  torch.tensor(30))
    return hashlib.sha256(logits.numpy().tobytes() + last.numpy().tobytes()
                          + dec.numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("arch,digest", [
    ("mamba2-2.7b",
     "bfa5b19fbc7374b10f8f4dc5bf8374a1c8ff5dfdd9e596a6e23d5d8f70b2d806"),
    ("mixtral-8x22b",
     "4cd4ed9486477e2db3fbf3f48eb3f712fd7b6a8f758b1711ffd71bf230957a0c"),
    ("llama3.2-1b",
     "5ecbeb2cb971e169715e36fcc8f70c6cfb28be35a13e2a0f5ee5f7e0329d7ad8"),
])
def test_default_fields_leave_other_models_bit_identical(arch, digest):
    """The forward, a prefill and a decode step of each SMOKE model, on
    one thread, hash as they did before the granite fields existed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert _golden(arch) == digest
    finally:
        torch.set_num_threads(threads)
