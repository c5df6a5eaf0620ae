"""Batched admission in the LM continuation pool (serving/batcher.py):
a wave of rows admitted together against the same rows admitted one at
a time, on SMOKE models in float32 on the CPU.

A wave's rows that carry a prefix and a suffix run one extend forward a
suffix length (``batch_rows`` rows at most); admitted alone, each runs
its own B=1 forward.  The first tokens must be equal and the first
logits within 1e-5 (a wider M changes the CPU GEMM's blocking, so rows
need not agree bit for bit), the admitted pool rows' caches within 1e-5,
every row not admitted bit for bit, every ``lm_*`` counter but the two
admission-forward counts equal, no MoE pair dropped, and the greedy
continuations equal.  Where the rows stay on the per-row path
(capacity-bounded MoE: the MoE of mixtral-8x22b, its attention made
global so that a cache extends; single rows; prompts without a prefix
or equal to it) the logits are equal bit for bit and the forwards are
counted one a row.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import lm, steps
from repro_torch.models.config import LayerSpec
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving import batcher as B

MAX_LEN = 48
PREFIXES = (13, 21)              # the two prefixes' lengths
WAVE = [(i % 2, 1 + (i // 2) % 4) for i in range(12)]   # (prefix, S)
HORIZON = 3
TOL = 1e-5


def model(arch: str):
    cfg = configs.get_config(arch, smoke=True)
    if arch == "mixtral-8x22b":   # global attention: a cache extends
        cfg = dataclasses.replace(cfg, groups=(((LayerSpec(
            kind="attn", window=None, mlp="moe"),), 2),))
    return cfg, lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def prefixes(cfg, params) -> list:
    rng = np.random.default_rng(1)
    prefill = steps.make_prefill_step(cfg, "naive")
    out = []
    for n in PREFIXES:
        toks = rng.integers(0, cfg.vocab, n)
        caches = lm.init_caches(cfg, 1, MAX_LEN, "cpu")
        logits = prefill(params, torch.as_tensor(toks)[None], caches)[0]
        out.append(B.PrefixState(toks, caches, logits[0].numpy()))
    return out


def requests(cfg, pre: list, wave: list) -> list:
    """(prefix index or None, S): None a prompt of 9 fresh tokens without
    a prefix; S=0 the prefix itself."""
    rng = np.random.default_rng(2)
    out = []
    for uid, (p, S) in enumerate(wave):
        if p is None:
            prompt, prefix = rng.integers(0, cfg.vocab, 9), None
        else:
            prefix = pre[p]
            prompt = np.concatenate([prefix.tokens,
                                     rng.integers(0, cfg.vocab, S)])
        out.append(B.Request(uid=uid, prompt=prompt.astype(np.int32),
                             max_new_tokens=HORIZON, prefix=prefix))
    return out


def admit(cfg, params, wave, pool, occupied, alone):
    """A batcher whose pool caches hold noise and whose `occupied` slots
    hold placeholders; the wave admitted together or each row alone.
    The rows' logits replace their log-probs (first the admission's)."""
    reg = MetricsRegistry()
    b = B.ContinuousBatcher(cfg, params, pool_size=pool, max_seq=MAX_LEN,
                            impl="naive", record_logprobs=True, metrics=reg)
    gen = torch.Generator().manual_seed(3)
    for per_pos in b.caches.values():
        for c in per_pos:
            for name, t in c.items():
                if name != "pos":
                    t.copy_(torch.randn(t.shape, generator=gen))
    for slot in occupied:
        b.slots[slot] = B.Request(uid=-1 - slot, prompt=np.zeros(5, np.int32),
                                  max_new_tokens=HORIZON)
        b.pos[slot] = 5
    for r in requests(cfg, prefixes(cfg, params), wave):
        b.submit(r)
        if alone:
            b._admit()
    b._admit()
    caches = {g: [{k: t.clone() for k, t in c.items()} for c in per_pos]
              for g, per_pos in b.caches.items()}
    firsts = {r.uid: (slot, r.tokens[0], r.logprobs[0])
              for slot, r in enumerate(b.slots)
              if r is not None and r.uid >= 0}
    done = {r.uid: r.tokens for r in b.run(max_steps=50) if r.uid >= 0}
    return firsts, caches, reg.snapshot(), done


CASES = {
    # name: (arch, pool, occupied slots, wave, admission forwards, exact)
    "granite": ("granite-4.0-h-small", 12, (), WAVE, 4, False),
    "granite-occupied": ("granite-4.0-h-small", 16, (3, 7, 8, 15), WAVE, 4,
                         False),
    "llama-dense-rope": ("llama3.2-1b", 12, (), WAVE, 4, False),
    "mamba2-ssd-only": ("mamba2-2.7b", 12, (), WAVE, 4, False),
    # capacity-bounded MoE: every row alone, as before
    "mixtral-capacity": ("mixtral-8x22b", 12, (), WAVE, 12, True),
    # dropless, 24 rows x 3 tokens past SYNC_FREE_TOKENS: 21 rows, then 3
    "granite-split": ("granite-4.0-h-small", 24, (), [(i % 2, 3)
                                                      for i in range(24)],
                      2, False),
    # prompt prefills and copies keep their paths; a lone S=2 row its B=1
    "granite-mixed": ("granite-4.0-h-small", 8, (),
                      [(None, 0), (0, 0), (0, 1), (1, 1), (1, 0), (0, 2),
                       (None, 0), (1, 1)], 4, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_a_wave_admits_as_its_rows_alone(case, monkeypatch):
    arch, pool, occupied, wave, forwards, exact = CASES[case]
    monkeypatch.setattr(B, "_logprob", lambda row, tok: np.array(row))
    cfg, params = model(arch)
    got = admit(cfg, params, wave, pool, occupied, alone=False)
    want = admit(cfg, params, wave, pool, occupied, alone=True)
    (g_first, g_caches, g_reg, g_done), (w_first, w_caches, w_reg,
                                          w_done) = got, want
    assert g_first.keys() == w_first.keys() == set(range(len(wave)))
    for uid, (slot, tok, logits) in g_first.items():
        assert (slot, tok) == w_first[uid][:2], uid
        if exact:
            np.testing.assert_array_equal(logits, w_first[uid][2])
        else:
            np.testing.assert_allclose(logits, w_first[uid][2], atol=TOL,
                                       rtol=0, err_msg=str(uid))
    admitted = sorted(slot for slot, _, _ in g_first.values())
    for g, per_pos in g_caches.items():
        for gc, wc in zip(per_pos, w_caches[g]):
            for name in gc:
                if name == "pos":
                    continue
                a, b = gc[name], wc[name]
                np.testing.assert_allclose(a[:, admitted], b[:, admitted],
                                           atol=TOL, rtol=0, err_msg=name)
                rest = [s for s in range(pool) if s not in admitted]
                assert torch.equal(a[:, rest], b[:, rest]), name
    new = ("lm_admit_forwards_total", "lm_admit_forward_rows_total")
    for name in set(g_reg) | set(w_reg):
        if name.startswith("lm_") and name not in new:
            assert g_reg[name] == w_reg[name], name
    drops = "moe_tokens_dropped_total"
    assert g_reg[drops] == w_reg[drops]
    if cfg.moe_dropless or not cfg.n_experts:   # (mixtral's decode drops)
        assert g_reg[drops] == {drops: 0}
    rows = sum(1 for p, S in wave if p is None or S > 0)
    assert g_reg[new[0]] == {new[0]: forwards}
    assert g_reg[new[1]] == {new[1]: rows}
    assert w_reg[new[0]] == {new[0]: rows}
    assert g_done == w_done


@pytest.mark.parametrize("arch,S,pool,want", [
    ("granite-4.0-h-small", 1, 16, 16), ("granite-4.0-h-small", 4, 16, 16),
    ("granite-4.0-h-small", 5, 16, 12), ("granite-4.0-h-small", 65, 16, 1),
    ("mixtral-8x22b", 1, 16, 1), ("llama3.2-1b", 9, 16, 16),
])
def test_batch_rows_follows_the_routing(arch, S, pool, want):
    assert B.batch_rows(model(arch)[0], S, pool) == want
