"""Serve-step factories on torch (the prefill and decode halves of
repro.models.steps).  The train step and its loss wait for the training
slice (ROADMAP.md queue A item 9).

prefill: build the caches over a prompt and return the last position's
logits; decode: one token against the caches.  Both write the caches in
place and return them.  The prefill unembeds only the last position
(the JAX package unembeds every position and slices): the same logits
row, without a ``[B, S, V]`` f32 tensor (16.8 GB at the serve shape).
"""

from __future__ import annotations

from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, impl: str = "blockwise"):
    """prefill(params, tokens [B, S], caches) -> (last_logits [B, V],
    caches)."""

    def prefill(params, tokens, caches):
        x, _ = lm.hidden_states(cfg, params, tokens, caches=caches, impl=impl)
        return L.unembed(cfg, params["embed"], x[:, -1]), caches

    return prefill


def make_decode_step(cfg: ModelConfig, impl: str = "blockwise"):
    """decode(params, caches, token [B, 1], pos) -> (logits [B, V], caches).
    pos: [] (synchronized batch) or [B] (ragged continuous batching), an
    integer tensor on the params' device."""

    def decode(params, caches, token, pos):
        positions = pos[..., None].int()
        if cfg.vlm_patches:
            positions = positions + cfg.vlm_patches
        x, _ = lm.hidden_states(cfg, params, token, positions=positions,
                                caches=caches, impl=impl)
        return L.unembed(cfg, params["embed"], x[:, -1]), caches

    return decode
