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
    """prefill(params, tokens [B, S], caches, patches=None, frames=None)
    -> (last_logits [B, V], caches).  patches [B, P, d] (paligemma) go
    ahead of the tokens, so the caches must hold P + S positions; frames
    [B, T, d] (whisper) run through the encoder, and its cross K/V is
    stored in the caches for decode."""

    def prefill(params, tokens, caches, patches=None, frames=None):
        x, _ = lm.hidden_states(cfg, params, tokens, caches=caches, impl=impl,
                                patches=patches, frames=frames)
        return L.unembed(cfg, params["embed"], x[:, -1]), caches

    return prefill


def make_decode_step(cfg: ModelConfig, impl: str = "blockwise"):
    """decode(params, caches, token [B, 1], pos) -> (logits [B, V], caches).
    pos: [] (synchronized batch) or [B] (ragged continuous batching), an
    integer tensor on the params' device: the token's index among the
    text tokens (a VLM prefix's P positions are added).  Whisper's
    cross-attention reads the K/V the prefill stored in the caches."""

    def decode(params, caches, token, pos):
        positions = pos[..., None].int()
        if cfg.vlm_patches:
            positions = positions + cfg.vlm_patches
        x, _ = lm.hidden_states(cfg, params, token, positions=positions,
                                caches=caches, impl=impl)
        return L.unembed(cfg, params["embed"], x[:, -1]), caches

    return decode
