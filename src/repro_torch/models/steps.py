"""Train / serve step factories on torch (the port of
repro.models.steps).

train_step: the causal-LM loss (+ the MoE aux term, + deepseek-v3's MTP
leg), gradients by torch.autograd, global-norm clip, the optional grad
transform, the optimizer update.  Microbatching is a Python loop that
accumulates f32 gradients (the JAX package's lax.scan); its metrics are
the last microbatch's.  The step is functional: it returns new parameter
and optimizer-state trees and writes none of the caller's tensors.  Its
attention runs ``impl`` "naive" or "blockwise" in plain torch, as the
JAX package's training forward does: the flash kernel has no backward,
and ``impl="flash"`` under autograd raises (models/attention.py).

prefill: build the caches over a prompt and return the last position's
logits; decode: one token against the caches.  Both write the caches in
place and return them.  The prefill unembeds only the last position
(the JAX package unembeds every position and slices): the same logits
row, without a ``[B, S, V]`` f32 tensor (16.8 GB at the serve shape).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import clip_by_global_norm
from repro_torch.pytree import tree_leaves, tree_map, tree_structure, \
    tree_unflatten


def loss_fn(cfg: ModelConfig, params, batch, impl="blockwise"):
    """(loss, metrics) of one batch: tokens [B, S], labels [B, S], and
    optionally mask [B, S], patches (paligemma) and frames (whisper).
    metrics: nll, aux (the MoE layers' load-balance loss), mtp_nll
    (deepseek-v3: token t+2 from the trunk's hidden state at t and the
    embedding of token t+1, weighted 0.3) and loss, f32 0-d tensors."""
    tokens, labels = batch["tokens"], batch["labels"]
    mask = batch.get("mask")
    out = lm.forward(cfg, params, tokens, patches=batch.get("patches"),
                     frames=batch.get("frames"), impl=impl,
                     return_hidden=cfg.mtp)
    if cfg.mtp:
        logits, _, aux, hidden = out
    else:
        logits, _, aux = out
        hidden = None
    if cfg.vlm_patches:
        logits = logits[:, cfg.vlm_patches:]
        if hidden is not None:
            hidden = hidden[:, cfg.vlm_patches:]

    nll = _xent(logits, labels, mask)
    loss = nll + cfg.router_aux_coef * aux
    metrics = {"nll": nll, "aux": aux}
    if cfg.mtp and hidden is not None:
        nxt = L.embed(cfg, params["embed"], tokens[:, 1:])
        h = hidden[:, :-1]
        pos = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
        mlogits = lm.mtp_logits(cfg, params, h, nxt, pos, impl="blockwise")
        mmask = None if mask is None else mask[:, 1:]
        mtp_nll = _xent(mlogits, labels[:, 1:], mmask)
        loss = loss + 0.3 * mtp_nll
        metrics["mtp_nll"] = mtp_nll
    metrics["loss"] = loss
    return loss, metrics


def _xent(logits, labels, mask):
    # the difference is taken before the last dim is dropped: on a
    # vocab-sharded DTensor (the dry run's collective count) the gathered
    # logit is a masked partial whose mask keeps the gather's shape
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    gold = torch.gather(logits, -1, labels[..., None].long())
    nll = (lse - gold)[..., 0]
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _value_and_grad(cfg, params, batch, impl):
    """((loss, metrics), grads): grads a tree like params, each leaf in
    its parameter's dtype (zeros where the loss does not reach it, as
    jax.grad gives).  The metrics are detached."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, tree_unflatten(tree_structure(params),
                                                    live), batch, impl)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _synced(g, p)
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(tree_structure(params),
                                                    grads)


def _synced(g, p):
    """A DTensor gradient (the dry run's collective count) in its
    parameter's placements: the sum over the data shards is issued once
    here, as a partitioner issues it, and not again at each later use of
    a partial gradient.  A plain tensor is returned as it is."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, opt_update, *, microbatches: int = 1,
                    clip_norm: float = 1.0, impl: str = "blockwise",
                    compress_fn=None):
    """Returns train_step(params, opt_state, step, batch) ->
    (params, opt_state, metrics).

    microbatches > 1 splits the batch's rows into that many microbatches
    and averages their f32 gradients.  compress_fn (optional) transforms
    the clipped grads before the optimizer (repro_torch.optim.compression).
    step: an int or an integer tensor (the schedule's step)."""

    def train_step(params, opt_state, step, batch):
        if microbatches == 1:
            (_, metrics), grads = _value_and_grad(cfg, params, batch, impl)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatches):
                mbatch = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                       + tuple(v.shape[1:]))[i]
                          for k, v in batch.items()}
                (_, metrics), g = _value_and_grad(cfg, params, mbatch, impl)
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                del g
            grads = tree_map(lambda g: g / microbatches, grads)

        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            if compress_fn is not None:
                grads = compress_fn(grads)
            updates, opt_state = opt_update(grads, opt_state, params, step)
            del grads
            params = tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step


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


def make_extend_step(cfg: ModelConfig, impl: str = "blockwise"):
    """extend(params, tokens [B, S], caches, positions [S]) -> (last_logits
    [B, V], caches): the tokens continue the sequences the caches hold
    (every position before `positions`, an int32 tensor on the tokens'
    device); one token takes the decode path."""

    def extend(params, tokens, caches, positions):
        x, _ = lm.hidden_states(cfg, params, tokens, positions=positions,
                                caches=caches, impl=impl, extend=True)
        return L.unembed(cfg, params["embed"], x[:, -1]), caches

    return extend


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
