"""Model assembly on torch: the decoder LM of repro.models.lm for the
dense, SSD and RG-LRU families.

Parameters are a plain dict with the JAX package's layout: ``embed``
(``tok [V, d]`` f32, ``out`` when untied), ``g{i}`` for each
``(pattern, repeats)`` group — a list over the pattern's positions of
dicts whose tensors are stacked ``[repeats, ...]`` — and ``final_norm``.
The layer loop is a Python loop over groups, repeats and positions (the
JAX package's lax.scan); each layer reads views ``[r]`` of the stacks.
Caches have the same stacked layout and are written in place: ``k``/``v``
for attention, ``conv``/``state`` for SSD, ``conv``/``h`` for RG-LRU
(``RECURRENT_LEAVES`` are the ones a new sequence must start from zero).

Covered: dense GQA stacks (llama / starcoder2 / granite), local:global
patterns (gemma3), SSD stacks (mamba2) and RG-LRU with local attention
(recurrentgemma).  MoE, MLA, the VLM prefix, the encoder and its
cross-attention and the MTP head raise ``NotImplementedError`` (ROADMAP.md
queue A item 8).

``from_jax_params`` carries the JAX package's ``init_params`` tree (as
numpy) across, bf16 leaves included, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import ssd as SSD
from repro_torch.models.config import LayerSpec, ModelConfig

KINDS = ("attn", "ssd", "rglru")
RECURRENT_LEAVES = ("conv", "state", "h")


def _check_supported(cfg: ModelConfig):
    missing = []
    if cfg.attn_impl != "gqa":
        missing.append(f"attn_impl={cfg.attn_impl}")
    if cfg.encoder is not None:
        missing.append("encoder")
    if cfg.mtp:
        missing.append("mtp")
    if cfg.vlm_patches:
        missing.append("vlm_patches")
    for pattern, _ in cfg.groups:
        for spec in pattern:
            if spec.kind not in KINDS or spec.mlp not in ("dense", "none") \
                    or spec.cross_attn:
                missing.append(f"{spec}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {sorted(set(missing))} not ported yet (the port has "
            f"dense GQA, SSD and RG-LRU; MoE, MLA, the VLM prefix, the encoder "
            f"and MTP are ROADMAP.md queue A item 8)")


# ------------------------------------------------------------------ init

def _init_layer(cfg, spec: LayerSpec, gen) -> dict:
    p = {"norm_in": L.init_norm(cfg, gen.device)}
    if spec.kind == "attn":
        p["mix"] = A.init_attn(cfg, gen, spec)
    elif spec.kind == "ssd":
        p["mix"] = SSD.init_ssd(cfg, gen)
    else:
        p["mix"] = R.init_rglru(cfg, gen)
    if spec.mlp == "dense":
        p["norm_mlp"] = L.init_norm(cfg, gen.device)
        p["mlp"] = L.init_mlp(cfg, gen)
    return p


def _stack(layers: list) -> dict:
    if isinstance(layers[0], dict):
        return {k: _stack([l[k] for l in layers]) for k in layers[0]}
    return torch.stack(layers)


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random parameters drawn from `generator` (on its own device) and
    placed on `device`.  The numbers differ from the JAX package's
    (another generator); carry those with from_jax_params."""
    _check_supported(cfg)
    p = {"embed": L.init_embed(cfg, generator)}
    for gi, (pattern, repeats) in enumerate(cfg.groups):
        p[f"g{gi}"] = [_stack([_init_layer(cfg, spec, generator)
                               for _ in range(repeats)]) for spec in pattern]
    p["final_norm"] = L.init_norm(cfg, generator.device)
    return _map(p, lambda t: t.to(device))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy holds bf16 as ml_dtypes.bfloat16, which torch.from_numpy
        # refuses: carry the bits through int16
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def from_jax_params(cfg: ModelConfig, tree, device) -> dict:
    """The port's parameters from the JAX package's ``init_params`` tree
    with its leaves as numpy arrays: same structure, same values, bit for
    bit (bf16 leaves included)."""
    _check_supported(cfg)
    return _map(tree, lambda a: _leaf_from_numpy(a, device))


def _at(tree, r: int):
    """The views [r] of a stacked layer dict."""
    return {k: _at(v, r) if isinstance(v, dict) else v[r] for k, v in tree.items()}


# ------------------------------------------------------------------ block

def _block(cfg, spec: LayerSpec, p, x, positions, cache, impl):
    h = L.norm(cfg, p["norm_in"], x)
    if spec.kind == "attn":
        mix, cache = A.attn_forward(cfg, spec, p["mix"], h, positions, cache,
                                    impl)
    elif spec.kind == "ssd":
        mix, cache = SSD.ssd_forward(cfg, p["mix"], h, cache)
    else:
        mix, cache = R.rglru_forward(cfg, p["mix"], h, cache)
    # the residual stream stays in cfg.dtype (attention upcasts to f32)
    x = x + mix.to(x.dtype)
    if spec.mlp == "dense":
        x = x + L.mlp(cfg, p["mlp"], L.norm(cfg, p["norm_mlp"], x)).to(x.dtype)
    return x


def hidden_states(cfg: ModelConfig, params, tokens, positions=None, caches=None,
                  impl="blockwise"):
    """The trunk: final-normed hidden states [B, S, d] (caches written in
    place)."""
    x = L.embed(cfg, params["embed"], tokens)
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for gi, (pattern, repeats) in enumerate(cfg.groups):
        for r in range(repeats):
            for i, spec in enumerate(pattern):
                c = None if caches is None else _at(caches[f"g{gi}"][i], r)
                x = _block(cfg, spec, _at(params[f"g{gi}"][i], r), x,
                           positions, c, impl)
    return L.norm(cfg, params["final_norm"], x)


def forward(cfg: ModelConfig, params, tokens, positions=None, caches=None,
            impl="blockwise", patches=None, frames=None):
    """tokens [B, S] -> (logits [B, S, V] f32, caches, aux_loss).

    positions: [S] shared (default arange) or [B, S] per row; caches from
    init_caches or None.  The caches are updated in place and returned."""
    if patches is not None or frames is not None:
        raise NotImplementedError(
            "VLM patches and encoder frames are not ported yet (ROADMAP.md "
            "queue A item 8)")
    x = hidden_states(cfg, params, tokens, positions, caches, impl)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.unembed(cfg, params["embed"], x), caches, aux


# ------------------------------------------------------------------ cache

def init_caches(cfg: ModelConfig, batch: int, max_seq: int, device) -> dict:
    """Stacked cache dict aligned with the grouped layer stacks."""
    _check_supported(cfg)
    caches = {}
    for gi, (pattern, repeats) in enumerate(cfg.groups):
        caches[f"g{gi}"] = [
            _stack([_init_cache(cfg, spec, batch, max_seq, device)
                    for _ in range(repeats)])
            for spec in pattern]
    return caches


def _init_cache(cfg, spec: LayerSpec, batch, max_seq, device) -> dict:
    if spec.kind == "attn":
        return A.init_cache(cfg, spec, batch, max_seq, device)
    if spec.kind == "ssd":
        return SSD.init_ssd_cache(cfg, batch, device)
    return R.init_rglru_cache(cfg, batch, device)
