"""Model assembly on torch: the decoder LM of repro.models.lm for the
dense, SSD, RG-LRU, MoE and MLA families.

Parameters are a plain dict with the JAX package's layout: ``embed``
(``tok [V, d]`` f32, ``out`` when untied), ``g{i}`` for each
``(pattern, repeats)`` group — a list over the pattern's positions of
dicts whose tensors are stacked ``[repeats, ...]`` — and ``final_norm``.
The layer loop is a Python loop over groups, repeats and positions (the
JAX package's lax.scan); each layer reads views ``[r]`` of the stacks.
With ``cfg.mtp`` the tree also holds ``mtp`` (``proj``, an unstacked
dense ``block`` and ``norm``), the multi-token-prediction head.
Caches have the same stacked layout and are written in place: ``k``/``v``
for attention, ``c`` (the latent) for MLA, ``conv``/``state`` for SSD,
``conv``/``h`` for RG-LRU (``RECURRENT_LEAVES`` are the ones a new
sequence must start from zero).

Covered: dense GQA stacks (llama / starcoder2 / granite), local:global
patterns (gemma3), SSD stacks (mamba2), RG-LRU with local attention
(recurrentgemma), MoE layers (mixtral) and MLA with MoE, a shared expert
and the MTP head (deepseek-v3).  The VLM prefix, the encoder and its
cross-attention raise ``NotImplementedError`` (ROADMAP.md queue A item 8).

``from_jax_params`` carries the JAX package's ``init_params`` tree (as
numpy) across, bf16 leaves included, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssd as SSD
from repro_torch.models.config import LayerSpec, ModelConfig

KINDS = ("attn", "ssd", "rglru")
MLPS = ("dense", "moe", "none")
# the MTP head's block (the JAX package's lm.mtp_logits)
MTP_SPEC = LayerSpec(kind="attn", window=None, mlp="dense")
RECURRENT_LEAVES = ("conv", "state", "h")


def _check_supported(cfg: ModelConfig):
    missing = []
    if cfg.attn_impl not in ("gqa", "mla"):
        missing.append(f"attn_impl={cfg.attn_impl}")
    if cfg.encoder is not None:
        missing.append("encoder")
    if cfg.vlm_patches:
        missing.append("vlm_patches")
    for pattern, _ in cfg.groups:
        for spec in pattern:
            if spec.kind not in KINDS or spec.mlp not in MLPS \
                    or spec.cross_attn:
                missing.append(f"{spec}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {sorted(set(missing))} not ported yet (the port has "
            f"dense GQA, MLA, SSD, RG-LRU, MoE and MTP; the VLM prefix and the "
            f"encoder are ROADMAP.md queue A item 8)")


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
    elif spec.mlp == "moe":
        p["norm_mlp"] = L.init_norm(cfg, gen.device)
        p["moe"] = M.init_moe(cfg, gen)
    return p


def _stack(layers: list) -> dict:
    if isinstance(layers[0], dict):
        return {k: _stack([l[k] for l in layers]) for k in layers[0]}
    return torch.stack(layers)


def _init_stack(cfg, spec: LayerSpec, gen, repeats: int, device) -> dict:
    """`repeats` layers drawn one after another into ``[repeats, ...]``
    stacks on `device`.  Every normal() draw goes straight into its row
    (the generator's order is that of drawing the layers one by one), so
    no layer is held beside the stack (a deepseek-v3 MoE layer is 23 GB
    in bf16); the few other leaves (norm scales) are copied in."""
    drawn = []      # the stack of each normal() draw, in the order drawn
    stack = None
    for r in range(repeats):
        rows = iter(drawn)

        def place(shape, dtype):
            if r == 0:
                drawn.append(torch.empty((repeats, *shape), dtype=dtype,
                                         device=device))
                return drawn[-1][0]
            return next(rows)[r]

        with L.drawing_into(place):
            layer = _init_layer(cfg, spec, gen)
        if stack is None:
            own = {t.data_ptr(): t for t in drawn}
            stack = _map(layer, lambda t: own[t.data_ptr()] if t.data_ptr()
                         in own else t.new_empty((repeats, *t.shape),
                                                 device=device))
        _copy_row(stack, layer, r)
    return stack


def _copy_row(stack: dict, layer: dict, r: int) -> None:
    for k, v in layer.items():
        if isinstance(v, dict):
            _copy_row(stack[k], v, r)
        elif stack[k][r].data_ptr() != v.data_ptr():   # not drawn in place
            stack[k][r].copy_(v)


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random parameters drawn from `generator` (on its own device) and
    placed on `device`.  The numbers differ from the JAX package's
    (another generator); carry those with from_jax_params."""
    _check_supported(cfg)
    p = {"embed": L.init_embed(cfg, generator)}
    for gi, (pattern, repeats) in enumerate(cfg.groups):
        p[f"g{gi}"] = [_init_stack(cfg, spec, generator, repeats, device)
                       for spec in pattern]
    p["final_norm"] = L.init_norm(cfg, generator.device)
    if cfg.mtp:
        p["mtp"] = {"proj": L.normal(generator, (2 * cfg.d_model, cfg.d_model),
                                     L.dt(cfg), 0.01),
                    "block": _init_layer(cfg, MTP_SPEC, generator),
                    "norm": L.init_norm(cfg, generator.device)}
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
    """One layer; returns (x, the MoE aux loss or None)."""
    h = L.norm(cfg, p["norm_in"], x)
    if spec.kind == "attn":
        mix, cache = A.attn_forward(cfg, spec, p["mix"], h, positions, cache,
                                    impl)
    elif spec.kind == "ssd":
        mix, cache = SSD.ssd_forward(cfg, p["mix"], h, cache)
    else:
        mix, cache = R.rglru_forward(cfg, p["mix"], h, cache)
    # the residual stream stays in cfg.dtype (attention and the MoE
    # upcast to f32)
    x = x + mix.to(x.dtype)
    aux = None
    if spec.mlp == "dense":
        x = x + L.mlp(cfg, p["mlp"], L.norm(cfg, p["norm_mlp"], x)).to(x.dtype)
    elif spec.mlp == "moe":
        y, aux = M.moe_forward(cfg, p["moe"], L.norm(cfg, p["norm_mlp"], x))
        x = x + y.to(x.dtype)
    return x, aux


def hidden_states(cfg: ModelConfig, params, tokens, positions=None, caches=None,
                  impl="blockwise"):
    """The trunk: (final-normed hidden states [B, S, d], the sum of the
    MoE layers' aux losses, f32); caches are written in place."""
    x = L.embed(cfg, params["embed"], tokens)
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, (pattern, repeats) in enumerate(cfg.groups):
        for r in range(repeats):
            for i, spec in enumerate(pattern):
                c = None if caches is None else _at(caches[f"g{gi}"][i], r)
                x, a = _block(cfg, spec, _at(params[f"g{gi}"][i], r), x,
                              positions, c, impl)
                if a is not None:
                    aux = aux + a
    return L.norm(cfg, params["final_norm"], x), aux


def forward(cfg: ModelConfig, params, tokens, positions=None, caches=None,
            impl="blockwise", patches=None, frames=None, return_hidden=False):
    """tokens [B, S] -> (logits [B, S, V] f32, caches, aux_loss[, hidden]).

    positions: [S] shared (default arange) or [B, S] per row; caches from
    init_caches or None.  The caches are updated in place and returned.
    return_hidden: also return the final-normed hidden states (the MTP
    head's input)."""
    if patches is not None or frames is not None:
        raise NotImplementedError(
            "VLM patches and encoder frames are not ported yet (ROADMAP.md "
            "queue A item 8)")
    x, aux = hidden_states(cfg, params, tokens, positions, caches, impl)
    logits = L.unembed(cfg, params["embed"], x)
    if return_hidden:
        return logits, caches, aux, x
    return logits, caches, aux


def mtp_logits(cfg: ModelConfig, params, h, next_embeds, positions,
               impl="naive"):
    """DeepSeek-V3 multi-token prediction: the logits of token t+2 from the
    trunk's hidden state at t beside the embedding of token t+1.  (Its
    loss leg waits for the train step, ROADMAP.md queue A item 9.)"""
    z = torch.cat([h, next_embeds.to(h.dtype)], dim=-1) @ params["mtp"]["proj"]
    z, _ = _block(cfg, MTP_SPEC, params["mtp"]["block"], z, positions, None,
                  impl)
    z = L.norm(cfg, params["mtp"]["norm"], z)
    return L.unembed(cfg, params["embed"], z)


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
