"""Model assembly on torch: the decoder LM of repro.models.lm for all
ten of its archs.

Parameters are a plain dict with the JAX package's layout: ``embed``
(``tok [V, d]`` f32, ``out`` when untied), ``g{i}`` for each
``(pattern, repeats)`` group — a list over the pattern's positions of
dicts whose tensors are stacked ``[repeats, ...]`` — and ``final_norm``.
The layer loop is a Python loop over groups, repeats and positions (the
JAX package's lax.scan); each layer reads views ``[r]`` of the stacks.
With ``cfg.mtp`` the tree also holds ``mtp`` (``proj``, an unstacked
dense ``block`` and ``norm``), the multi-token-prediction head; with
``cfg.encoder`` it holds ``encoder`` (stacked ``layers`` and ``norm``),
and each cross-attention layer's ``mix`` holds ``xq``/``xk``/``xv``/``xo``
and ``xnorm``.
Caches have the same stacked layout and are written in place: ``k``/``v``
for attention, ``c`` (the latent) for MLA, ``conv``/``state`` for SSD,
``conv``/``h`` for RG-LRU (``RECURRENT_LEAVES`` are the ones a new
sequence must start from zero), ``xk``/``xv`` (the cross-attention's K/V
over the encoder output, written by the prefill, read by decode).

Covered: dense GQA stacks (llama / starcoder2 / granite), local:global
patterns (gemma3), SSD stacks (mamba2), RG-LRU with local attention
(recurrentgemma), MoE layers (mixtral), MLA with MoE, a shared expert
and the MTP head (deepseek-v3), the encoder and cross-attention over
stub frame embeddings (whisper: ``frames`` [B, T, d], or ``enc_out``)
and the VLM prefix of stub patch embeddings (paligemma: ``patches``
[B, P, d] ahead of the tokens, attended bidirectionally).  As in the JAX
package, the encoder applies RoPE to its q/k (whisper's published model
has sinusoidal embeddings); a prefix puts the patches at positions
0..P-1, so a decode cache must hold P + prompt + new tokens (the JAX
launcher sizes it without P; launch/serve.py says what that costs).

``from_jax_params`` carries the JAX package's ``init_params`` tree (as
numpy) across, bf16 leaves included, bit for bit.  ``param_shapes`` is
the same tree on the ``meta`` device (no draw, no allocation: the port's
``jax.eval_shape`` of the init) and ``param_axes`` its logical axes
(models.sharding), built beside the init by the ``*_axes`` of each
layer module, with ``"stack"`` ahead of a stacked layer's axes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import sharding as sh
from repro_torch.models import ssd as SSD
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.pytree import tree_map

KINDS = ("attn", "ssd", "rglru")
MLPS = ("dense", "moe", "none")
# the MTP head's block (the JAX package's lm.mtp_logits) and an encoder
# layer (lm.encode)
MTP_SPEC = ENC_SPEC = LayerSpec(kind="attn", window=None, mlp="dense")
RECURRENT_LEAVES = ("conv", "state", "h")


def _check_supported(cfg: ModelConfig):
    missing = []
    if cfg.attn_impl not in ("gqa", "mla"):
        missing.append(f"attn_impl={cfg.attn_impl}")
    for pattern, _ in cfg.groups:
        for spec in pattern:
            if spec.kind not in KINDS or spec.mlp not in MLPS \
                    or (spec.cross_attn and cfg.encoder is None):
                missing.append(f"{spec}")
    if missing:
        raise ValueError(
            f"{cfg.name}: {sorted(set(missing))} is not an LM of the JAX "
            f"package (attention gqa / mla, mixers {KINDS}, MLPs {MLPS}, "
            f"cross-attention only with an encoder)")


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


def _layer_axes(cfg, spec: LayerSpec) -> dict:
    """_init_layer's logical axes."""
    a = {"norm_in": L.norm_axes(cfg)}
    if spec.kind == "attn":
        a["mix"] = A.attn_axes(cfg, spec)
    elif spec.kind == "ssd":
        a["mix"] = SSD.ssd_axes(cfg)
    else:
        a["mix"] = R.rglru_axes()
    if spec.mlp == "dense":
        a["norm_mlp"], a["mlp"] = L.norm_axes(cfg), L.mlp_axes(cfg)
    elif spec.mlp == "moe":
        a["norm_mlp"], a["moe"] = L.norm_axes(cfg), M.moe_axes(cfg)
    return a


def _stack_axes(a: dict) -> dict:
    return tree_map(lambda t: ("stack",) + t, a, is_leaf=sh.is_axes)


def _stack(layers: list) -> dict:
    if isinstance(layers[0], dict):
        return {k: _stack([l[k] for l in layers]) for k in layers[0]}
    return torch.stack(layers)


def _init_stack(cfg, spec: LayerSpec, gen, repeats: int, device) -> dict:
    """`repeats` layers drawn one after another into ``[repeats, ...]``
    stacks on `device`.  Every normal() draw goes straight into its row
    (the generator's order is that of drawing the layers one by one), so
    no layer is held beside the stack (a deepseek-v3 MoE layer is 23 GB
    in bf16); the few other leaves (norm scales) are copied in.  On the
    meta device nothing is drawn: the stacks are empty meta tensors."""
    if torch.device(device).type == "meta":
        layer = _init_layer(cfg, spec, gen)
        return tree_map(lambda t: t.new_empty((repeats, *t.shape)), layer)
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
            stack = tree_map(lambda t: own[t.data_ptr()] if t.data_ptr()
                             in own else t.new_empty((repeats, *t.shape),
                                                     device=device), layer)
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
    if cfg.encoder is not None:
        p["encoder"] = {"layers": _init_stack(cfg, ENC_SPEC, generator,
                                              cfg.encoder.n_layers, device),
                        "norm": L.init_norm(cfg, generator.device)}
    if cfg.mtp:
        p["mtp"] = {"proj": L.normal(generator, (2 * cfg.d_model, cfg.d_model),
                                     L.dt(cfg), 0.01),
                    "block": _init_layer(cfg, MTP_SPEC, generator),
                    "norm": L.init_norm(cfg, generator.device)}
    return tree_map(lambda t: t.to(device), p)


class _MetaGenerator:
    """Stands where a torch.Generator does in init_params: layers.normal
    draws nothing on its device and returns an empty meta tensor."""
    device = torch.device("meta")


def param_shapes(cfg: ModelConfig) -> dict:
    """init_params' tree on the meta device: every leaf's shape and
    dtype, nothing drawn or allocated (deepseek-v3-671b's 671e9
    parameters included)."""
    return init_params(cfg, _MetaGenerator(), "meta")


def param_axes(cfg: ModelConfig) -> dict:
    """Logical-axes tree matching init_params' structure: a tuple of
    names per leaf (models.sharding maps them onto a mesh)."""
    _check_supported(cfg)
    a = {"embed": L.embed_axes(cfg)}
    for gi, (pattern, _) in enumerate(cfg.groups):
        a[f"g{gi}"] = [_stack_axes(_layer_axes(cfg, spec)) for spec in pattern]
    a["final_norm"] = L.norm_axes(cfg)
    if cfg.encoder is not None:
        a["encoder"] = {"layers": _stack_axes(_layer_axes(cfg, ENC_SPEC)),
                        "norm": L.norm_axes(cfg)}
    if cfg.mtp:
        a["mtp"] = {"proj": ("embed", "embed"),
                    "block": _layer_axes(cfg, MTP_SPEC),
                    "norm": L.norm_axes(cfg)}
    return a


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
    return tree_map(lambda a: _leaf_from_numpy(a, device), tree)


def _at(tree, r: int):
    """The views [r] of a stacked layer dict."""
    return {k: _at(v, r) if isinstance(v, dict) else v[r] for k, v in tree.items()}


def _layers(tree, n: int) -> list:
    """The n layer dicts of a stacked layer dict, as views: one unbind a
    leaf, whose backward stacks the n layers' gradients once (a view
    [r] a layer would add a whole stack of zeros to each leaf's gradient
    per layer)."""
    rows = {k: _layers(v, n) if isinstance(v, dict) else torch.unbind(v)
            for k, v in tree.items()}
    return [{k: v[r] for k, v in rows.items()} for r in range(n)]


# ------------------------------------------------------------------ block

def _block(cfg, spec: LayerSpec, p, x, positions, cache, impl, enc_out=None,
           extend=False):
    """One layer; returns (x, the MoE aux loss or None).  Each branch is
    scaled by cfg.residual_multiplier before it joins the stream."""
    h = L.norm(cfg, p["norm_in"], x)
    if spec.kind == "attn":
        mix, cache = A.attn_forward(cfg, spec, p["mix"], h, positions, cache,
                                    impl, extend=extend)
        if spec.cross_attn:
            mix = mix + _cross(cfg, p["mix"], x, cache, enc_out, impl)
    elif spec.kind == "ssd":
        mix, cache = SSD.ssd_forward(cfg, p["mix"], h, cache)
    else:
        mix, cache = R.rglru_forward(cfg, p["mix"], h, cache)
    # the residual stream stays in cfg.dtype (attention and the MoE
    # upcast to f32)
    x = sh.constrain(x + _branch(cfg, mix, x.dtype), ("batch", "seq", "embed"))
    aux = None
    if spec.mlp == "dense":
        x = x + _branch(cfg, L.mlp(cfg, p["mlp"], L.norm(cfg, p["norm_mlp"], x)),
                        x.dtype)
    elif spec.mlp == "moe":
        y, aux = M.moe_forward(cfg, p["moe"], L.norm(cfg, p["norm_mlp"], x))
        x = x + _branch(cfg, y, x.dtype)
    return sh.constrain(x, ("batch", "seq", "embed")), aux


def _branch(cfg, y, dtype):
    """A residual branch's output as it joins the stream."""
    if cfg.residual_multiplier != 1.0:
        y = y * cfg.residual_multiplier
    return y.to(dtype)


def _cross(cfg, p, x, cache, enc_out, impl):
    """A decoder layer's cross-attention over the encoder output: its K/V
    projected from enc_out (a prefill or a forward, stored in the cache
    when there is one) or read from the cache (decode).  Normed by
    ``xnorm`` from the block's input x, as the JAX package does."""
    if enc_out is not None:
        kv = A.encode_cross_kv(cfg, p, enc_out)
        if cache is not None:
            cache["xk"].copy_(kv[0])
            cache["xv"].copy_(kv[1])
    elif cache is not None:
        kv = (cache["xk"], cache["xv"])
    else:
        raise ValueError(f"{cfg.name}: cross-attention needs frames, enc_out "
                         f"or a cache that a prefill with frames wrote")
    return A.cross_attn_forward(cfg, p, L.norm(cfg, p["xnorm"], x), kv, impl)


def encode(cfg: ModelConfig, params, frames, impl="blockwise"):
    """The whisper encoder over stub frame embeddings [B, T, d]: layers of
    non-causal self-attention (RoPE on q/k, as the JAX package does) and
    a dense MLP, then the encoder's norm; [B, T, d] in cfg.dtype."""
    T = frames.shape[1]
    positions = torch.arange(T, dtype=torch.int32, device=frames.device)
    x = frames.to(L.dt(cfg))
    for p in _layers(params["encoder"]["layers"], cfg.encoder.n_layers):
        h = L.norm(cfg, p["norm_in"], x)
        x = x + A.encoder_attn_forward(cfg, p["mix"], h, positions,
                                       impl).to(x.dtype)
        x = x + L.mlp(cfg, p["mlp"], L.norm(cfg, p["norm_mlp"], x)).to(x.dtype)
    return L.norm(cfg, params["encoder"]["norm"], x)


def hidden_states(cfg: ModelConfig, params, tokens, positions=None, caches=None,
                  impl="blockwise", patches=None, frames=None, enc_out=None,
                  extend=False):
    """The trunk: (final-normed hidden states [B, P + S, d], the sum of
    the MoE layers' aux losses, f32); caches are written in place.

    patches: [B, P, d] stub patch embeddings put ahead of the scaled
    token embeddings (paligemma); frames: [B, T, d] stub frame embeddings
    the encoder runs over, or enc_out, its output (whisper).
    extend: the caches already hold every position before `positions`
    (a sequence's earlier tokens), and the tokens continue it: attention
    reads the cached keys too (a prefill without it attends only over its
    own tokens), and the recurrent layers start from their cached state
    (as they always do)."""
    x = L.embed(cfg, params["embed"], tokens)
    if patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x = sh.constrain(x, ("batch", "seq", "embed"))
    if cfg.encoder is not None and enc_out is None and frames is not None:
        enc_out = encode(cfg, params, frames, impl)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, (pattern, repeats) in enumerate(cfg.groups):
        layers = [_layers(stack, repeats) for stack in params[f"g{gi}"]]
        for r in range(repeats):
            for i, spec in enumerate(pattern):
                c = None if caches is None else _at(caches[f"g{gi}"][i], r)
                x, a = _block(cfg, spec, layers[i][r], x, positions, c, impl,
                              enc_out, extend)
                if a is not None:
                    aux = aux + a
    return L.norm(cfg, params["final_norm"], x), aux


def forward(cfg: ModelConfig, params, tokens, positions=None, caches=None,
            impl="blockwise", patches=None, frames=None, enc_out=None,
            return_hidden=False):
    """tokens [B, S] -> (logits [B, P + S, V] f32, caches, aux_loss[,
    hidden]).

    positions: [P + S] shared (default arange) or [B, P + S] per row;
    caches from init_caches or None.  The caches are updated in place and
    returned.  patches / frames / enc_out: see hidden_states.
    return_hidden: also return the final-normed hidden states (the MTP
    head's input)."""
    x, aux = hidden_states(cfg, params, tokens, positions, caches, impl,
                           patches, frames, enc_out)
    logits = sh.constrain(L.unembed(cfg, params["embed"], x),
                          ("batch", "seq", "vocab"))
    if return_hidden:
        return logits, caches, aux, x
    return logits, caches, aux


def mtp_logits(cfg: ModelConfig, params, h, next_embeds, positions,
               impl="naive"):
    """DeepSeek-V3 multi-token prediction: the logits of token t+2 from the
    trunk's hidden state at t beside the embedding of token t+1.  (Its
    loss leg is ``0.3 * mtp_nll`` in models/steps.loss_fn.)"""
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
        c = A.init_cache(cfg, spec, batch, max_seq, device)
        if spec.cross_attn:
            shape = (batch, cfg.encoder.n_frames, cfg.n_kv_heads, cfg.head_dim)
            c["xk"] = torch.zeros(shape, dtype=L.dt(cfg), device=device)
            c["xv"] = torch.zeros(shape, dtype=L.dt(cfg), device=device)
        return c
    if spec.kind == "ssd":
        return SSD.init_ssd_cache(cfg, batch, device)
    return R.init_rglru_cache(cfg, batch, device)
