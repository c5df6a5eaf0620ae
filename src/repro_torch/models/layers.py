"""Shared neural-net layers on torch (the port of repro.models.layers).

Params are plain dicts of tensors with the JAX package's shapes
(``wi [d, f]``, ``wo [f, d]``, ``tok [V, d]``), so weights carry across
both packages unchanged.  Every ``init_*`` draws from a
``torch.Generator`` and allocates on that generator's device; on a
generator whose device is ``meta`` (models.lm.param_shapes) it draws
nothing and allocates nothing.  Beside each ``init_*`` its ``*_axes``
gives the JAX package's logical axes of the same tree (a tuple of names
per tensor dim), which models.sharding maps onto a mesh.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def dt(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def tracked(*tensors) -> bool:
    """True when autograd records an op on `tensors`: grad mode is on and
    one of them requires grad.  The serve paths write some large
    temporaries in place to hold their memory peak; under autograd those
    ops run out of place (an in-place write to a tensor that a backward
    saved would fail or give wrong gradients)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


_place = None     # set by drawing_into


def normal(gen: torch.Generator, shape, dtype, scale: float) -> torch.Tensor:
    """N(0, 1) * scale in `dtype`, drawn on the generator's device (inside
    drawing_into(place), written into the tensor place(shape, dtype))."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    x.mul_(scale)
    return x.to(dtype) if _place is None else _place(shape, dtype).copy_(x)


@contextlib.contextmanager
def drawing_into(place):
    """Within the block, normal() writes each draw into place(shape,
    dtype) and returns that tensor, so a caller can draw straight into
    preallocated storage."""
    global _place
    prev, _place = _place, place
    try:
        yield
    finally:
        _place = prev


# ----------------------------------------------------------------- norms

def init_norm(cfg, device) -> dict:
    d = cfg.d_model
    p = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
    return p


def norm_axes(cfg) -> dict:
    a = {"scale": ("embed",)}
    if cfg.norm == "layernorm":
        a["bias"] = ("embed",)
    return a


def norm(cfg, p, x):
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps) * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"]
    return y.to(x.dtype)


# ------------------------------------------------------------ activations

def act_fn(cfg):
    # jax.nn.gelu defaults to the tanh approximation
    if cfg.act == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


# ------------------------------------------------------------------- mlp

def init_mlp(cfg, gen, d_ff=None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"wi": normal(gen, (d, f), dt(cfg), s_in),
         "wo": normal(gen, (f, d), dt(cfg), s_out)}
    if cfg.gated_mlp:
        p["wg"] = normal(gen, (d, f), dt(cfg), s_in)
    return p


def mlp_axes(cfg) -> dict:
    a = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    if cfg.gated_mlp:
        a["wg"] = ("embed", "mlp")
    return a


def mlp(cfg, p, x):
    h = x @ p["wi"]
    if cfg.gated_mlp:
        h = act_fn(cfg)(x @ p["wg"]) * h
    else:
        h = act_fn(cfg)(h)
    return h @ p["wo"]


# ------------------------------------------------------------- embedding

def init_embed(cfg, gen) -> dict:
    v, d = cfg.padded_vocab, cfg.d_model
    p = {"tok": normal(gen, (v, d), torch.float32, 0.02)}
    if not cfg.tie_embeddings:
        p["out"] = normal(gen, (d, v), torch.float32, 0.02)
    return p


def embed_axes(cfg) -> dict:
    a = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        a["out"] = ("embed", "vocab")
    return a


def embed(cfg, p, tokens):
    # rows first, then the cast: the same values as the JAX package's
    # take(tok.astype(dt)), without casting the whole table per call.  A
    # lookup (not an index) so that DTensor shards it and its backward by
    # the tokens' placement (the dry run's collective count)
    x = torch.nn.functional.embedding(tokens.long(), p["tok"]).to(dt(cfg))
    if cfg.embed_scale:
        # sqrt(d) rounded to the dtype first, as the JAX package does; a
        # Python scalar, so no host-to-device copy
        x = x * float(torch.tensor(np.sqrt(cfg.d_model), dtype=dt(cfg)))
    if cfg.embed_multiplier != 1.0:
        x = x * cfg.embed_multiplier
    return x


def unembed(cfg, p, x):
    w = p["out"] if "out" in p else p["tok"].T
    logits = x.float() @ w.float()
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits


# ------------------------------------------------------------------ rope

@functools.lru_cache(maxsize=None)
def _rope_freq(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """The frequencies in numpy float32, exactly as the JAX package builds
    them, copied to `device` once: a pageable host-to-device copy per
    call would wait for the device twice per layer."""
    freq = theta ** (-np.arange(0, half, dtype=np.float32) / half)
    return torch.from_numpy(np.ascontiguousarray(freq)).to(device)


def rope(x, positions, theta: float):
    """x: [..., S, H, dh]; positions: [..., S] int."""
    half = x.shape[-1] // 2
    freq = _rope_freq(half, theta, x.device)
    # [..., S, 1, half]: broadcast over the head dim
    ang = positions[..., :, None, None].float() * freq
    x1, x2 = x[..., :half], x[..., half:]
    c, s = torch.cos(ang), torch.sin(ang)
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------- conv1d

def init_conv1d(gen, width: int, channels: int) -> dict:
    return {"w": normal(gen, (width, channels), torch.float32, 0.1),
            "b": torch.zeros(channels, dtype=torch.float32, device=gen.device)}


def conv1d_axes() -> dict:
    return {"w": (None, "mlp"), "b": ("mlp",)}


def causal_conv1d(p, x, state=None):
    """Depthwise causal conv.  x: [B, S, C]; state: [B, width-1, C]
    trailing context (decode / prefill over a cache) or None (zeros).
    Returns (y, new_state): the JAX package's shifted sum over the taps in
    tap order, in x's dtype, so a bf16 run rounds as it does."""
    w = p["w"].to(x.dtype)  # [W, C]
    width = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], width - 1) + tuple(x.shape[2:]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, S+W-1, C]
    S = x.shape[1]
    y = xp[:, 0:S] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + S] * w[i]
    y = y + p["b"].to(x.dtype)
    new_state = xp[:, -(width - 1):] if width > 1 else pad
    return y, new_state


def softplus(x):
    """jax.nn.softplus: logaddexp(x, 0) at every x (F.softplus returns x
    itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))
