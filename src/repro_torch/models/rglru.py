"""RG-LRU recurrent block on torch (the port of repro.models.rglru;
RecurrentGemma / Griffin, arXiv:2402.19427).

Block: x -> (gate branch: linear + tanh-GeLU) * (recurrent branch:
linear -> causal conv -> RG-LRU) -> out projection.  The recurrence, in
f32:

    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Decode (S == 1 with a cache) is the O(1) step.  A prefill runs the linear
recurrence chunk by chunk (``linear_scan``) where the JAX package runs an
associative scan; both reassociate the same products, so the two agree to
f32 rounding, not bit for bit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

_C = 8.0
SCAN_CHUNK = 64


def init_rglru(cfg, gen) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    dev = gen.device
    s, sw = 1.0 / math.sqrt(d), 1.0 / math.sqrt(w)
    zeros = lambda: torch.zeros(w, dtype=torch.float32, device=dev)
    return {
        "in_x": L.normal(gen, (d, w), L.dt(cfg), s),
        "in_gate": L.normal(gen, (d, w), L.dt(cfg), s),
        "conv": L.init_conv1d(gen, cfg.conv_width, w),
        "wa": L.normal(gen, (w, w), torch.float32, sw),
        "ba": zeros(),
        "wx": L.normal(gen, (w, w), torch.float32, sw),
        "bx": zeros(),
        "lam": torch.ones(w, dtype=torch.float32, device=dev),
        "out": L.normal(gen, (w, d), L.dt(cfg), sw),
    }


def rglru_axes() -> dict:
    """init_rglru's logical axes."""
    return {"in_x": ("embed", "mlp"), "in_gate": ("embed", "mlp"),
            "conv": L.conv1d_axes(), "wa": ("mlp", None), "ba": ("mlp",),
            "wx": ("mlp", None), "bx": ("mlp",), "lam": ("mlp",),
            "out": ("mlp", "embed")}


def linear_scan(a, b, h0, chunk: int = SCAN_CHUNK):
    """h_t = a_t h_{t-1} + b_t over axis 1 of a, b [B, S, w] (f32), from
    h0 [B, w]; returns every h_t [B, S, w].

    The sequence is cut into chunks of `chunk` steps.  One loop over the
    steps of a chunk runs every chunk at once from a zero start, keeping
    the running product of a (both stay in (0, 1] times the inputs: no
    exp of a long cumsum of log a, which would leave f32's range within
    a few hundred steps); one loop over the chunks then carries the state
    from chunk end to chunk end, and each chunk adds its start state
    times the running product."""
    B, S, w = a.shape
    T = min(chunk, S)
    nc = -(-S // T)
    pad = nc * T - S
    if pad:   # a = 1, b = 0 past the end: the state passes through
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
    a = a.reshape(B, nc, T, w)
    b = b.reshape(B, nc, T, w)
    if L.tracked(a, b, h0):
        # the same products out of place: autograd saves each step's input
        locs, prods = [b[:, :, 0]], [a[:, :, 0]]
        for t in range(1, T):
            locs.append(a[:, :, t] * locs[-1] + b[:, :, t])
            prods.append(a[:, :, t] * prods[-1])
        loc, prod = torch.stack(locs, 2), torch.stack(prods, 2)
        starts, h = [], h0
        for c in range(nc):
            starts.append(h)
            h = prod[:, c, -1] * h + loc[:, c, -1]
        hs = loc + prod * torch.stack(starts, 1)[:, :, None]
        return hs.reshape(B, nc * T, w)[:, :S]
    loc = torch.empty_like(b)       # the scan of each chunk from zero
    prod = torch.empty_like(a)      # a's running product within the chunk
    loc[:, :, 0], prod[:, :, 0] = b[:, :, 0], a[:, :, 0]
    for t in range(1, T):
        loc[:, :, t] = a[:, :, t] * loc[:, :, t - 1] + b[:, :, t]
        prod[:, :, t] = a[:, :, t] * prod[:, :, t - 1]
    start = torch.empty((B, nc, w), dtype=a.dtype, device=a.device)
    h = h0
    for c in range(nc):
        start[:, c] = h
        h = prod[:, c, -1] * h + loc[:, c, -1]
    hs = loc.add_(prod.mul_(start[:, :, None]))
    return hs.reshape(B, nc * T, w)[:, :S]


def rglru_forward(cfg, p, u, cache=None):
    """u: [B, S, d]; cache: None or dict(conv [B,W-1,w], h [B,w] f32, pos),
    updated in place.  Returns (y [B, S, d], cache)."""
    B, S, d = u.shape
    gate = F.gelu(u @ p["in_gate"], approximate="tanh")   # jax.nn.gelu's default
    x = u @ p["in_x"]
    conv_state = cache["conv"] if cache is not None else None
    x, new_conv = L.causal_conv1d(p["conv"], x, conv_state)

    xf = x.float()
    r = torch.sigmoid(xf @ p["wa"] + p["ba"])
    i = torch.sigmoid(xf @ p["wx"] + p["bx"])
    log_a = -_C * L.softplus(p["lam"]) * r                # [B,S,w], < 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) * (i * xf)
    del r, i, log_a

    h0 = (cache["h"] if cache is not None else
          torch.zeros((B, x.shape[-1]), dtype=torch.float32, device=u.device))
    if cache is not None and S == 1:
        hs = (a[:, 0] * h0 + b[:, 0])[:, None]
    else:
        hs = linear_scan(a, b, h0)
    y = (hs * gate.float()).to(u.dtype) @ p["out"]
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(hs[:, -1])
        cache["pos"].add_(S)
    return y, cache


def init_rglru_cache(cfg, batch: int, device) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, w),
                                dtype=L.dt(cfg), device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}
