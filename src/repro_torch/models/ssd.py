"""Mamba-2 SSD (state-space duality) block on torch (the port of
repro.models.ssd) [arXiv:2405.21060].

Prefill runs the chunked SSD algorithm: a within-chunk quadratic
(attention-like) term plus a linear recurrence over chunk states, the
recurrence a Python loop over the chunks (the JAX package's lax.scan).
Decode (S == 1 with a cache) is the O(1) recurrent step on a
``[B, H, P, N]`` f32 state.  SiLU comes before the conv and dt, decay and
state math is f32, as in the JAX package.  With ``cfg.ssd_block ==
"mamba2"`` the block is the published one instead: the conv (with its
bias) comes first and SiLU after it, and ``y * silu(z)`` goes through a
gated RMSNorm (over all of d_inner: one group) with a learned weight
``norm`` before out_proj.  A prefill over a cache that holds a
sequence's state (its conv tail and SSD state) continues that sequence:
the chunked scan starts from the cached state.

The JAX package's four-operand einsums are contracted pairwise here, the
last step of each a batched matmul, so nothing of shape ``[B, c, i, j, H,
P]`` is ever formed: the largest tensor a layer forms is one ``[B, c,
H, i, j]`` f32 tensor (2.7 GB at B=16, S=2048 over mamba2-2.7b's 80
heads), built and masked in place.  A cache is written in place and returned.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def init_ssd(cfg, gen) -> dict:
    d = cfg.d_model
    di, ns, nh = cfg.ssd_d_inner, cfg.ssd_state, cfg.ssd_n_heads
    dev = gen.device
    p = {
        "in_proj": L.normal(gen, (d, 2 * di + 2 * ns + nh), L.dt(cfg),
                            1.0 / math.sqrt(d)),
        "conv": L.init_conv1d(gen, cfg.conv_width, di + 2 * ns),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "dt_bias": torch.zeros(nh, dtype=torch.float32, device=dev),
        "D": torch.ones(nh, dtype=torch.float32, device=dev),
        "out_proj": L.normal(gen, (di, d), L.dt(cfg), 1.0 / math.sqrt(di)),
    }
    if cfg.ssd_block == "mamba2":
        p["norm"] = torch.ones(di, dtype=torch.float32, device=dev)
    return p


def ssd_axes(cfg) -> dict:
    """init_ssd's logical axes."""
    a = {"in_proj": ("embed", "mlp"), "conv": L.conv1d_axes(),
         "A_log": (None,), "dt_bias": (None,), "D": (None,),
         "out_proj": ("mlp", "embed")}
    if cfg.ssd_block == "mamba2":
        a["norm"] = ("mlp",)
    return a


def _split(cfg, zxbcdt):
    di, ns = cfg.ssd_d_inner, cfg.ssd_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * ns],
            zxbcdt[..., 2 * di + 2 * ns:])


def _gate(cfg, p, y, z, dtype):
    """y * silu(z) in f32 and, in the published block, its gated RMSNorm
    times the learned weight; cast to `dtype`."""
    y = y * F.silu(z.float())
    if cfg.ssd_block == "mamba2":
        ms = y.square().mean(-1, keepdim=True)
        y = y * torch.rsqrt(ms + cfg.norm_eps) * p["norm"]
    return y.to(dtype)


def ssd_forward(cfg, p, u, cache=None):
    """u: [B, S, d].  cache: None or dict(conv [B,W-1,C], state [B,H,P,N]
    f32, pos), updated in place.  Returns (y [B, S, d], cache)."""
    B, S, d = u.shape
    di, ns, nh, hp = (cfg.ssd_d_inner, cfg.ssd_state, cfg.ssd_n_heads,
                      cfg.ssd_headdim)
    z, xbc, dt_raw = _split(cfg, u @ p["in_proj"])
    conv_state = cache["conv"] if cache is not None else None
    if cfg.ssd_block == "mamba2":
        xbc, new_conv = L.causal_conv1d(p["conv"], xbc, conv_state)
        xbc = F.silu(xbc)
    else:
        xbc, new_conv = L.causal_conv1d(p["conv"], F.silu(xbc), conv_state)
    x, Bm, Cm = xbc[..., :di], xbc[..., di:di + ns], xbc[..., di + ns:]
    dt = L.softplus(dt_raw.float() + p["dt_bias"])                  # [B,S,H]
    A = -torch.exp(p["A_log"])                                       # [H]
    xh = x.reshape(B, S, nh, hp)

    if cache is not None and S == 1:
        # ---- recurrent decode step ----
        a_t = torch.exp(dt[:, 0] * A)                                # [B,H]
        dBx = ((dt[:, 0, :, None] * xh[:, 0].float())[..., None]
               * Bm[:, 0].float()[:, None, None, :])                 # [B,H,P,N]
        st = cache["state"] * a_t[:, :, None, None] + dBx
        y = (st @ Cm[:, 0].float()[:, None, :, None])[..., 0]        # [B,H,P]
        y = y + p["D"][None, :, None] * xh[:, 0].float()
        y = _gate(cfg, p, y.reshape(B, 1, di), z, u.dtype)
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(st)
        cache["pos"].add_(1)
        return y @ p["out_proj"], cache

    # ---- chunked SSD scan (prefill / no cache) ----
    ck = min(cfg.ssd_chunk, max(S, 1))
    nchunk = -(-S // ck)
    pad = nchunk * ck - S
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    xc = xh.reshape(B, nchunk, ck, nh, hp).float()
    Bc = Bm.reshape(B, nchunk, ck, ns).float()
    Cc = Cm.reshape(B, nchunk, ck, ns).float()
    dtc = dt.reshape(B, nchunk, ck, nh)

    seg = torch.cumsum(dtc * A, dim=2)       # within-chunk cumsum of log a
    segT = seg.transpose(2, 3)                                       # [B,c,H,l]
    # intra-chunk: y_i = sum_{j<=i} (C_i.B_j) exp(seg_i - seg_j) dt_j x_j,
    # built as W [B,c,H,i,j] (in place unless autograd records it), then
    # W @ x over j.  j > i is masked to -inf before the exp: there seg_i -
    # seg_j > 0 overflows to inf within a chunk, and the JAX package's
    # exp-then-mask, which gives the same forward, backpropagates 0 * inf
    # = NaN into every gradient under the SSD layer (ROADMAP.md queue C)
    W = segT[..., :, None] - segT[..., None, :]
    upper = ~torch.ones(ck, ck, dtype=torch.bool, device=u.device).tril()
    CB = (Cc @ Bc.transpose(2, 3))[:, :, None]                       # C_i.B_j
    dtj = dtc.transpose(2, 3)[:, :, :, None, :]                      # dt_j
    if L.tracked(W, CB, dtj):
        W = torch.exp(W.masked_fill(upper, -math.inf)) * CB * dtj
    else:
        W.masked_fill_(upper, -math.inf).exp_()
        W.mul_(CB)
        W.mul_(dtj)
    del CB
    xcT = xc.permute(0, 1, 3, 2, 4)                                  # [B,c,H,l,P]
    y = (W @ xcT).permute(0, 1, 3, 2, 4)                             # [B,c,l,H,P]
    del W

    # chunk states: S_c = sum_l exp(seg_last - seg_l) dt_l x_l B_l^T,
    # one product over l per (batch, chunk)
    wdt = torch.exp(seg[:, :, -1:, :] - seg) * dtc                   # [B,c,l,H]
    xw = (xc * wdt[..., None]).reshape(B, nchunk, ck, nh * hp)
    states = (xw.transpose(2, 3) @ Bc).reshape(B, nchunk, nh, hp, ns)
    del xw
    chunk_decay = torch.exp(seg[:, :, -1, :])                        # [B,c,H]

    carry = (cache["state"] if cache is not None else
             torch.zeros((B, nh, hp, ns), dtype=torch.float32, device=u.device))
    prev = torch.empty_like(states)          # the state BEFORE each chunk
    for c in range(nchunk):
        prev[:, c] = carry
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    del states

    # inter-chunk: y_l += exp(seg_l) C_l . S_prev
    t = Cc @ prev.reshape(B, nchunk, nh * hp, ns).transpose(2, 3)    # [B,c,l,HP]
    y = y + t.reshape(B, nchunk, ck, nh, hp) * torch.exp(seg)[..., None]
    del t, prev
    y = y + p["D"][:, None] * xc
    y = y.reshape(B, nchunk * ck, di)[:, :S]
    y = _gate(cfg, p, y, z, u.dtype)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(carry)
        cache["pos"].add_(S)
    return y @ p["out_proj"], cache


def init_ssd_cache(cfg, batch: int, device) -> dict:
    di, ns, nh, hp = (cfg.ssd_d_inner, cfg.ssd_state, cfg.ssd_n_heads,
                      cfg.ssd_headdim)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, di + 2 * ns),
                            dtype=L.dt(cfg), device=device),
        "state": torch.zeros((batch, nh, hp, ns), dtype=torch.float32,
                             device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
