"""The plain reference of granite-4.0-h-small (IBM Granite 4.0-H,
model_type granitemoehybrid): its weights, drawn from a seed, and its
forward, in float32 plain torch, one sequence and one layer at a time,
with no cache, no batching and no kernel.

    h = emb(x) * embedding_multiplier
    per layer:  h += residual_multiplier * mixer(rms(h))
                h += residual_multiplier * (moe(rms(h)) + shared(rms(h)))
    logits = rms(h) @ emb^T / logits_scaling

Mamba-2 mixer (layer_types "mamba"): in_proj -> (z, xBC, dt); xBC =
silu(conv(xBC) + b), depthwise causal over mamba_d_conv taps; SSD with
A = -exp(A_log) and dt = softplus(dt + dt_bias), plus D * x; y =
rms(y * silu(z)) * w over the whole inner width (one group); out_proj.
The SSD is the chunked form of the Mamba-2 paper's minimal listing
(arXiv:2405.21060): within a chunk the masked quadratic form, across
chunks the state recurrence.  Attention (layer_types "attention"): GQA
without a positional embedding, scores times attention_multiplier,
causal.  MoE: softmax over the top-k router logits, every routed pair
computed (nothing dropped), SwiGLU experts; a shared SwiGLU expert over
every token.  RMS norms with eps rms_norm_eps.

Departures from the published model:
  * random weights, drawn from the seed (``draw_layer``, ``draw_embed``),
    each matrix (and the conv's taps and bias, the router and the
    embedding) rounded to bfloat16 as the checkpoint holds them; A_log,
    dt_bias and D in float32; norm weights ones.  The inits: normal
    matrices scaled by 1/sqrt(fan_in), the embedding N(0, 0.02), the conv
    N(0, 0.1), A from U[1, 16] and dt_bias from dt log-uniform on [1e-3,
    0.1] (the published Mamba-2 inits).
  * the whole computation in float32 with TF32 off (the checkpoint runs
    in bfloat16).  ``low=True`` computes the SSD state across chunks and
    the router's logits in bfloat16 (the configuration states float32),
    and ``fp8=True`` rounds the residual stream after each branch and
    every layer's normed input, which the projections read, to float8
    e4m3 (the configuration states bfloat16 activations): both together
    are the control, each part one precision below the configuration's.
  * the vocabulary is the published 100,352, a multiple of 256, so no
    padding row exists.

``dims`` is a dict of the published config.json's keys (hidden_size,
layer_types, mamba_*, num_*, intermediate_size, ...).  Nothing here
imports the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _gen(seed: int, layer: int, k: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B1 + (layer + 2) * 1009 + k)
                  % (1 << 63))
    return g


def _normal(g, shape, scale, device) -> torch.Tensor:
    x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return x.mul_(scale).to(torch.bfloat16).float()


def _inner(dims) -> tuple:
    di = dims["mamba_expand"] * dims["hidden_size"]
    return (di, dims["mamba_d_state"] * dims["mamba_n_groups"],
            dims["mamba_n_heads"], dims["mamba_d_head"])


def head_dim(dims) -> int:
    return dims["hidden_size"] // dims["num_attention_heads"]


def draw_embed(dims, seed: int, device) -> torch.Tensor:
    """The tied embedding [vocab, hidden] (bf16 values in f32)."""
    return _normal(_gen(seed, -1, 0, device),
                   (dims["vocab_size"], dims["hidden_size"]), 0.02, device)


def draw_layer(dims, seed: int, layer: int, device) -> dict:
    """Layer `layer`'s weights (f32 tensors), drawn from (seed, layer)
    alone, so any one layer can be drawn again by itself."""
    d, E = dims["hidden_size"], dims["num_local_experts"]
    f, fs = dims["intermediate_size"], dims["shared_intermediate_size"]
    g = iter(range(64))

    def normal(shape, scale):
        return _normal(_gen(seed, layer, next(g), device), shape, scale,
                       device)

    w = {"input_norm": torch.ones(d, device=device),
         "post_norm": torch.ones(d, device=device)}
    if dims["layer_types"][layer] == "mamba":
        di, ns, nh, _ = _inner(dims)
        conv = di + 2 * ns
        w["in_proj"] = normal((d, 2 * di + 2 * ns + nh), 1 / math.sqrt(d))
        w["conv_w"] = normal((dims["mamba_d_conv"], conv), 0.1)
        w["conv_b"] = normal((conv,), 0.1)
        u = torch.rand((2, nh), generator=_gen(seed, layer, next(g), device),
                       device=device)
        w["A_log"] = torch.log(1 + 15 * u[0])
        dt = torch.exp(math.log(1e-3) + u[1] * (math.log(0.1) - math.log(1e-3)))
        w["dt_bias"] = dt + torch.log(-torch.expm1(-dt))   # softplus^-1
        w["D"] = torch.ones(nh, device=device)
        w["norm"] = torch.ones(di, device=device)
        w["out_proj"] = normal((di, d), 1 / math.sqrt(di))
    else:
        H, Hkv, dh = (dims["num_attention_heads"],
                      dims["num_key_value_heads"], head_dim(dims))
        w["q"] = normal((d, H * dh), 1 / math.sqrt(d))
        w["k"] = normal((d, Hkv * dh), 1 / math.sqrt(d))
        w["v"] = normal((d, Hkv * dh), 1 / math.sqrt(d))
        w["o"] = normal((H * dh, d), 1 / math.sqrt(H * dh))
    w["router"] = normal((d, E), 1 / math.sqrt(d))
    w["w_in"] = normal((E, d, f), 1 / math.sqrt(d))
    w["w_gate"] = normal((E, d, f), 1 / math.sqrt(d))
    w["w_out"] = normal((E, f, d), 1 / math.sqrt(f))
    w["shared_in"] = normal((d, fs), 1 / math.sqrt(d))
    w["shared_gate"] = normal((d, fs), 1 / math.sqrt(d))
    w["shared_out"] = normal((fs, d), 1 / math.sqrt(fs))
    return w


def rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _segsum(a):
    """[..., l] -> [..., l, l]: sum of a over (j, i] where j <= i, else
    -inf."""
    cs = torch.cumsum(a, -1)
    out = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones(a.shape[-1], a.shape[-1], dtype=torch.bool,
                      device=a.device).tril()
    return out.masked_fill(~keep, -math.inf)


def ssd(x, dt, A, B, C, chunk: int, low: bool = False):
    """y [S, H, P] of the selective state space: h_t = exp(dt_t A) h_{t-1}
    + dt_t x_t B_t^T, y_t = h_t C_t, from a zero state."""
    S, H, P = x.shape
    N = B.shape[-1]
    n = -(-S // chunk)
    pad = n * chunk - S
    X = F.pad(x * dt[..., None], (0, 0, 0, 0, 0, pad)).view(n, chunk, H, P)
    a = F.pad(dt * A, (0, 0, 0, pad)).view(n, chunk, H).permute(2, 0, 1)
    Bc = F.pad(B, (0, 0, 0, pad)).view(n, chunk, N)
    Cc = F.pad(C, (0, 0, 0, pad)).view(n, chunk, N)
    acs = torch.cumsum(a, -1)                                  # [H, n, l]
    # within each chunk: y_i = sum_{j<=i} C_i.B_j exp(a_{j+1..i}) X_j
    Lm = torch.exp(_segsum(a)).permute(1, 2, 3, 0)             # [n, l, s, H]
    W = (Cc @ Bc.transpose(1, 2))[..., None] * Lm              # [n, l, s, H]
    y = torch.einsum("clsh,cshp->clhp", W, X)
    del W, Lm
    # each chunk's own state, then the state carried across chunks
    decay = torch.exp(acs[..., -1:] - acs)                     # [H, n, l]
    states = torch.einsum("cln,hcl,clhp->chpn", Bc, decay, X)
    carry = torch.zeros(H, P, N, device=x.device)
    prev = []
    for c in range(n):
        prev.append(carry)
        carry = carry * torch.exp(acs[:, c, -1])[:, None, None] + states[c]
        if low:
            carry = carry.to(torch.bfloat16).float()
    prev = torch.stack(prev)                                   # [n, H, P, N]
    y = y + torch.einsum("cln,chpn,hcl->clhp", Cc, prev, torch.exp(acs))
    return y.reshape(n * chunk, H, P)[:S]


def mamba(dims, w, x, low=False):
    S = x.shape[0]
    di, ns, nh, hp = _inner(dims)
    zxbcdt = x @ w["in_proj"]
    z, xbc, dt = zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * ns], \
        zxbcdt[:, 2 * di + 2 * ns:]
    width = w["conv_w"].shape[0]
    xp = F.pad(xbc, (0, 0, width - 1, 0))
    xbc = sum(xp[i:i + S] * w["conv_w"][i] for i in range(width))
    xbc = F.silu(xbc + w["conv_b"])
    xs, B, C = xbc[:, :di], xbc[:, di:di + ns], xbc[:, di + ns:]
    dt = F.softplus(dt + w["dt_bias"])
    A = -torch.exp(w["A_log"])
    y = ssd(xs.view(S, nh, hp), dt, A, B, C, dims["mamba_chunk_size"], low)
    y = y + w["D"][:, None] * xs.view(S, nh, hp)
    y = y.reshape(S, di) * F.silu(z)
    y = rms(y, w["norm"], dims["rms_norm_eps"])
    return y @ w["out_proj"]


def attention(dims, w, x):
    S = x.shape[0]
    H, Hkv, dh = (dims["num_attention_heads"], dims["num_key_value_heads"],
                  head_dim(dims))
    q = (x @ w["q"]).view(S, H, dh)
    k = (x @ w["k"]).view(S, Hkv, dh).repeat_interleave(H // Hkv, 1)
    v = (x @ w["v"]).view(S, Hkv, dh).repeat_interleave(H // Hkv, 1)
    s = torch.einsum("qhd,khd->hqk", q, k) * dims["attention_multiplier"]
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, -math.inf), -1)
    return torch.einsum("hqk,khd->qhd", p, v).reshape(S, H * dh) @ w["o"]


def moe(dims, w, x, low=False):
    """Routed experts (top-k softmax, every pair kept) plus the shared
    expert."""
    K = dims["num_experts_per_tok"]
    if low:
        logits = (x.to(torch.bfloat16) @ w["router"].to(torch.bfloat16)).float()
    else:
        logits = x @ w["router"]
    top, idx = logits.topk(K, -1)
    gates = torch.softmax(top, -1)
    y = torch.zeros_like(x)
    for e in range(w["router"].shape[1]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if len(tok) == 0:
            continue
        xe = x[tok]
        h = F.silu(xe @ w["w_gate"][e]) * (xe @ w["w_in"][e])
        y[tok] += (h @ w["w_out"][e]) * gates[tok, slot][:, None]
    h = F.silu(x @ w["shared_gate"]) * (x @ w["shared_in"])
    return y + h @ w["shared_out"]


def _round(x, fp8: bool):
    return x.to(torch.float8_e4m3fn).float() if fp8 else x


def layer(dims, w, kind: str, h, low=False, fp8=False):
    eps, r = dims["rms_norm_eps"], dims["residual_multiplier"]
    x = _round(rms(h, w["input_norm"], eps), fp8)
    h = _round(h + r * (mamba(dims, w, x, low) if kind == "mamba"
                        else attention(dims, w, x)), fp8)
    x = _round(rms(h, w["post_norm"], eps), fp8)
    return _round(h + r * moe(dims, w, x, low), fp8)


@torch.no_grad()
def logits_at(dims, seed: int, rows: list, at: list, device,
              low: bool = False, fp8: bool = False) -> list:
    """For each sequence of `rows` (token ids), the logits [len(a), V] at
    its positions `a` (of `at`): each sequence through every layer in
    turn, the layer's weights drawn once for all of them."""
    _no_tf32()
    E = draw_embed(dims, seed, device)
    hs = [E[torch.as_tensor(np.asarray(r, np.int64), device=device)]
          * dims["embedding_multiplier"] for r in rows]
    del E
    for i, kind in enumerate(dims["layer_types"]):
        w = draw_layer(dims, seed, i, device)
        hs = [layer(dims, w, kind, h, low, fp8) for h in hs]
        del w
    E = draw_embed(dims, seed, device)
    ones = torch.ones(dims["hidden_size"], device=device)
    out = []
    for h, a in zip(hs, at):
        x = rms(h[torch.as_tensor(np.asarray(a, np.int64), device=device)],
                ones, dims["rms_norm_eps"])
        out.append((x @ E.T / dims["logits_scaling"]).cpu())
    return out


def continuation_check(dims, seed: int, items: list, device,
                       low: bool = False, fp8: bool = False) -> list:
    """items: (state tokens [n], continuation tokens [h]).  For each:
    (the logits [V] of the state's last position, the continuation's
    mean log-prob, teacher-forced on its tokens)."""
    rows = [np.concatenate([s, c[:-1]]) for s, c in items]
    at = [np.arange(len(s) - 1, len(s) - 1 + len(c)) for s, c in items]
    out = []
    for lg, (s, c) in zip(logits_at(dims, seed, rows, at, device, low, fp8),
                          items):
        lp = torch.log_softmax(lg.double(), -1)
        value = float(lp[torch.arange(len(c)), torch.as_tensor(
            np.asarray(c, np.int64))].mean())
        out.append((lg[0].numpy(), value))
    return out
