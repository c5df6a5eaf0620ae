"""Attention on torch (the port of repro.models.attention): GQA (full /
sliding-window / prefix-causal), MLA (deepseek-v3) and cross-attention
(whisper), with KV caches for serving.

Compute paths of a prefill (a forward with S > 1), chosen by ``impl``:
  * "flash": the hand-written CUDA kernel (kernels/flash_attention.py),
    the Hopper port of the JAX package's Pallas flash kernel.  On a CPU
    tensor its wrapper runs the plain version, ``naive_attention``.  It
    has no prefix mask (nor has the Pallas kernel), so a VLM config
    (paligemma's image prefix) raises: its prefill runs blockwise.
  * "blockwise": the online softmax over 512-key blocks as a Python loop
    (the JAX package's lax.scan), O(S) memory.
  * "naive": materialized scores, small shapes and tests.

Training (models/steps.py) runs "naive" or "blockwise" under autograd,
as the JAX package's training forward does: the flash kernel has no
backward, so ``impl="flash"`` raises a ValueError when autograd records
its inputs (``_flash``).  The blockwise loop's in-place softmax runs out
of place then (``layers.tracked``).

Decode (S == 1 with a cache) attends a single query over the cache
buffer with a validity mask, in plain torch for every ``impl``, as in the
JAX package.  Windowed layers use a ring buffer of size ``window``.
Caches store K after RoPE (absolute positions).

Layouts are the JAX package's: q ``[B,S,H,dh]``, k/v ``[B,S,Hkv,dh]``,
``wq [d,H,dh]``, ``wk``/``wv [d,Hkv,dh]``, ``wo [H,dh,d]``.  Where the JAX
package rebuilds a cache, the port writes it in place
(``_cache_update``) and returns the same tensors.  Scores and softmax
are f32 as the JAX package's ``preferred_element_type=f32``; a bf16
operand is widened to f32 first (its products are exact in f32).

MLA (deepseek-v3, ``_mla_forward``) caches the compressed latent ``c``
(``kv_lora_rank`` wide) beside the shared rope key (``qk_rope_dim``), one
``[B, buf, rkv + rr]`` leaf ring-buffered like k/v; a decode either
decompresses the whole cache to per-head K/V or, with ``cfg.mla_absorb``,
attends in the latent space.  Its scale is ``1/sqrt(qk_nope + qk_rope)``
on every path.  Two choices differ from the JAX package:

  * its prefill runs ``naive_attention`` for ``impl="naive"`` only and
    ``blockwise_attention`` otherwise; the JAX package runs naive whenever
    S <= 2,048, which at deepseek's serve shape (B=16, S=2,048, H=128)
    would materialize 34 GB of f32 scores.  Both compute the same
    function (blockwise is the JAX package's own path past 2,048 tokens).
  * it never runs the flash kernel: its q/k head dim (192) differs from
    its v head dim (128), and the kernel takes one head dim for all
    three, so ``impl="flash"`` on MLA means blockwise, as above.

Cross-attention (whisper's decoder, ``cross_attn_forward``) attends the
decoder's queries over K/V projected once from the encoder output
(``encode_cross_kv``), with no mask: a prefill runs the flash kernel
non-causally under ``impl="flash"`` (Sq != Sk), otherwise, as the JAX
package does, naive over at most 2,048 keys and blockwise beyond; a
decode step (Sq = 1) is plain torch for every ``impl``.  The encoder's
own self-attention (``encoder_attn_forward``, RoPE on q/k) takes the
same route (``attend_all``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as L

NEG = -2.0e38
BLOCK_Q = 512
BLOCK_K = 512
IMPLS = ("naive", "blockwise", "flash")


# ------------------------------------------------------------------ init

def init_attn(cfg, gen, spec) -> dict:
    """One layer's attention weights; with ``spec.cross_attn`` also the
    cross-attention's ``xq``/``xk``/``xv``/``xo`` and its norm ``xnorm``,
    drawn after the self-attention's as in the JAX package."""
    d, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(H * dh)
    if cfg.attn_impl == "mla":
        qh = cfg.qk_nope_dim + cfg.qk_rope_dim
        rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
        p = {"wq_a": L.normal(gen, (d, rq), L.dt(cfg), s),
             "wq_b": L.normal(gen, (rq, H, qh), L.dt(cfg), 1.0 / math.sqrt(rq)),
             "wkv_a": L.normal(gen, (d, rkv + cfg.qk_rope_dim), L.dt(cfg), s),
             "wkv_b": L.normal(gen, (rkv, H, cfg.qk_nope_dim + cfg.v_head_dim),
                               L.dt(cfg), 1.0 / math.sqrt(rkv)),
             "wo": L.normal(gen, (H, cfg.v_head_dim, d), L.dt(cfg), so)}
    else:
        p = {"wq": L.normal(gen, (d, H, dh), L.dt(cfg), s),
             "wk": L.normal(gen, (d, Hkv, dh), L.dt(cfg), s),
             "wv": L.normal(gen, (d, Hkv, dh), L.dt(cfg), s),
             "wo": L.normal(gen, (H, dh, d), L.dt(cfg), so)}
    if spec.cross_attn:
        p.update(xq=L.normal(gen, (d, H, dh), L.dt(cfg), s),
                 xk=L.normal(gen, (d, Hkv, dh), L.dt(cfg), s),
                 xv=L.normal(gen, (d, Hkv, dh), L.dt(cfg), s),
                 xo=L.normal(gen, (H, dh, d), L.dt(cfg), so),
                 xnorm=L.init_norm(cfg, gen.device))
    return p


# ----------------------------------------------------- blockwise attention

def attn_axes(cfg, spec) -> dict:
    """init_attn's logical axes."""
    if cfg.attn_impl == "mla":
        a = {"wq_a": ("embed", "lora"), "wq_b": ("lora", "heads", "head_dim"),
             "wkv_a": ("embed", "lora"),
             "wkv_b": ("lora", "heads", "head_dim"),
             "wo": ("heads", "head_dim", "embed")}
    else:
        a = {"wq": ("embed", "heads", "head_dim"),
             "wk": ("embed", "kv_heads", "head_dim"),
             "wv": ("embed", "kv_heads", "head_dim"),
             "wo": ("heads", "head_dim", "embed")}
    if spec.cross_attn:
        a.update(xq=("embed", "heads", "head_dim"),
                 xk=("embed", "kv_heads", "head_dim"),
                 xv=("embed", "kv_heads", "head_dim"),
                 xo=("heads", "head_dim", "embed"), xnorm=L.norm_axes(cfg))
    return a


def _gqa_scores(q, k):
    """q: [B,Sq,H,dh], k: [B,Sk,Hkv,dh] -> f32 [B,H,Sq,Sk] without
    repeating k."""
    B, Sq, H, dh = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, H // Hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    return s.reshape(B, H, Sq, k.shape[1])


def _gqa_out(p_attn, v):
    """p: [B,H,Sq,Sk], v: [B,Sk,Hkv,dh] -> f32 [B,Sq,H,dh]."""
    B, H, Sq, Sk = p_attn.shape
    Hkv = v.shape[2]
    pg = p_attn.reshape(B, Hkv, H // Hkv, Sq, Sk)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pg.float(),
                     v.to(p_attn.dtype).float())
    return o.reshape(B, Sq, H, v.shape[3])


def naive_attention(q, k, v, *, causal, window=None, prefix=0,
                    q_offset=0, kv_valid=None, scale=None):
    """Reference attention with materialized scores (tests / tiny shapes).

    prefix: first `prefix` query/key positions attend bidirectionally.
    q_offset: absolute position of q[0] relative to k[0] (decode).
    kv_valid: [B, Sk] bool mask of valid cache slots.  Returns f32."""
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    s = _gqa_scores(q * scale, k)
    Sq, Sk = s.shape[-2], s.shape[-1]
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
        if prefix:
            m |= kpos[None, :] < prefix
    if window is not None:
        m &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(m, s, NEG)
    if kv_valid is not None:
        s = torch.where(kv_valid[:, None, None, :], s, NEG)
    p_attn = torch.softmax(s, dim=-1)
    return _gqa_out(p_attn.to(v.dtype), v)


def _block_out(p_attn, vblk):
    """[B,H,bq,bk] x [B,bk,Hkv,dhv] -> [B,H,bq,dhv] (GQA-aware)."""
    B, H, bq, bk = p_attn.shape
    Hkv = vblk.shape[2]
    pg = p_attn.reshape(B, Hkv, H // Hkv, bq, bk)
    o = torch.einsum("bhgqk,bkhd->bhgqd", pg, vblk.float())
    return o.reshape(B, H, bq, vblk.shape[3])


def blockwise_attention(q, k, v, *, causal=True, window=None, prefix=0,
                        scale=None):
    """Flash-style attention in torch: a loop over KV blocks with an
    online softmax.  Windowed layers visit only in-window KV blocks.

    The JAX package's scan runs a fixed number of steps per query block
    and masks the steps before key block 0 entirely; this loop leaves
    those steps out.  A fully masked step leaves a row with a finite
    running max unchanged, and every real row meets its diagonal key in
    the first step, so the result is the same."""
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    B, S, H, dh = q.shape
    Sk, Hkv, dhv = k.shape[1], k.shape[2], v.shape[-1]
    bq, bk = min(BLOCK_Q, S), min(BLOCK_K, Sk)
    nq, nk = -(-S // bq), -(-Sk // bk)
    Sp, Skp = nq * bq, nk * bk
    # padded copies only where a block is partial (MLA's serve prefill
    # holds 1.5 GiB each of q and k)
    pad = lambda t, n: t if n == 0 else torch.nn.functional.pad(
        t, (0, 0, 0, 0, 0, n))
    qp, kp, vp = pad(q, Sp - S), pad(k, Skp - Sk), pad(v, Skp - Sk)
    dev = q.device
    # how many kv blocks behind the diagonal a query block must visit
    w_blocks = nk if window is None else min(nk, window // bk + 2)
    out = torch.empty((B, Sp, H, dhv), dtype=torch.float32, device=dev)
    for qi in range(nq):
        qblk = qp[:, qi * bq:(qi + 1) * bq] * scale
        qpos = qi * bq + torch.arange(bq, device=dev)
        m_run = torch.full((B, H, bq), NEG, dtype=torch.float32, device=dev)
        l_run = torch.zeros((B, H, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, bq, dhv), dtype=torch.float32, device=dev)
        if causal:
            blocks = [qi * bq // bk - rel for rel in range(w_blocks)
                      if qi * bq // bk - rel >= 0]
            blocks = [min(kj, nk - 1) for kj in blocks]
        else:
            blocks = range(nk)
        for kj in blocks:
            kblk = kp[:, kj * bk:(kj + 1) * bk]
            vblk = vp[:, kj * bk:(kj + 1) * bk]
            kpos = kj * bk + torch.arange(bk, device=dev)
            s = _gqa_scores(qblk, kblk)                        # [B,H,bq,bk]
            msk = torch.ones((bq, bk), dtype=torch.bool, device=dev)
            if causal:
                msk &= kpos[None, :] <= qpos[:, None]
                if prefix:
                    msk |= kpos[None, :] < prefix
            if window is not None:
                msk &= kpos[None, :] > qpos[:, None] - window
            msk &= (kpos < Sk)[None, :]
            # in place unless autograd records it: at [B, H, 512, 512] f32
            # each copy of s is 2 GiB at deepseek-v3's serve prefill
            grad = L.tracked(s)
            s = s.masked_fill(~msk, NEG) if grad else s.masked_fill_(~msk, NEG)
            m_new = torch.maximum(m_run, s.amax(-1))
            alpha = torch.exp(m_run - m_new)
            p_b = (torch.exp(s - m_new[..., None]) if grad
                   else s.sub_(m_new[..., None]).exp_())
            l_run = l_run * alpha + p_b.sum(-1)
            acc = acc * alpha[..., None] + _block_out(p_b, vblk)
            m_run = m_new
        o = acc / torch.clamp(l_run, min=1e-30)[..., None]
        out[:, qi * bq:(qi + 1) * bq] = o.transpose(1, 2)
    return out[:, :S].to(v.dtype)


# --------------------------------------------------------------- forward

def _proj_out(out, wo):
    """einsum("bshk,hkd->bsd") with the JAX package's type promotion."""
    dtype = torch.promote_types(out.dtype, wo.dtype)
    B, S, H, dh = out.shape
    return out.to(dtype).reshape(B, S, H * dh) @ wo.to(dtype).reshape(H * dh, -1)


def _proj_in(x, w):
    """einsum("bsd,dhk->bshk")."""
    d, H, dh = w.shape
    return (x @ w.reshape(d, H * dh)).reshape(*x.shape[:2], H, dh)


def attn_forward(cfg, spec, p, x, positions, cache=None, impl="blockwise"):
    """Self-attention.  x: [B,S,d].  cache: None (prefill without cache)
    or dict(k, v, pos) for decode / prefill-with-cache, written in place.
    Returns (out [B,S,d], cache)."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if cfg.attn_impl == "mla":
        return _mla_forward(cfg, p, x, positions, cache, impl)
    S = x.shape[1]
    q = L.rope(_proj_in(x, p["wq"]), positions, cfg.rope_theta)
    k = L.rope(_proj_in(x, p["wk"]), positions, cfg.rope_theta)
    v = _proj_in(x, p["wv"])

    if cache is not None:
        cache = _cache_update(cfg, spec, cache, k, v, positions)
        if S == 1:  # decode
            out = _decode_attend(cfg, spec, q, cache, positions)
            return _proj_out(out, p["wo"]), cache
        # prefill-with-cache: attend over the raw (unwrapped) K/V; the ring
        # buffer is only for subsequent decode steps.

    if impl == "naive":
        out = naive_attention(q, k, v, causal=True, window=spec.window,
                              prefix=cfg.vlm_patches)
    elif impl == "blockwise":
        out = blockwise_attention(q, k, v, causal=True, window=spec.window,
                                  prefix=cfg.vlm_patches)
    else:
        if cfg.vlm_patches:
            raise NotImplementedError(
                "impl='flash' has no prefix mask (nor has the Pallas kernel)")
        out = _flash(q, k, v, causal=True, window=spec.window)
    return _proj_out(out, p["wo"]), cache


def _flash(q, k, v, **kw):
    """The flash kernel, which has no backward (nor has the Pallas
    kernel): under autograd its output would be cut off from the graph
    and q, k, v would get no gradient, so that raises."""
    if L.tracked(q, k, v):
        raise ValueError(
            "impl='flash' has no backward: train with impl='naive' or "
            "'blockwise' (the JAX package's training forward), or run "
            "under torch.no_grad()")
    return FA.flash_attention(q, k, v, **kw)


def attend_all(q, k, v, impl):
    """Attention of every query over every key, no mask (the encoder's
    self-attention and cross-attention): the flash kernel run
    non-causally for a prefill under ``impl="flash"``; otherwise, and for
    a decode step (Sq = 1), the JAX package's choice: naive over at most
    2,048 keys, blockwise beyond."""
    if impl == "flash" and q.shape[1] > 1:
        return _flash(q, k, v, causal=False)
    if k.shape[1] <= 2048:
        return naive_attention(q, k, v, causal=False)
    return blockwise_attention(q, k, v, causal=False)


def encoder_attn_forward(cfg, p, x, positions, impl="blockwise"):
    """The whisper encoder's self-attention: RoPE on q/k (as the JAX
    package's lm.encode does), every frame attending every frame.
    x: [B,T,d] -> [B,T,d]."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    q = L.rope(_proj_in(x, p["wq"]), positions, cfg.rope_theta)
    k = L.rope(_proj_in(x, p["wk"]), positions, cfg.rope_theta)
    return _proj_out(attend_all(q, k, _proj_in(x, p["wv"]), impl), p["wo"])


def cross_attn_forward(cfg, p, x, enc_kv, impl="blockwise"):
    """Whisper's decoder cross-attention.  x: [B,S,d] (normed by
    ``xnorm``); enc_kv = (k, v) from encode_cross_kv, computed at prefill
    from the encoder output (or read back from the cache at decode)."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    k, v = enc_kv
    out = attend_all(_proj_in(x, p["xq"]), k, v, impl)
    return _proj_out(out, p["xo"])


def encode_cross_kv(cfg, p, enc_out):
    """The cross-attention's K and V [B, T, Hkv, dh] from the encoder
    output [B, T, d] (no RoPE)."""
    return _proj_in(enc_out, p["xk"]), _proj_in(enc_out, p["xv"])


# ------------------------------------------------------------------ cache

def init_cache(cfg, spec, batch, max_seq, device) -> dict:
    """Preallocated decode cache for one attention layer."""
    buf = max_seq if spec.window is None else min(spec.window, max_seq)
    if cfg.attn_impl == "mla":
        width = cfg.kv_lora_rank + cfg.qk_rope_dim
        return {"c": torch.zeros((batch, buf, width), dtype=L.dt(cfg),
                                 device=device),
                "pos": torch.zeros((), dtype=torch.int32, device=device)}
    shape = (batch, buf, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=L.dt(cfg), device=device),
            "v": torch.zeros(shape, dtype=L.dt(cfg), device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _cache_update(cfg, spec, cache, k, v, positions):
    """Write new entries at their (ring-buffered if windowed) slots, in
    place.  When prefilling more tokens than the buffer holds, keep the
    last `buf`.  positions: [S] shared, or [B, S] per-row (ragged
    continuous batching)."""
    for name, new in (("k", k), ("v", v)):
        _write_slots(cache[name], new, positions)
    cache["pos"].copy_(positions.max() + 1)
    return cache


def _write_slots(buf_t, new, positions):
    """buf_t[:, positions % buf] = new, in place (per row where positions
    is [B, S]); of more tokens than the buffer holds, the last `buf`."""
    buf = buf_t.shape[1]
    if new.shape[1] > buf:
        new, positions = new[:, -buf:], positions[..., -buf:]
    slots = (positions % buf).long()
    if slots.dim() == 2:  # per-row scatter
        b_idx = torch.arange(new.shape[0], device=new.device)[:, None]
        buf_t[b_idx, slots] = new.to(buf_t.dtype)
    else:
        buf_t[:, slots] = new.to(buf_t.dtype)


def _decode_attend(cfg, spec, q, cache, positions):
    """Single-token attention over the cache buffer with validity mask.
    positions: [1] shared, or [B, 1] per-row (ragged batching)."""
    valid = _valid_slots(cache["k"].shape[1], positions, q.shape[0],
                         spec.window)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _gqa_scores(q * scale, cache["k"])            # [B,H,1,buf]
    s = torch.where(valid[:, None, None, :], s, NEG)
    p_attn = torch.softmax(s, dim=-1)
    return _gqa_out(p_attn.to(cache["v"].dtype), cache["v"])


def _slot_positions(buf, cur):
    """Absolute position stored in each ring slot, given next-pos = cur.
    cur: [] or [B] -> [buf] or [B, buf]."""
    idx = torch.arange(buf, device=cur.device)
    c = cur[..., None] if cur.dim() else cur
    wrap = torch.div(c, buf, rounding_mode="floor") * buf + idx
    return torch.where(idx <= c % buf, wrap, wrap - buf)


def _valid_slots(buf, positions, B, window=None):
    """[B, buf] bool: the ring slots a decode at `positions` ([1] shared
    or [B, 1] per row) may read: written (slot_pos < 0 marks a slot not
    yet written on the first lap), not past the current position, and
    inside the window."""
    cur = positions[..., -1]                          # [] or [B]
    slot_pos = _slot_positions(buf, cur)              # [buf] or [B, buf]
    curb = cur[..., None]
    valid = (slot_pos <= curb) & (slot_pos >= 0)
    if window is not None:
        valid &= slot_pos > curb - window
    return valid.expand(B, buf)


# -------------------------------------------------------------------- MLA

def _mla_forward(cfg, p, x, positions, cache, impl):
    """DeepSeek-V3 multi-head latent attention (the JAX package's
    ``_mla_forward``).  The cache holds only the compressed latent and
    the shared rope key per token; attention decompresses them per call
    (prefill, and decode unless ``cfg.mla_absorb``)."""
    B, S, _ = x.shape
    rkv, rr = cfg.kv_lora_rank, cfg.qk_rope_dim
    nope = cfg.qk_nope_dim
    scale = 1.0 / math.sqrt(nope + rr)

    q = _proj_in(x @ p["wq_a"], p["wq_b"])               # [B,S,H,nope+rr]
    q_nope = q[..., :nope]
    q_rope = L.rope(q[..., nope:], positions, cfg.rope_theta)
    q = torch.cat([q_nope, q_rope], -1)

    ckv = x @ p["wkv_a"]                                  # [B,S,rkv+rr]
    k_rope = L.rope(ckv[:, :, None, rkv:], positions, cfg.rope_theta)[:, :, 0]
    ckv = torch.cat([ckv[..., :rkv], k_rope], -1)

    decode = cache is not None and S == 1
    if cache is not None:
        _write_slots(cache["c"], ckv, positions)
        cache["pos"].copy_(positions.max() + 1)
    # decode reads the buffer; a prefill attends over its own raw latents
    ckv_all = cache["c"] if decode else ckv
    c_all, kr_all = ckv_all[..., :rkv], ckv_all[..., rkv:]

    if decode and cfg.mla_absorb:
        # attend in the compressed latent space instead of decompressing
        # the whole cache per token:
        #   q_abs[h] = q_nope[h] @ W_kv^nope[h]^T   -> [B,H,rkv]
        #   score    = q_abs . c  +  q_rope . k_rope
        #   out[h]   = (attn @ c) @ W_kv^v[h]
        ok = _valid_slots(c_all.shape[1], positions, B)
        w_nope, w_v = p["wkv_b"][..., :nope], p["wkv_b"][..., nope:]
        q_abs = torch.einsum("bshk,rhk->bshr", q_nope, w_nope)
        s_lat = torch.einsum("bshr,btr->bhst", q_abs.float(), c_all.float())
        s_rope = torch.einsum("bshk,btk->bhst", q_rope.float(), kr_all.float())
        s = (s_lat + s_rope) * scale
        s = torch.where(ok[:, None, None, :], s, NEG)
        a_w = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", a_w.to(c_all.dtype), c_all)
        out = torch.einsum("bshr,rhk->bshk", ctx, w_v)
        return _proj_out(out, p["wo"]), cache

    # decompress the latents to per-head K/V
    kv = _proj_in(c_all, p["wkv_b"])                     # [B,Sk,H,nope+dv]
    k = torch.cat([kv[..., :nope],
                   kr_all[:, :, None, :].expand(*kv.shape[:3], rr)], -1)
    v = kv[..., nope:]
    if decode:
        ok = _valid_slots(c_all.shape[1], positions, B)
        out = naive_attention(q, k, v, causal=False, kv_valid=ok, scale=scale)
    elif impl == "naive":
        out = naive_attention(q, k, v, causal=True, scale=scale)
    else:
        out = blockwise_attention(q, k, v, causal=True, scale=scale)
    return _proj_out(out, p["wo"]), cache
