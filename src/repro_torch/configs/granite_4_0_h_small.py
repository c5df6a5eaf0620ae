"""granite-4.0-h-small [hybrid moe] — IBM Granite 4.0-H Small, 32B-A9B:
40L d_model=4096, a period of 10 layers (0-4 and 6-9 Mamba-2, 5 GQA
attention without a positional embedding), a MoE of 72 SwiGLU experts
of width 768 (top-10) beside a shared SwiGLU expert of width 1,536 in
every layer, tied embeddings over 100,352 tokens, muP multipliers
[hf: ibm-granite/granite-4.0-h-small config.json].

Mamba-2 layers: 128 heads of 64 (d_inner 8,192), d_state 128, one
group, conv 4 with bias, chunk 256, the published block (conv, then
SiLU, then a gated RMSNorm).  Attention: 32 query heads and 8 KV heads
of 128, scale attention_multiplier = 1/128.  Embeddings x12, each
residual branch x0.22, logits / 16, RMS norms with eps 1e-5.  The
router takes the softmax over the top-10 logits and drops nothing.
32.21e9 parameters: 64.4 GB in bf16, whole on one 80 GB H100.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

_M = LayerSpec(kind="ssd", mlp="moe")
_A = LayerSpec(kind="attn", mlp="moe")

_HYBRID = dict(
    norm_eps=1e-5, embed_multiplier=12.0, residual_multiplier=0.22,
    logits_scaling=16.0, use_rope=False, moe_dropless=True,
    ssd_block="mamba2", tie_embeddings=True, gated_mlp=True, act="silu",
)

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=768, vocab=100352,
    groups=(((_M, _M, _M, _M, _M, _A, _M, _M, _M, _M), 4),),
    attn_scale=0.0078125,
    n_experts=72, top_k=10, moe_d_ff=768, n_shared_experts=1,
    shared_d_ff=1536,
    ssd_state=128, ssd_headdim=64, ssd_expand=2, ssd_chunk=256,
    conv_width=4, **_HYBRID,
)

SMOKE = ModelConfig(
    name="granite-4.0-h-small-smoke",
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab=512,
    groups=(((_M, _A, _M), 2),),
    attn_scale=1.0 / 16,
    n_experts=8, top_k=2, moe_d_ff=32, n_shared_experts=1, shared_d_ff=64,
    ssd_state=16, ssd_headdim=16, ssd_expand=2, ssd_chunk=8,
    conv_width=4, dtype="float32", **_HYBRID,
)
