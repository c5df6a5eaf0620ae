"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384,
MoE 8 experts top-2, SWA window 4096 [arXiv:2401.04088; hf].

SWA makes every layer's KV bounded => runs long_500k with ring caches.
8 experts don't divide the 16-way model axis; sharding falls back to the
expert-FFN "mlp" dim (models/sharding.py).
"""

from repro_torch.models.config import LayerSpec, ModelConfig

_BLK = LayerSpec(kind="attn", window=4096, mlp="moe")

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=32768,
    groups=(((_BLK,), 56),),
    rope_theta=1000000.0, tie_embeddings=True,
    n_experts=8, top_k=2, moe_d_ff=16384,
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke",
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    groups=(((LayerSpec(kind="attn", window=16, mlp="moe"),), 2),),
    tie_embeddings=True,
    n_experts=4, top_k=2, moe_d_ff=128, dtype="float32",
)
