"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE, layernorm + plain GeLU MLP [arXiv:2402.19173; hf]."""

from repro_torch.models.config import LayerSpec, ModelConfig

_BLK = LayerSpec(kind="attn", window=None, mlp="dense")

CONFIG = ModelConfig(
    name="starcoder2-3b",
    d_model=3072, n_heads=24, n_kv_heads=2, head_dim=128,
    d_ff=12288, vocab=49152,
    groups=(((_BLK,), 30),),
    norm="layernorm", act="gelu", gated_mlp=False,
    rope_theta=100000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="starcoder2-3b-smoke",
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    groups=(((_BLK,), 2),),
    norm="layernorm", act="gelu", gated_mlp=False,
    tie_embeddings=True, dtype="float32",
)
