"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-1B; unverified]."""

from repro_torch.models.config import LayerSpec, ModelConfig

_BLK = LayerSpec(kind="attn", window=None, mlp="dense")

CONFIG = ModelConfig(
    name="llama3.2-1b",
    d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=128256,
    groups=(((_BLK,), 16),),
    rope_theta=500000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke",
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    groups=(((_BLK,), 2),),
    rope_theta=500000.0, tie_embeddings=True, dtype="float32",
)
