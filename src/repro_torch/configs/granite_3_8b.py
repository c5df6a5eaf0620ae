"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 [hf:ibm-granite/granite-3.0-2b-base; hf]."""

from repro_torch.models.config import LayerSpec, ModelConfig

_BLK = LayerSpec(kind="attn", window=None, mlp="dense")

CONFIG = ModelConfig(
    name="granite-3-8b",
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12800, vocab=49155,          # padded to 49408 for TP divisibility
    groups=(((_BLK,), 40),),
    rope_theta=10000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-3-8b-smoke",
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=160, vocab=515,              # odd vocab: exercises padding
    groups=(((_BLK,), 2),),
    tie_embeddings=True, dtype="float32",
)
