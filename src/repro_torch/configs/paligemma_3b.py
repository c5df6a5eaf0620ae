"""paligemma-3b [vlm] — 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216 — SigLIP + gemma backbone [arXiv:2407.07726; hf].

The SigLIP vision tower is a STUB per the assignment: input_specs()
provides 256 precomputed patch embeddings at d_model (post-projector);
they form a bidirectional prefix ahead of the causal text tokens.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

_BLK = LayerSpec(kind="attn", window=None, mlp="dense")

CONFIG = ModelConfig(
    name="paligemma-3b",
    d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257216,
    groups=(((_BLK,), 18),),
    rope_theta=10000.0, tie_embeddings=True, embed_scale=True,
    vlm_patches=256,
)

SMOKE = ModelConfig(
    name="paligemma-3b-smoke",
    d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=512,
    groups=(((_BLK,), 2),),
    tie_embeddings=True, embed_scale=True, vlm_patches=8, dtype="float32",
)
