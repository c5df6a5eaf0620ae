"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attn, pattern 2 recurrent : 1 local-attn
(window 2048) [arXiv:2402.19427; unverified].

38 = 12 x (rec, rec, attn) + (rec, rec) tail.  Runs long_500k: RG-LRU
state is O(1), attention windows are bounded.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

_REC = LayerSpec(kind="rglru", mlp="dense")
_ATT = LayerSpec(kind="attn", window=2048, mlp="dense")

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000,
    groups=(((_REC, _REC, _ATT), 12), ((_REC, _REC), 1)),
    rope_theta=10000.0, tie_embeddings=True, embed_scale=True,
    lru_width=4096,
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke",
    d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=512,
    groups=(((_REC, _REC,
              LayerSpec(kind="attn", window=16, mlp="dense")), 1),
            ((_REC,), 1)),
    tie_embeddings=True, embed_scale=True, lru_width=64, dtype="float32",
)
