"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff(moe)=2048
vocab=129280 — MLA (q_lora 1536 / kv_lora 512 / nope 128 / rope 64 /
v 128), 1 shared + 256 routed top-8, MTP head [arXiv:2412.19437; hf].

First 3 layers are dense (d_ff = 18432, the published dense-layer width;
the assignment's d_ff=2048 is the per-expert MoE width).  Skips long_500k
(MLA compresses the cache but attention is global).  FSDP sharding + the
adafactor optimizer are required for HBM fit — see launch/dryrun.py.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

_DENSE = LayerSpec(kind="attn", window=None, mlp="dense")
_MOE = LayerSpec(kind="attn", window=None, mlp="moe")

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432, vocab=129280,
    groups=(((_DENSE,), 3), ((_MOE,), 58)),
    rope_theta=10000.0, tie_embeddings=True,
    attn_impl="mla",
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=256, top_k=8, n_shared_experts=1, moe_d_ff=2048,
    mtp=True,
)

SMOKE = ModelConfig(
    name="deepseek-v3-671b-smoke",
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512,
    groups=(((_DENSE,), 1), ((_MOE,), 2)),
    tie_embeddings=True,
    attn_impl="mla",
    q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16,
    n_experts=8, top_k=2, n_shared_experts=1, moe_d_ff=64,
    mtp=True, dtype="float32",
)
