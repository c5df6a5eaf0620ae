"""mamba2-2.7b [ssm] — 64L d_model=2560 (attn-free) vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060; unverified].

Pure SSD stack: no attention, no separate MLP (the SSD block carries the
expansion).  O(1) decode state => runs long_500k.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

_SSD = LayerSpec(kind="ssd", mlp="none")

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    d_model=2560, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab=50280,
    groups=(((_SSD,), 64),),
    tie_embeddings=True,
    ssd_state=128, ssd_headdim=64, ssd_expand=2, conv_width=4,
)

SMOKE = ModelConfig(
    name="mamba2-2.7b-smoke",
    d_model=64, n_heads=1, n_kv_heads=1, head_dim=16,
    d_ff=0, vocab=512,
    groups=(((_SSD,), 2),),
    tie_embeddings=True,
    ssd_state=16, ssd_headdim=16, ssd_expand=2, conv_width=4,
    ssd_chunk=32, dtype="float32",
)
