"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local(1024):global, 128k context
[hf:google/gemma-3-1b-pt; unverified].

long_500k note (DESIGN.md §4): 40/48 layers are 1024-window local; the 8
global layers keep a full-length KV cache, sharded over the mesh — we run
the cell and report its memory in the dry-run.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

_LOCAL = LayerSpec(kind="attn", window=1024, mlp="dense")
_GLOBAL = LayerSpec(kind="attn", window=None, mlp="dense")

CONFIG = ModelConfig(
    name="gemma3-12b",
    d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab=262144,
    groups=(((_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL), 8),),
    rope_theta=1000000.0, tie_embeddings=True, embed_scale=True,
)

SMOKE = ModelConfig(
    name="gemma3-12b-smoke",
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    groups=(((LayerSpec(kind="attn", window=16, mlp="dense"),
              LayerSpec(kind="attn", window=None, mlp="dense")), 2),),
    tie_embeddings=True, embed_scale=True, dtype="float32",
)
