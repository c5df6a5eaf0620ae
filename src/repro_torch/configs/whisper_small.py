"""whisper-small [audio] — 12L d_model=768 12H d_ff=3072 vocab=51865 —
enc-dec; conv/audio frontend STUB: input_specs() provides 1500 precomputed
frame embeddings [arXiv:2212.04356; unverified].

Decoder: causal self-attn + cross-attn to the encoder output.  Skips
long_500k (full attention).  Decode shapes exercise the decoder with
cached cross-KV.
"""

from repro_torch.models.config import EncoderConfig, LayerSpec, ModelConfig

_DEC = LayerSpec(kind="attn", window=None, mlp="dense", cross_attn=True)

CONFIG = ModelConfig(
    name="whisper-small",
    d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab=51865,
    groups=(((_DEC,), 12),),
    norm="layernorm", act="gelu", gated_mlp=False,
    tie_embeddings=True,
    encoder=EncoderConfig(n_layers=12, n_frames=1500),
)

SMOKE = ModelConfig(
    name="whisper-small-smoke",
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512,
    groups=(((_DEC,), 2),),
    norm="layernorm", act="gelu", gated_mlp=False,
    tie_embeddings=True,
    encoder=EncoderConfig(n_layers=2, n_frames=32), dtype="float32",
)
