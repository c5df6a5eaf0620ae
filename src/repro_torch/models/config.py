"""Model configuration covering the 10 assigned architectures (the port's
copy of repro.models.config: pure Python, kept identical so configs and
parameter counts mean the same in both packages).

One generic decoder-LM config with per-layer block specs; modality
frontends (whisper audio, paligemma vision) are stubs per the assignment:
input_specs() provides precomputed frame/patch embeddings.

Layer stacking for scan-over-layers: `groups` is a tuple of
(pattern, repeats) — parameters of each pattern position are stacked
[repeats, ...] and the stack is scanned, keeping compiled HLO size
O(pattern) instead of O(n_layers).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"            # "attn" | "rglru" | "ssd"
    window: Optional[int] = None  # sliding-window size; None = global attn
    mlp: str = "dense"            # "dense" | "moe" | "none"
    cross_attn: bool = False      # whisper decoder blocks


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder; frontend stubbed to precomputed embeddings."""
    n_layers: int
    n_frames: int                 # encoder sequence length (e.g. 1500)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    groups: tuple  # ((LayerSpec, ...), repeats), ...

    norm: str = "rmsnorm"         # "rmsnorm" | "layernorm"
    act: str = "silu"             # "silu" | "gelu"
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    embed_scale: bool = False     # gemma-style sqrt(d_model) input scaling
    logit_softcap: float = 0.0    # gemma-style tanh soft-cap (0 = off)
    norm_eps: float = 1e-6        # the RMS / layer norms' epsilon
    # muP multipliers (granite-4.0-h): the embeddings times
    # embed_multiplier, each residual branch times residual_multiplier,
    # the logits divided by logits_scaling (1.0 = off)
    embed_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    shared_d_ff: int = 0          # the shared experts' width (0 = moe_d_ff
    #                               times n_shared_experts)
    moe_dropless: bool = False    # capacity that drops no (token, expert)
    #                               pair of a call
    router_aux_coef: float = 0.01

    # attention implementation
    attn_impl: str = "gqa"        # "gqa" | "mla"
    use_rope: bool = True         # False: no positional embedding (NoPE)
    attn_scale: float = 0.0       # softmax scale (0 = 1/sqrt(head_dim))
    mla_absorb: bool = False      # absorbed-matmul MLA decode (§Perf)
    q_lora_rank: int = 0          # MLA (deepseek-v3)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2 SSD)
    ssd_state: int = 0
    ssd_headdim: int = 64
    ssd_expand: int = 2
    ssd_chunk: int = 256
    conv_width: int = 4
    # "jax": the JAX package's block (SiLU before the conv, no norm);
    # "mamba2": the published one (the conv, then SiLU; y * silu(z) put
    # through a gated RMSNorm with a learned weight before out_proj)
    ssd_block: str = "jax"

    # RG-LRU (recurrentgemma)
    lru_width: int = 0

    # modality stubs
    encoder: Optional[EncoderConfig] = None   # whisper
    vlm_patches: int = 0                      # paligemma SigLIP stub

    # multi-token prediction (deepseek-v3)
    mtp: bool = False

    dtype: str = "bfloat16"
    vocab_pad: int = 256          # pad vocab for TP divisibility

    # --- derived ---
    @property
    def n_layers(self) -> int:
        return sum(len(pat) * rep for pat, rep in self.groups)

    @property
    def padded_vocab(self) -> int:
        v, p = self.vocab, self.vocab_pad
        return ((v + p - 1) // p) * p

    @property
    def ssd_d_inner(self) -> int:
        return self.ssd_expand * self.d_model

    @property
    def ssd_n_heads(self) -> int:
        return self.ssd_d_inner // self.ssd_headdim

    @property
    def shared_width(self) -> int:
        """Width of the shared expert's FFN (all shared experts as one)."""
        return self.shared_d_ff or self.moe_d_ff * self.n_shared_experts

    def layer_specs(self):
        """Flat per-layer spec list (order of execution)."""
        out = []
        for pat, rep in self.groups:
            for _ in range(rep):
                out.extend(pat)
        return out

    def supports_long_context(self) -> bool:
        """True iff every temporal-mixing block is sub-quadratic (windowed
        attention, SSD, or RG-LRU) — the long_500k gate in DESIGN.md §4,
        except gemma3 whose 1-in-6 global layers we accept (local layers
        dominate; global KV is sharded)."""
        for s in self.layer_specs():
            if s.kind == "attn" and s.window is None:
                return False
        return True


def param_count(cfg: ModelConfig) -> int:
    """Total parameters (for the 6·N·D roofline term)."""
    n = cfg.padded_vocab * cfg.d_model  # embed
    if not cfg.tie_embeddings:
        n += cfg.padded_vocab * cfg.d_model
    n += _stack_params(cfg, active_only=False)
    n += cfg.d_model  # final norm
    if cfg.encoder is not None:
        enc_spec = LayerSpec(kind="attn", window=None, mlp="dense")
        n += cfg.encoder.n_layers * _layer_params(cfg, enc_spec, cross=False)
        n += cfg.d_model
    if cfg.mtp:
        n += 2 * cfg.d_model * cfg.d_model + _layer_params(
            cfg, cfg.layer_specs()[-1], cross=False)
    return n


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: only routed top-k + shared)."""
    n = cfg.padded_vocab * cfg.d_model
    if not cfg.tie_embeddings:
        n += cfg.padded_vocab * cfg.d_model
    n += _stack_params(cfg, active_only=True)
    n += cfg.d_model
    if cfg.encoder is not None:
        enc_spec = LayerSpec(kind="attn", window=None, mlp="dense")
        n += cfg.encoder.n_layers * _layer_params(cfg, enc_spec, cross=False)
        n += cfg.d_model
    if cfg.mtp:
        n += 2 * cfg.d_model * cfg.d_model + _layer_params(
            cfg, cfg.layer_specs()[-1], cross=False, active_only=True)
    return n


def _stack_params(cfg: ModelConfig, active_only: bool) -> int:
    return sum(
        _layer_params(cfg, s, s.cross_attn, active_only)
        for s in cfg.layer_specs())


def _layer_params(cfg, spec: LayerSpec, cross: bool, active_only=False) -> int:
    d = cfg.d_model
    n = 0
    # temporal mixer
    if spec.kind == "attn":
        if cfg.attn_impl == "mla":
            qh = cfg.qk_nope_dim + cfg.qk_rope_dim
            n += d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * qh
            n += d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
            n += cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
            n += cfg.n_heads * cfg.v_head_dim * d
        else:
            n += d * cfg.n_heads * cfg.head_dim          # q
            n += 2 * d * cfg.n_kv_heads * cfg.head_dim   # k, v
            n += cfg.n_heads * cfg.head_dim * d          # o
        n += d  # norm
        if cross:
            n += 2 * (d * cfg.n_heads * cfg.head_dim) + \
                2 * (d * cfg.n_kv_heads * cfg.head_dim) // 2 + d
    elif spec.kind == "ssd":
        di, ns, nh = cfg.ssd_d_inner, cfg.ssd_state, cfg.ssd_n_heads
        n += d * (2 * di + 2 * ns + nh)   # in_proj (x, z, B, C, dt)
        n += cfg.conv_width * (di + 2 * ns)
        n += 3 * nh                        # A, dt_bias, D
        n += di * d                        # out_proj
        n += d
        if cfg.ssd_block == "mamba2":
            n += di                        # the gated norm's weight
    elif spec.kind == "rglru":
        w = cfg.lru_width or d
        n += d * w * 2 + cfg.conv_width * w + 2 * w + w * d + d
    # channel mixer
    if spec.mlp == "dense":
        mult = 3 if cfg.gated_mlp else 2
        n += mult * d * cfg.d_ff + d
    elif spec.mlp == "moe":
        mult = 3 if cfg.gated_mlp else 2
        e = cfg.top_k if active_only else cfg.n_experts
        n += e * mult * d * cfg.moe_d_ff + mult * d * cfg.shared_width
        n += d * cfg.n_experts + d
    return n
