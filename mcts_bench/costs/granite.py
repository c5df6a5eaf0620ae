"""FLOPs of granite-4.0-h-small's forward that a token needs, from the
published shapes (a `dims` dict under the config.json's keys).  Two FLOPs
a multiply-add; norms, activations, the softmaxes and the conv are left
out (not multiply-adds, or under 0.1% of the count).

  * a token through the layers: every projection it touches (the Mamba
    in/out projections, q/k/v/o, the router, its top-k experts and the
    shared expert), and the SSD's state update and read-out in its
    recurrent form (dt x B^T, the decay, C h: 3 x heads x head dim x
    state a Mamba layer);
  * an attended key: QK^T and PV over every query head of every
    attention layer;
  * a logits row: the tied unembedding.
"""


def _layers(dims) -> tuple:
    kinds = dims["layer_types"]
    return kinds.count("mamba"), kinds.count("attention")


def flops_per_token(dims) -> int:
    d, E, K = dims["hidden_size"], dims["num_local_experts"], \
        dims["num_experts_per_tok"]
    di = dims["mamba_expand"] * d
    ns = dims["mamba_d_state"] * dims["mamba_n_groups"]
    nh, hp = dims["mamba_n_heads"], dims["mamba_d_head"]
    H, Hkv = dims["num_attention_heads"], dims["num_key_value_heads"]
    dh = d // H
    n_m, n_a = _layers(dims)
    mamba = d * (2 * di + 2 * ns + nh) + di * d + 3 * nh * hp * ns
    attn = d * (H + 2 * Hkv) * dh + H * dh * d
    mlp = d * E + 3 * d * (K * dims["intermediate_size"]
                           + dims["shared_intermediate_size"])
    return 2 * (n_m * mamba + n_a * attn + (n_m + n_a) * mlp)


def flops_per_key(dims) -> int:
    d, H = dims["hidden_size"], dims["num_attention_heads"]
    return 4 * H * (d // H) * _layers(dims)[1]


def flops_per_logits_row(dims) -> int:
    return 2 * dims["vocab_size"] * dims["hidden_size"]


def flops(dims, tokens: float, keys: float, rows: float) -> float:
    return (tokens * flops_per_token(dims) + keys * flops_per_key(dims)
            + rows * flops_per_logits_row(dims))
