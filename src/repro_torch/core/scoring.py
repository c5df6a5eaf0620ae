"""Edge scoring (paper Eq. 1 + virtual-loss variants) on tensors.

The port of repro.core.scoring, with the same op order.  All inputs are
integers (counts + Qm.16 sums); the only transcendental input comes from
the shared ln table; every float op (convert, divide, sqrt, add, multiply
by a power of two, multiply by beta, round) is a separate correctly
rounded f32 op, so scores are bit-identical to the numpy oracle on any
device — and to the CUDA kernel, which spells the same ops with the
``__f*_rn`` intrinsics.

Shapes: edge inputs are ``[..., Fp]``; node inputs broadcast as
``[..., 1]``.  Returns int32 fixed-point scores ``[..., Fp]``: invalid
lanes are FX_NEG_INF and never-visited edges FX_FORCE_EXPLORE (uct).
"""

from __future__ import annotations

import torch

from repro_torch.core import fixedpoint as fx
from repro_torch.core.tree import NULL, TreeConfig


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def edge_scores_fx(
    cfg: TreeConfig,
    *,
    child,        # [..., Fp] i32
    edge_N,       # [..., Fp] i32
    edge_W,       # [..., Fp] i32 (Qm.16)
    edge_VL,      # [..., Fp] i32
    edge_P,       # [..., Fp] i32 (Qm.16)
    node_N,       # [..., 1]  i32
    node_O,       # [..., 1]  i32
    num_actions,  # [..., 1]  i32
    log_table=None,  # [2X+4] f32, or [G, 2X+4] per slot for [G, Fp]
                     # rows (omit iff log_ns given)
    log_ns=None,     # optional precomputed ln(ns) [..., 1] f32
):
    f32, i32 = torch.float32, torch.int32
    Fp = child.shape[-1]
    lane = torch.arange(Fp, dtype=i32, device=child.device)
    valid = (lane < num_actions) & (child != NULL)

    if cfg.vl_mode == "wu":
        ne = edge_N + edge_VL                    # N̄ = N + O (in-flight)
        ns = node_N + node_O
    else:
        ne = edge_N
        ns = node_N
    ns = torch.clamp(ns, max=2 * cfg.X + 3)      # log-table bound

    ne_safe = torch.clamp(ne, min=1).to(f32)
    if log_ns is None and log_table.dim() == 1:
        log_ns = log_table[ns.long()]
    elif log_ns is None:   # per-slot tables [G, 2X+4] against ns [G, 1]
        log_ns = torch.gather(log_table, -1, ns.long())
    inv = _f32(float(fx.FX_INV_SCALE), child)
    beta = _f32(cfg.beta, child)

    if cfg.score_fn == "uct":
        q = (edge_W.to(f32) * inv) / ne_safe
        u = beta * torch.sqrt(log_ns / ne_safe)
        base = fx.encode(q + u)
        base = torch.where(ne == 0, torch.full_like(base, int(fx.FX_FORCE_EXPLORE)), base)
    else:  # puct: Q + c * P * sqrt(Ns) / (1 + Ne); Q := 0 when unvisited
        q = (edge_W.to(f32) * inv) / ne_safe
        q = torch.where(ne == 0, torch.zeros_like(q), q)
        sqrt_ns = torch.sqrt(ns.to(f32))
        p_f = edge_P.to(f32) * inv
        u = beta * p_f * sqrt_ns / (_f32(1.0, child) + ne.to(f32))
        base = fx.encode(q + u)

    if cfg.vl_mode == "constant":
        # Paper Alg. 1 line 5: uct(s, s_hat) -= VL per in-flight worker,
        # exact integer arithmetic in the Qm.16 domain.
        base = base - cfg.vl_const_fx * edge_VL

    return torch.where(valid, base, torch.full_like(base, int(fx.FX_NEG_INF)))


def argmax_first(scores_fx):
    """First-maximum argmax over the last axis (ties go to the lowest
    lane), spelled as max then min-index-of-max so it is the same on every
    device."""
    Fp = scores_fx.shape[-1]
    lane = torch.arange(Fp, dtype=torch.int32, device=scores_fx.device)
    m = scores_fx.max(dim=-1, keepdim=True).values
    return torch.where(scores_fx == m, lane, Fp).min(dim=-1).values.to(torch.int32)


def is_leaf(cfg: TreeConfig, *, num_expanded, num_actions, terminal, depth):
    """Selection-leaf predicate (paper §II-A; see TreeConfig.leaf_mode)."""
    if cfg.leaf_mode == "partial":
        open_node = num_expanded < num_actions
    else:
        open_node = num_expanded == 0
    return open_node | (terminal != 0) | (depth >= cfg.D) | (num_actions == 0)
