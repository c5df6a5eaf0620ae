"""Mixture-of-Experts layer on torch (the port of repro.models.moe's
one-device form, ``_moe_dense``: mixtral-8x22b, deepseek-v3).

The forward is four steps, each a function of its own so that a caller
can time it or hold it to the JAX package:

  * ``route``: the router in f32 (logits and softmax probabilities);
  * ``dispatch``: probabilities -> the sort-based, capacity-bounded
    dispatch integers (``Dispatch``: gates, expert ids, the stable sort,
    the slots, the kept pairs and the capacity C), the JAX package's
    integers exactly;
  * ``experts``: the gather into ``[E, C, d]`` and the expert FFNs as
    batched matrix products (``torch.bmm``: the JAX package computes them
    with ``einsum``, outside any Pallas kernel);
  * ``combine``: the gated expert outputs summed back per token.

Where the JAX package and torch differ:

  * ``jax.lax.top_k`` puts the lower expert index first among equal
    probabilities; ``torch.topk`` promises no order among ties, so the top
    K comes from a stable descending sort.  The gates' normalizing sum is
    taken in k order, so the card's gates are the CPU's bit for bit.
  * ``.at[slot].set(..., mode="drop")`` drops the overflow slot ``E*C``;
    torch's scatters do not, so ``xe`` is gathered instead: each of the
    ``E*C`` rows reads its token when the slot is filled and is zero
    otherwise (the rows the JAX scatter leaves at zero).
  * the combine's ``.at[token].add`` is a scatter-add in the output dtype
    (bf16 at serve); on the card ``index_add_`` uses atomics, whose order
    changes from launch to launch.  The port adds each token's K
    contributions without atomics, in ascending expert order (the order
    of the JAX package's sorted updates), in the output dtype.

Capacity is ``max(8, ceil8(ceil(T*K/E*cf)))`` over every token of the
call (T = B*S), so rows of one call compete for it: a caller must not
split a call's tokens across calls.  With ``cfg.moe_dropless`` (the
published routing of granite-4.0-h) no pair is dropped: a call of at
most ``SYNC_FREE_TOKENS`` tokens takes C = T (an expert gets at most one
pair a token, and no count is read back), a larger one the largest
expert's load, read back once a layer.  Inside ``counting_drops(sink)``
every MoE layer adds the pairs it dropped to the device scalar ``sink``
(no host read).

The shard-map expert path (``_moe_shard_map``, taken under a mesh context
whose rules set ``moe_shard_map``): torch has no ``shard_map``, so it is
written SPMD by hand over the processes of a ``DeviceMesh``.  Each rank
takes the global tokens and weights, keeps its data shard of the tokens
and its shard of each weight (by its mesh coordinates and
``spec_for_param``'s specs), all-gathers any FSDP-sharded weight dim over
the data axes (``_gather_fsdp``), runs the four steps above on its local
tokens (capacity from the local T, as the JAX path computes it), sums the
f-contraction partials over the model axes (all-reduce), and all-gathers
y over the data axes, so every rank returns the global y.  aux is the
first data shard's own aux, broadcast from it: the JAX path returns shard
0's value (``out_specs=P()`` without a replication check), not the
global aux, and the port returns the same.  Sharding the expert dim over
the model axes (``Rules(shard_experts=True)`` with E divisible) would hand
each rank a slice of the experts its local router still routes to: the
JAX path fails there with an einsum shape error, and the port raises a
ValueError instead.  The path runs forward only: ``torch.distributed``'s
collectives record no gradient.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import sharding as sh
from repro_torch.pytree import tree_map


SYNC_FREE_TOKENS = 64
_drops = None       # counting_drops' sink while one is open


@contextlib.contextmanager
def counting_drops(sink: torch.Tensor):
    """Within the block, every MoE layer adds its dropped (token, expert)
    pairs to `sink`, an int64 scalar on the tokens' device."""
    global _drops
    prev, _drops = _drops, sink
    try:
        yield sink
    finally:
        _drops = prev


def init_moe(cfg, gen) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"router": L.normal(gen, (d, e), torch.float32, s_in),
         "wi": L.normal(gen, (e, d, f), L.dt(cfg), s_in),
         "wg": L.normal(gen, (e, d, f), L.dt(cfg), s_in),
         "wo": L.normal(gen, (e, f, d), L.dt(cfg), s_out)}
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(cfg, gen, d_ff=cfg.shared_width)
    return p


def moe_axes(cfg) -> dict:
    """init_moe's logical axes (the JAX package's ``_moe_axes``)."""
    a = {"router": ("embed", "experts"),
         "wi": ("experts", "embed", "mlp"),
         "wg": ("experts", "embed", "mlp"),
         "wo": ("experts", "mlp", "embed")}
    if cfg.n_shared_experts:
        a["shared"] = L.mlp_axes(cfg)
    return a


@dataclasses.dataclass
class Dispatch:
    """The dispatch of T tokens to E experts, K each, in the JAX
    package's names: ``gate``/``eidx`` ``[T, K]`` (the top K, the higher
    probability first); ``order`` ``[T*K]``, the stable sort of the flat
    expert ids ``eidx.reshape(T*K)``; ``slot``/``keep`` ``[T*K]`` in that
    sorted order: the pair's row ``e*C + rank`` of ``[E*C, d]``, or
    ``E*C`` where its expert was full (``keep`` false)."""
    gate: torch.Tensor
    eidx: torch.Tensor
    order: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    C: int


def capacity(T: int, K: int, E: int, capacity_factor: float) -> int:
    C = int(np.ceil(T * K / E * capacity_factor))
    return max(8, -(-C // 8) * 8)                           # pad to 8


def route(p, xf) -> torch.Tensor:
    """Router probabilities [T, E] in f32 (the logits are an f32 product:
    TF32 changes them, and with them the routes)."""
    return torch.softmax(xf.float() @ p["router"], dim=-1)


def dropless_capacity(eidx, E: int) -> int:
    """The least capacity that drops no pair of `eidx` [T, K]: T for a
    call of at most SYNC_FREE_TOKENS tokens (K distinct experts a token),
    else the largest expert's load (a host read)."""
    T = eidx.shape[0]
    if T <= SYNC_FREE_TOKENS:
        return max(T, 1)
    return max(int(expert_counts(eidx, E).max()), 1)


def dispatch(probs, K: int, capacity_factor: float = 1.25,
             dropless: bool = False) -> Dispatch:
    T, E = probs.shape
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = srt[:, :K], idx[:, :K]
    # the K gates summed in order k = 0..K-1, so every device rounds alike
    total = gate[:, 0]
    for k in range(1, K):
        total = total + gate[:, k]
    gate = gate / torch.clamp(total[:, None], min=1e-9)
    C = dropless_capacity(eidx, E) if dropless else \
        capacity(T, K, E, capacity_factor)
    fe = eidx.reshape(T * K)
    order = torch.sort(fe, stable=True).indices
    se = fe[order]
    pos = torch.arange(T * K, device=probs.device)
    newrun = torch.ones_like(se, dtype=torch.bool)
    newrun[1:] = se[1:] != se[:-1]
    run_start = torch.cummax(torch.where(newrun, pos, 0), 0).values
    slot_in_e = pos - run_start                             # rank inside expert
    keep = slot_in_e < C                                    # overflow dropped
    slot = torch.where(keep, se * C + slot_in_e, E * C)
    return Dispatch(gate, eidx, order, slot, keep, C)


def expert_counts(eidx, E: int) -> torch.Tensor:
    """Pairs routed to each expert, [E] int64 (a scatter-add of ones:
    ``torch.bincount`` on the card reads the largest id back to the host
    first)."""
    fe = eidx.reshape(-1)
    return torch.zeros(E, dtype=torch.int64, device=fe.device).scatter_add_(
        0, fe, torch.ones_like(fe))


def experts(cfg, p, xf, dsp: Dispatch) -> torch.Tensor:
    """The expert FFNs over the dispatched tokens: [E*C, d] in the
    weights' dtype.  Row ``e*C + c`` holds the c-th kept token of expert
    e (by the stable sort), zero past the expert's count."""
    E, C = p["wi"].shape[0], dsp.C
    T, K = dsp.eidx.shape
    st_ = torch.div(dsp.order, K, rounding_mode="floor")    # sorted token ids
    # the sorted position of row (e, c): the first pair of expert e plus c
    counts = expert_counts(dsp.eidx, E)
    first = torch.cumsum(counts, 0) - counts
    c = torch.arange(C, device=xf.device)
    src = (first[:, None] + c).reshape(E * C)
    filled = (c < counts[:, None]).reshape(E * C)
    rows = st_[torch.clamp(src, max=T * K - 1)]
    # gathered, then the rows past each expert's count zeroed, in place
    # unless autograd records it (at deepseek's serve shape xe is 4.7 GB)
    grad = L.tracked(xf, p["wi"], p["wg"], p["wo"])
    xe = xf[rows]
    xe = xe * filled[:, None].to(xf.dtype) if grad \
        else xe.mul_(filled[:, None].to(xf.dtype))
    xe = xe.reshape(E, C, -1)
    # pinned to (experts, capacity over the data axes) under a mesh whose
    # rules ask for it (the JAX package's moe_constraints)
    mesh, rules = sh.get_context()
    pin = mesh is not None and rules.moe_constraints
    if pin:
        xe = sh.constrain(xe, ("experts", "batch", None))
    h = torch.bmm(xe, p["wi"])
    g = torch.bmm(xe, p["wg"])
    del xe
    h = L.act_fn(cfg)(g) * h if grad else L.act_fn(cfg)(g).mul_(h)
    del g
    ye = torch.bmm(h, p["wo"])
    if pin:
        ye = sh.constrain(ye, ("experts", "batch", None))
    return ye.reshape(E * C, -1)


def combine(ye, dsp: Dispatch) -> torch.Tensor:
    """y [T, d] in ye's dtype: each token's K gated expert rows (zero for
    a dropped pair), added in ascending expert order, without atomics."""
    T, K = dsp.eidx.shape
    EC = ye.shape[0]
    # slot, keep and gate of flat pair t*K + k (un-sorted)
    slot = torch.empty_like(dsp.slot)
    slot[dsp.order] = dsp.slot
    keep = torch.empty_like(dsp.keep)
    keep[dsp.order] = dsp.keep
    gate = torch.where(keep, dsp.gate.reshape(T * K), 0.0).to(ye.dtype)
    slot = torch.clamp(slot, max=EC - 1)
    by_expert = torch.argsort(dsp.eidx, dim=-1)            # distinct ids
    base = torch.arange(T, device=ye.device) * K
    y = torch.zeros((T, ye.shape[1]), dtype=ye.dtype, device=ye.device)
    for j in range(K):
        pair = base + by_expert[:, j]
        y = y + ye[slot[pair]] * gate[pair][:, None]
    return y


def moe_forward(cfg, p, x, capacity_factor: float = 1.25):
    """x: [B, S, d] -> (y [B, S, d], the load-balance aux loss)."""
    B, S, d = x.shape
    mesh, rules = sh.get_context()
    if mesh is not None and rules.moe_shard_map:
        y, aux = _moe_shard_map(cfg, p, x.reshape(B * S, d), capacity_factor,
                                mesh, rules)
        return y.reshape(B, S, d), aux
    return _moe_dense(cfg, p, x, capacity_factor)


def _local_expert_ffn(cfg, p, xf, capacity_factor: float = 1.25):
    """(y [T, d] in the weights' dtype, the aux loss) of tokens xf [T, d]
    through weights p: the one-device MoE, and one rank's local work in
    the shard-map path (where y is a partial sum over the f dim when the
    weights are split over the model axes)."""
    T, d = xf.shape
    E, K = cfg.n_experts, cfg.top_k
    probs = route(p, xf)
    dsp = dispatch(probs, K, capacity_factor, cfg.moe_dropless)
    if _drops is not None:
        _drops.add_((~dsp.keep).sum())
    y = combine(experts(cfg, p, xf, dsp), dsp)
    if cfg.n_shared_experts:
        y = y + L.mlp(cfg, p["shared"], xf)
    # load-balance aux loss (switch-style)
    me = probs.mean(0)                                      # mean router prob
    ce = expert_counts(dsp.eidx, E).float() / (T * K)      # token fraction
    aux = E * torch.sum(me * ce)
    return y, aux


def _moe_dense(cfg, p, x, capacity_factor):
    B, S, d = x.shape
    y, aux = _local_expert_ffn(cfg, p, x.reshape(B * S, d), capacity_factor)
    return y.reshape(B, S, d), aux


# --------------------------------------------------------------------------
# the shard-map expert path, SPMD over a DeviceMesh
# --------------------------------------------------------------------------

def _coord(mesh, names) -> tuple:
    """(index, count) of this rank's block over the mesh axes `names`
    (major first), from its mesh coordinates."""
    sizes = sh.mesh_sizes(mesh)
    coord = dict(zip(sh.mesh_axis_names(mesh), mesh.get_coordinate()))
    idx = 0
    for n in names:
        idx = idx * sizes[n] + coord[n]
    return idx, int(np.prod([sizes[n] for n in names])) if names else 1


def _local_shard(w, spec, mesh):
    """This rank's block of the global tensor w under `spec`."""
    for dim, entry in enumerate(spec):
        names = sh.spec_names(entry)
        if names:
            i, n = _coord(mesh, names)
            w = w.chunk(n, dim)[i]
    return w


def _gather(w, dim, mesh, names):
    """All-gather w along `dim` over the mesh axes `names` (tiled: the
    blocks in the order of the ranks' flattened coordinates)."""
    import torch.distributed as dist

    for n in reversed(names):        # the minor axis first
        group = mesh.get_group(n)
        parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, w.contiguous(), group=group)
        w = torch.cat(parts, dim)
    return w


def _gather_fsdp(w, spec, mesh, data_axes):
    """ZeRO-3 weight re-gather: any dim the FSDP rules split over the data
    axes is all-gathered before use."""
    for dim, entry in enumerate(spec):
        g = tuple(n for n in sh.spec_names(entry) if n in data_axes)
        if g:
            w = _gather(w, dim, mesh, g)
    return w


def _moe_shard_map(cfg, p, xf, capacity_factor, mesh, rules):
    """(y [T, d], aux) of the global tokens xf [T, d], every rank of
    `mesh` computing its block (see the module docstring)."""
    import torch.distributed as dist

    names = sh.mesh_axis_names(mesh)
    data_axes = tuple(a for a in rules.batch if a in names)
    model_axes = tuple(a for a in rules.model if a in names)
    axes = moe_axes(cfg)
    specs = tree_map(lambda ax, w: sh.spec_for_param(mesh, rules, ax,
                                                     tuple(w.shape)),
                     axes, p, is_leaf=sh.is_axes)
    for key in ("router", "wi", "wg", "wo"):
        i = axes[key].index("experts")
        if set(sh.spec_names(specs[key][i])) & set(model_axes):
            raise ValueError(
                f"{cfg.name}: Rules(shard_experts=True) splits the expert dim "
                f"of {key} {tuple(p[key].shape)} over the model axes "
                f"{model_axes}, and the shard-map path needs every expert on "
                f"every rank (its local router routes to all {cfg.n_experts}): "
                f"use Rules(shard_experts=False), as specs.OPTIMIZED_RULES "
                f"does")
    local = tree_map(lambda w, s: _gather_fsdp(_local_shard(w, s, mesh), s,
                                               mesh, data_axes),
                     p, specs, is_leaf=lambda x: isinstance(x, sh.P))
    di, dn = _coord(mesh, data_axes)
    y, aux = _local_expert_ffn(cfg, local, xf.chunk(dn, 0)[di],
                               capacity_factor)
    for n in model_axes:             # the f-contraction partials
        dist.all_reduce(y, group=mesh.get_group(n))
    aux = aux.detach().clone()
    for n in data_axes:              # data shard 0's aux, as JAX returns
        group = mesh.get_group(n)
        dist.broadcast(aux, src=dist.get_global_rank(group, 0), group=group)
    return _gather(y, 0, mesh, data_axes), aux
