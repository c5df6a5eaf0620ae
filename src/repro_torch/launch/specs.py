"""Per-cell input specs and sharding rules for the dry run and the
launcher (the port of repro.launch.specs).

``token_specs`` returns meta tensors (the port's ``ShapeDtypeStruct``:
shape and dtype, no allocation) for every input of the step a cell runs;
``rules_for`` picks the sharding rules of an (arch, shape) cell.  The
optimizer (AdamW or Adafactor) and the FSDP flag are part of the arch's
deployment config.  The byte counts (``bytes_of``,
``sharded_bytes_per_device``) read shapes and specs only, so they run on
a launch.mesh.MeshShape (the production meshes) as on a DeviceMesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import lm, sharding as sh
from repro_torch.models.config import ModelConfig
from repro_torch.optim import make_optimizer
from repro_torch.pytree import tree_leaves, tree_map

# archs whose param+optimizer footprint needs ZeRO-3-style sharding
FSDP_ARCHS = {"recurrentgemma-9b", "gemma3-12b", "granite-3-8b",
              "deepseek-v3-671b", "mixtral-8x22b"}
# archs whose optimizer state must be factored to fit HBM
ADAFACTOR_ARCHS = {"deepseek-v3-671b", "mixtral-8x22b"}


def optimizer_for(cfg: ModelConfig):
    """(name, (init_fn, update_fn)) of the arch's optimizer."""
    name = "adafactor" if cfg.name in ADAFACTOR_ARCHS else "adamw"
    return name, make_optimizer(name, lr=3e-4, warmup=100, total=10_000)


def rules_for(cfg: ModelConfig, shape: configs.ShapeSpec,
              optimized: bool = False) -> sh.Rules:
    fsdp = cfg.name in FSDP_ARCHS
    if shape.name == "long_500k":
        # batch=1: shard the sequence/cache-length dim instead
        base = sh.Rules(batch=(), seq=("pod", "data"), fsdp_params=fsdp)
    elif shape.kind == "decode":
        # a 32k KV cache with only batch sharding leaves up to 40 GB a
        # device (granite); sharding the cache length over the model axis
        # restores fit
        base = sh.Rules(batch=("pod", "data"), seq=("model",),
                        fsdp_params=fsdp)
    else:
        base = sh.Rules(batch=("pod", "data"), seq=(), fsdp_params=fsdp)
    if optimized:
        base = OPTIMIZED_RULES.get((cfg.name, shape.name), base)
    return base


# the JAX package's tuned layouts
OPTIMIZED_RULES = {
    # sequence-parallel prefill: 24 heads don't divide the model axis, so
    # head-sharding falls back; sharding the sequence keeps projections
    # local and turns the attention exchange into O(KV) per layer.
    ("starcoder2-3b", "prefill_32k"): sh.Rules(
        batch=("pod", "data"), seq=("model",), fsdp_params=False),
    # shard-map expert path (models/moe.py): dispatch stays local.
    ("mixtral-8x22b", "train_4k"): sh.Rules(
        batch=("pod", "data"), seq=(), fsdp_params=True,
        moe_shard_map=True),
    # the same path; 256 experts would shard over the model axis, which
    # the shard-map dispatch cannot use: shard the per-expert FFN dim.
    ("deepseek-v3-671b", "train_4k"): sh.Rules(
        batch=("pod", "data"), seq=(), fsdp_params=True,
        moe_shard_map=True, shard_experts=False),
    # 2D tensor-parallel serving: params over (data x model), cache
    # sequence over both axes, batch replicated.
    ("deepseek-v3-671b", "decode_32k"): sh.Rules(
        batch=(), seq=("data", "model"), model=("data", "model"),
        fsdp_params=False),
}


def config_for(cfg: ModelConfig, shape: configs.ShapeSpec,
               optimized: bool = False) -> ModelConfig:
    """Per-cell model-config overrides for the optimized runs."""
    if optimized and cfg.attn_impl == "mla" and shape.kind == "decode":
        cfg = dataclasses.replace(cfg, mla_absorb=True)   # absorbed-MLA decode
    return cfg


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def token_specs(cfg: ModelConfig, shape: configs.ShapeSpec) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        d = {"tokens": _meta((B, S), torch.int32),
             "labels": _meta((B, S), torch.int32),
             "mask": _meta((B, S), torch.float32)}
    elif shape.kind == "prefill":
        d = {"tokens": _meta((B, S), torch.int32)}
    else:  # decode: one token against a seq_len cache
        d = {"tokens": _meta((B, 1), torch.int32)}
    if cfg.vlm_patches and shape.kind != "decode":
        d["patches"] = _meta((B, cfg.vlm_patches, cfg.d_model), torch.float32)
    if cfg.encoder is not None and shape.kind != "decode":
        d["frames"] = _meta((B, cfg.encoder.n_frames, cfg.d_model),
                            torch.float32)
    return d


def batch_spec_shardings(mesh, rules, cfg, shape, batch_specs):
    out = {}
    for k, v in batch_specs.items():
        if k in ("tokens", "labels", "mask"):
            ax = ("batch", "seq") if v.shape[1] > 1 else ("batch", None)
        elif k in ("patches", "frames"):
            ax = ("batch", "seq", "embed")
        else:
            ax = (None,) * v.dim()
        out[k] = sh.MeshSharding(
            mesh, sh.spec_for_act(mesh, rules, ax, tuple(v.shape)))
    return out


# ----------------------------------------------------------------- caches

_CACHE_AXES = {
    "k": (None, "batch", "seq", "kv_heads", None),
    "v": (None, "batch", "seq", "kv_heads", None),
    "xk": (None, "batch", None, "kv_heads", None),
    "xv": (None, "batch", None, "kv_heads", None),
    "c": (None, "batch", "seq", None),            # MLA latent
    "state": (None, "batch", "heads", None, None),  # SSD
    "conv": (None, "batch", None, "mlp"),
    "h": (None, "batch", "mlp"),                  # RG-LRU
    "pos": (None,),
}


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    """init_caches' tree on the meta device (no allocation)."""
    return lm.init_caches(cfg, batch, max_seq, "meta")


def _map_named(fn, tree, name=None):
    """fn(leaf's dict key, leaf) over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, name) for v in tree)
    return fn(name, tree)


def cache_shardings(mesh, rules, cache_tree):
    def one(name, leaf):
        nd = leaf.dim()
        ax = _CACHE_AXES.get(name, (None,) * nd)[:nd]
        ax = ax + (None,) * (nd - len(ax))
        return sh.MeshSharding(
            mesh, sh.spec_for_act(mesh, rules, ax, tuple(leaf.shape)))
    return _map_named(one, cache_tree)


# -------------------------------------------------------------- opt state

def opt_state_shardings(mesh, rules, opt_name, axes_tree, param_shapes,
                        opt_shapes):
    """Shardings of the optimizer state, from the params' logical axes."""
    def pshard(ax, shp):
        return sh.MeshSharding(
            mesh, sh.spec_for_param(mesh, rules, ax, tuple(shp.shape)))

    if opt_name == "adamw":
        m = tree_map(pshard, axes_tree, param_shapes, is_leaf=sh.is_axes)
        return {"m": m, "v": m}

    # adafactor: vr drops the last dim, vc the second-to-last
    def fshard(ax, pshp, st):
        shp = tuple(pshp.shape)
        if "vr" in st:
            return {
                "vr": sh.MeshSharding(mesh, sh.spec_for_param(
                    mesh, rules, ax[:-1], shp[:-1])),
                "vc": sh.MeshSharding(mesh, sh.spec_for_param(
                    mesh, rules, ax[:-2] + ax[-1:], shp[:-2] + shp[-1:])),
            }
        return {"v": sh.MeshSharding(
            mesh, sh.spec_for_param(mesh, rules, ax, shp))}

    stats = tree_map(lambda ax, p, st: fshard(ax, p, st), axes_tree,
                     param_shapes, opt_shapes["stats"], is_leaf=sh.is_axes)
    return {"stats": stats}


# ---------------------------------------------------------------- helpers

def bytes_of(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def sharded_bytes_per_device(tree, shardings, mesh) -> int:
    """Exact per-device bytes given shapes and MeshShardings."""
    sizes = sh.mesh_sizes(mesh)
    total = 0
    for leaf, shd in zip(tree_leaves(tree), tree_leaves(shardings)):
        shards = int(np.prod([sizes[n] for e in shd.spec
                              for n in sh.spec_names(e)]))
        total += leaf.numel() * leaf.element_size() // shards
    return total
