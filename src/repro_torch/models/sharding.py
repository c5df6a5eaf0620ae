"""Logical-axis sharding on a mesh (the port of repro.models.sharding).

Every parameter has a tuple of *logical* axis names per dim
(models.lm.param_axes).  This module maps logical names to mesh axes with
the JAX package's divisibility-aware fallbacks:

  * at most one mesh axis is consumed per tensor per mesh-axis name;
  * a logical dim is sharded only if its size divides the mesh axis size,
    otherwise the next candidate dim takes the axis (mixtral's 8 experts
    do not divide a 16-way model axis, so the expert FFN shards its "mlp"
    dim instead; paligemma's 8 heads fall back to "mlp"/"vocab");
  * optional FSDP: the largest still-unsharded dim of a large tensor is
    also sharded over the data axis (ZeRO-3 style);
  * activations are constrained through ``constrain(x, logical_axes)``
    with the same rules ("batch" -> ("pod", "data"), ...).

A spec is a ``P``: per tensor dim, None or the tuple of mesh-axis names
that dim is split over (the JAX ``PartitionSpec``).  The rules read only
the mesh's ``axis_names`` and ``shape`` (a dict of axis sizes), so they
run on a ``launch.mesh.MeshShape`` (the production meshes, which exist
only as shapes here) as on a real ``DeviceMesh``.  ``make_param_shardings``
turns the specs into ``MeshSharding``s, whose ``placements`` are DTensor's
(``Shard(dim)`` on each mesh dim a tensor dim is split over, else
``Replicate()``).

The rules are held in a module-level context (``set_context``) that the
caller installs around a step, so model code stays free of mesh plumbing.
With no mesh installed ``constrain`` returns its input.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.pytree import tree_map

# priority order: earlier logical names grab the "model" axis first.
# "embed" is the last-resort fallback (without it, tensors whose natural
# dims don't divide the axis, e.g. deepseek's wo at 256-way 2D TP,
# replicate and blow the memory budget).
MODEL_AXIS_PRIORITY = ("experts", "vocab", "heads", "kv_heads", "mlp",
                       "lora", "head_dim", "embed")


@dataclasses.dataclass(frozen=True)
class Rules:
    batch: tuple = ("pod", "data")       # filtered by mesh axis presence
    seq: tuple = ()                      # ("data",) enables sequence sharding
    model: tuple = ("model",)
    fsdp: tuple = ("data",)              # axis used for FSDP param sharding
    fsdp_params: bool = False            # shard big params over data axis
    fsdp_min_size: int = 1 << 20         # only tensors >= 1M elements
    moe_constraints: bool = False        # constrain MoE dispatch tensors
    moe_shard_map: bool = False          # shard-map expert path: dispatch
                                         # stays local per data shard
    shard_experts: bool = True           # False: skip expert-dim sharding
                                         # (the shard-map path needs the
                                         # full expert set on every device)


DEFAULT_RULES = Rules()

_CTX: dict = {"mesh": None, "rules": DEFAULT_RULES}


class P(tuple):
    """A partition spec: one entry per tensor dim, None or the mesh-axis
    names the dim is split over.  ``P()`` is replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def set_context(mesh, rules: Rules = DEFAULT_RULES):
    _CTX["mesh"], _CTX["rules"] = mesh, rules


def get_context():
    return _CTX["mesh"], _CTX["rules"]


def mesh_axis_names(mesh) -> tuple:
    """A MeshShape's or JAX-like mesh's ``axis_names``, or a DeviceMesh's
    ``mesh_dim_names``."""
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def mesh_sizes(mesh) -> dict:
    """{axis name: size}: a ``shape`` dict as it is, or a DeviceMesh's
    shape tuple by its dim names."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh_axis_names(mesh), tuple(shape)))


def _axes_in_mesh(mesh, names):
    present = mesh_axis_names(mesh)
    return tuple(n for n in names if n in present)


def _axis_size(mesh, names) -> int:
    sizes = mesh_sizes(mesh)
    return int(np.prod([sizes[n] for n in names])) if names else 1


def spec_for_param(mesh, rules: Rules, logical_axes, shape) -> P:
    """Partition spec of one parameter tensor."""
    model_ax = _axes_in_mesh(mesh, rules.model)
    model_sz = _axis_size(mesh, model_ax)
    assign: dict[int, tuple] = {}

    # 1) model-axis dim: first by priority that divides.  The "embed"
    # last-resort fallback only applies to large tensors (it exists to
    # stop multi-GB weights from replicating, not to scatter small
    # routers/norms whose replication is free).
    big = int(np.prod(shape)) >= (1 << 22)
    for name in MODEL_AXIS_PRIORITY:
        if name == "embed" and not big:
            continue
        if name == "experts" and not rules.shard_experts:
            continue
        done = False
        for i, ax in enumerate(logical_axes):
            if ax == name and shape[i] % model_sz == 0 and model_sz > 1:
                assign[i] = model_ax
                done = True
                break
        if done:
            break

    # 2) FSDP: largest unassigned dim over the data axis
    if rules.fsdp_params and int(np.prod(shape)) >= rules.fsdp_min_size:
        data_ax = _axes_in_mesh(mesh, rules.fsdp)
        data_sz = _axis_size(mesh, data_ax)
        if data_sz > 1:
            cands = [i for i in range(len(shape)) if i not in assign
                     and shape[i] % data_sz == 0]
            if cands:
                big = max(cands, key=lambda i: shape[i])
                assign[big] = data_ax
    return P(*[assign.get(i, None) for i in range(len(shape))])


def spec_names(entry) -> tuple:
    """The mesh-axis names of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_for(mesh, spec) -> tuple:
    """DTensor placements of `spec` on `mesh`: for each mesh dim,
    ``Shard(d)`` where tensor dim d is split over it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {n: d for d, e in enumerate(spec) for n in spec_names(e)}
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                 for n in mesh_axis_names(mesh))


@dataclasses.dataclass(frozen=True)
class MeshSharding:
    """A tensor's layout on a mesh: its ``spec`` and, from it, DTensor's
    ``placements`` (one per mesh dim)."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements_for(self.mesh, self.spec)


def is_axes(x) -> bool:
    """A leaf of an axes tree: a tuple of logical names (or None)."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def make_param_shardings(mesh, rules: Rules, axes_tree, shapes_tree):
    """MeshSharding tree matching the params tree (shapes_tree: tensors,
    meta tensors or shapes)."""
    def one(ax, shp):
        shape = tuple(shp.shape) if hasattr(shp, "shape") else tuple(shp)
        return MeshSharding(mesh, spec_for_param(mesh, rules, ax, shape))
    return tree_map(one, axes_tree, shapes_tree, is_leaf=is_axes)


def spec_for_act(mesh, rules: Rules, logical_axes, shape=None) -> P:
    out = []
    used = set()
    for i, name in enumerate(logical_axes):
        if name == "batch":
            ax = _axes_in_mesh(mesh, rules.batch)
        elif name == "seq":
            ax = _axes_in_mesh(mesh, rules.seq)
        elif name in ("heads", "kv_heads", "experts", "mlp", "vocab"):
            ax = _axes_in_mesh(mesh, rules.model)
        else:
            ax = ()
        ax = tuple(a for a in ax if a not in used)
        if ax and shape is not None and shape[i] % _axis_size(mesh, ax) != 0:
            ax = ()
        used |= set(ax)
        out.append(ax if ax else None)
    return P(*out)


def constrain(x, logical_axes):
    """The JAX package's with_sharding_constraint under the installed mesh
    context: a DTensor is redistributed to ``spec_for_act``'s placements.
    A plain tensor is the whole value on every rank (what a constraint
    leaves unchanged in value) and is returned as it is, as is every
    input outside a mesh context."""
    mesh, rules = get_context()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = spec_for_act(mesh, rules, logical_axes, x.shape)
    return x.redistribute(x.device_mesh, placements_for(x.device_mesh, spec))


def put_on_device(tree, device):
    """Move a UCTree (any object with ``map``) or a tensor to ONE device.
    The D-sharded executor (core/sharded.py) places each shard's arena
    with this; every later op and kernel launch on the shard runs on that
    device.  None leaves the tree where it is."""
    if device is None:
        return tree
    dev = torch.device(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return tree.map(lambda t: t.to(dev))
