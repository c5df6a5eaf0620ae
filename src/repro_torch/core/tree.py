"""UCT data structure (paper §III-A), as a dataclass of torch tensors.

The port's counterpart of repro.core.tree.  The UCT is a fixed-capacity
struct-of-arrays holding every statistic the in-tree operations touch:
``[X, Fp]`` edge arrays, ``[X]`` node arrays, Qm.16 ``edge_W``/``edge_P``
and a shared ln table.  An arena stacks G trees along a leading ``[G]``
axis (``size``/``root`` become ``[G]``); the in-tree ops of
core/intree.py and the CUDA kernels work on arenas and update their
tensors in place, where the JAX package rebuilds arrays.

State carry: ``to_numpy`` / ``from_numpy`` turn a tree into the dict of
numpy arrays that the JAX package's ``executor.slot_snapshot`` and
``snapshot`` produce, and back, so the same tree can be handed to both
packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import fixedpoint as fx

NULL = -1  # sentinel child / node index

FIELDS = ("child", "edge_N", "edge_W", "edge_VL", "edge_P", "node_N",
          "node_O", "num_expanded", "num_actions", "node_depth", "terminal",
          "size", "root", "log_table")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises when CUDA is asked for (or defaulted to) and absent;
    there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain torch path")
    return dev


def pad_fanout(f: int) -> int:
    """Round F up to a power of two <= 128."""
    if f > 128:
        raise NotImplementedError(f"fanout {f} > 128: multi-row edge blocks not implemented")
    p = 1
    while p < f:
        p <<= 1
    return p


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """Static configuration of the in-tree machinery (see
    repro.core.tree.TreeConfig for the meaning of every field)."""

    X: int
    F: int
    D: int
    beta: float = 1.0
    vl_mode: str = "wu"
    vl_const: float = 1.0
    score_fn: str = "uct"
    leaf_mode: str = "partial"
    expand_all: bool = False

    def __post_init__(self):
        if self.vl_mode not in ("wu", "constant"):
            raise ValueError(f"vl_mode {self.vl_mode!r}")
        if self.score_fn not in ("uct", "puct"):
            raise ValueError(f"score_fn {self.score_fn!r}")
        if self.leaf_mode not in ("partial", "unexpanded"):
            raise ValueError(f"leaf_mode {self.leaf_mode!r}")
        if not (self.X >= 2 and self.F >= 1 and self.D >= 1):
            raise ValueError(f"bad sizes X={self.X} F={self.F} D={self.D}")

    @property
    def Fp(self) -> int:
        return pad_fanout(self.F)

    @property
    def vl_const_fx(self) -> int:
        return fx.encode_scalar(self.vl_const)


def bucket_key(cfg: TreeConfig) -> tuple:
    """Canonical arena-pool bucket of a config: every field that can change
    a slot's bit evolution; only the fanout is padded (to Fp)."""
    return (cfg.X, cfg.Fp, cfg.D, cfg.beta, cfg.vl_mode, cfg.vl_const,
            cfg.score_fn, cfg.leaf_mode, cfg.expand_all)


def canonical_config(cfg: TreeConfig) -> TreeConfig:
    """The pool-side representative of ``cfg``'s bucket (fanout padded)."""
    return dataclasses.replace(cfg, F=cfg.Fp)


@dataclasses.dataclass
class UCTree:
    """The UCT — everything the accelerator touches, nothing else.

    Shapes are per tree; an arena adds a leading [G] axis to every field.
    """

    child: Any         # [X, Fp] i32  child node id or NULL
    edge_N: Any        # [X, Fp] i32  completed visits through edge
    edge_W: Any        # [X, Fp] i32  Qm.16 sum of backed-up values
    edge_VL: Any       # [X, Fp] i32  in-flight (virtual-loss) count
    edge_P: Any        # [X, Fp] i32  Qm.16 prior (puct only; zeros otherwise)
    node_N: Any        # [X] i32      completed visits of node
    node_O: Any        # [X] i32      in-flight visits of node (WU-UCT O_s)
    num_expanded: Any  # [X] i32
    num_actions: Any   # [X] i32      legal-action count (<= F)
    node_depth: Any    # [X] i32
    terminal: Any      # [X] i32      1 if state is terminal
    size: Any          # [] i32       next free node id
    root: Any          # [] i32
    log_table: Any     # [2X+4] f32   ln(n) table shared by all backends

    @property
    def X(self) -> int:
        return self.child.shape[-2]

    @property
    def Fp(self) -> int:
        return self.child.shape[-1]

    def map(self, fn) -> "UCTree":
        return UCTree(**{k: fn(getattr(self, k)) for k in FIELDS})


def make_log_table(x: int) -> np.ndarray:
    """ln(n) lookup shared by every backend, computed once in f64 and cast
    (tree.py of the JAX package): sized 2X+4, ln(0) := 0."""
    n = np.arange(2 * x + 4, dtype=np.float64)
    with np.errstate(divide="ignore"):
        t = np.log(n)
    t[0] = 0.0
    return t.astype(np.float32)


def init_tree_arrays(cfg: TreeConfig, root_num_actions: int | None = None) -> dict:
    """Fresh single-root tree as a dict of numpy arrays (the snapshot
    form); the numpy oracle and the tensor trees both start from it."""
    X, Fp = cfg.X, cfg.Fp
    z_e = np.zeros((X, Fp), np.int32)
    num_actions = np.zeros(X, np.int32)
    num_actions[0] = cfg.F if root_num_actions is None else int(root_num_actions)
    return dict(
        child=np.full((X, Fp), NULL, np.int32), edge_N=z_e,
        edge_W=z_e.copy(), edge_VL=z_e.copy(), edge_P=z_e.copy(),
        node_N=np.zeros(X, np.int32), node_O=np.zeros(X, np.int32),
        num_expanded=np.zeros(X, np.int32), num_actions=num_actions,
        node_depth=np.zeros(X, np.int32), terminal=np.zeros(X, np.int32),
        size=np.int32(1), root=np.int32(0), log_table=make_log_table(X))


def from_numpy(arrays: dict, device) -> UCTree:
    """Snapshot dict (numpy, as the JAX package's slot_snapshot gives it,
    with or without a leading [G] axis) -> tree of tensors on `device`.
    Always copies."""
    out = {}
    for k in FIELDS:
        a = np.asarray(arrays[k])
        dt = torch.float32 if k == "log_table" else torch.int32
        out[k] = torch.tensor(a, dtype=dt, device=device)
    return UCTree(**out)


def to_numpy(tree: UCTree) -> dict:
    """Tree of tensors -> snapshot dict of numpy arrays (int32 / f32)."""
    return {k: getattr(tree, k).detach().cpu().numpy().copy() for k in FIELDS}


def init_tree(cfg: TreeConfig, root_num_actions: int | None = None,
              device=None) -> UCTree:
    """Fresh tree with a single root node (id 0) on `device` (CUDA by
    default)."""
    return from_numpy(init_tree_arrays(cfg, root_num_actions),
                      resolve_device(device))


def init_arena(cfg: TreeConfig, G: int, root_num_actions: int | None = None,
               device=None) -> UCTree:
    """Arena of G fresh single-root trees on `device` (CUDA by default)."""
    one = init_tree(cfg, root_num_actions, device)
    return one.map(lambda a: a.unsqueeze(0).repeat((G,) + (1,) * a.dim()))


def arena_slot(arena: UCTree, g: int) -> UCTree:
    """Slot g as a single tree of views: in-place updates of the view
    write through to the arena."""
    return arena.map(lambda a: a[g])


def arena_set_slot(arena: UCTree, g: int, tree: UCTree) -> None:
    """Copy `tree` into slot g of `arena`, in place."""
    for k in FIELDS:
        getattr(arena, k)[g].copy_(getattr(tree, k))


def as_arena(tree: UCTree) -> UCTree:
    """A single tree as a G=1 arena of views (in-place updates of the
    arena write through to `tree`)."""
    return tree.map(lambda a: a.unsqueeze(0))


def where_trees(mask, new: UCTree, old: UCTree) -> UCTree:
    """Per-slot select between two arenas: mask[g] picks new slot g."""
    def pick(a, b):
        m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
        return torch.where(m, a, b)
    return UCTree(**{k: pick(getattr(new, k), getattr(old, k))
                     for k in FIELDS})
