"""Selection kernel wrapper: csrc/uct_select.cu behind the arena API.

Replaces the TPU kernel ``repro.kernels.uct_select.select_arena``
(``_select_kernel``) plus its jit expansion-assignment post-pass: one
launch per superstep does Selection with virtual loss for every active
slot AND the assignment, so the wrapper returns the full
SelectionResult.

``select_arena`` launches the CUDA kernel on a CUDA arena, or runs the
plain version (``select_arena_plain`` = core.intree.select_arena, the
faithful torch ops) on a CPU arena.  On a CUDA tensor it launches the
kernel or raises; it never falls back.  ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import intree
from repro_torch.core.tree import TreeConfig, UCTree
from repro_torch.kernels import build

NAME = "uct_select"
launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# 21 pointers; G X Fp D p L wu vl_const_fx puct; beta; leaf_partial
# expand_all; stream
ARGTYPES = [_P] * 21 + [_I] * 9 + [_F, _I, _I, _P]


def select_arena_plain(cfg: TreeConfig, arena: UCTree, active, p: int):
    """The plain version: core.intree.select_arena (faithful)."""
    return intree.select_arena(cfg, arena, active, p)


def check_arena(arena: UCTree, fields, G: int | None = None) -> tuple:
    """Validate the arena fields a kernel reads: one device, int32 (f32
    for the ln table), contiguous, [G, X, Fp] / [G, X] / [G, 2X+4] / [G].
    Returns (G, X, Fp, device)."""
    G = arena.child.shape[0] if G is None else G
    if arena.child.dim() != 3:
        raise ValueError(f"child must be [G, X, Fp], got {tuple(arena.child.shape)}")
    X, Fp = arena.child.shape[1], arena.child.shape[2]
    if Fp > 128:
        raise ValueError(f"Fp={Fp} > 128 is not supported")
    shapes = {"child": (G, X, Fp), "edge_N": (G, X, Fp), "edge_W": (G, X, Fp),
              "edge_VL": (G, X, Fp), "edge_P": (G, X, Fp), "node_N": (G, X),
              "node_O": (G, X), "num_expanded": (G, X), "num_actions": (G, X),
              "terminal": (G, X), "log_table": (G, 2 * X + 4), "root": (G,),
              "size": (G,)}
    dev = arena.child.device
    for k in fields:
        check_tensor(k, getattr(arena, k), shapes[k],
                     torch.float32 if k == "log_table" else torch.int32, dev)
    return G, X, Fp, dev


def check_tensor(name: str, t, shape: tuple, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def select_arena(cfg: TreeConfig, arena: UCTree, active: torch.Tensor,
                 p: int) -> intree.SelectionResult:
    """Selection + expansion assignment for p workers on every active slot.

    Updates ``arena.edge_VL`` / ``arena.node_O`` in place (the JAX kernel
    aliases them).  `active` is a [G] int32 tensor on the arena's device.
    Outputs are allocated here; the launch goes on the current stream and
    does not synchronise."""
    global launches
    fields = ("child", "edge_N", "edge_W", "edge_VL", "edge_P", "node_N",
              "node_O", "num_expanded", "num_actions", "terminal",
              "log_table", "root", "size")
    G, X, Fp, dev = check_arena(arena, fields)
    check_tensor("active", active, (G,), torch.int32, dev)
    if Fp != cfg.Fp or X != cfg.X:
        raise ValueError(f"arena [X={X}, Fp={Fp}] does not match cfg "
                         f"[X={cfg.X}, Fp={cfg.Fp}]")
    if p < 1:
        raise ValueError(f"p={p} must be >= 1")
    if dev.type == "cpu":
        return select_arena_plain(cfg, arena, active, p)
    if dev.type != "cuda":
        raise ValueError(f"uct_select runs on cuda (or cpu: plain), not {dev}")

    lib = build.load(NAME, {f"{NAME}_launch": ARGTYPES})
    D = cfg.D
    e = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)
    sel = intree.SelectionResult(e(G, p, D), e(G, p, D), e(G, p), e(G, p),
                                 e(G, p), e(G, p), e(G, p))
    a = arena
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.uct_select_launch(
            a.child.data_ptr(), a.edge_N.data_ptr(), a.edge_W.data_ptr(),
            a.edge_P.data_ptr(), a.edge_VL.data_ptr(), a.node_N.data_ptr(),
            a.node_O.data_ptr(), a.num_expanded.data_ptr(),
            a.num_actions.data_ptr(), a.terminal.data_ptr(),
            a.log_table.data_ptr(), a.root.data_ptr(), a.size.data_ptr(),
            active.data_ptr(), sel.path_nodes.data_ptr(),
            sel.path_actions.data_ptr(), sel.depths.data_ptr(),
            sel.leaves.data_ptr(), sel.expand_action.data_ptr(),
            sel.n_insert.data_ptr(), sel.insert_base.data_ptr(),
            G, X, Fp, D, p, 2 * X + 4, int(cfg.vl_mode == "wu"),
            cfg.vl_const_fx, int(cfg.score_fn == "puct"), float(cfg.beta),
            int(cfg.leaf_mode == "partial"), int(cfg.expand_all), stream)
    build.check(NAME, rc)
    launches += 1
    return sel
