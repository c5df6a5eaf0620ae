"""BackUp kernel wrapper: csrc/uct_backup.cu behind the arena API.

Replaces the TPU kernel ``repro.kernels.uct_backup.backup_arena``
(``_backup_kernel``) and also covers the straggler-masked backup that the
JAX executor leaves on its jit path, so the ``cuda`` executor has one
BackUp path.

``backup_arena`` launches the CUDA kernel on a CUDA arena, or runs the
plain version (``backup_arena_plain`` = core.intree.backup_arena) on a
CPU arena.  On a CUDA tensor it launches the kernel or raises; it never
falls back.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import intree
from repro_torch.core.tree import TreeConfig, UCTree
from repro_torch.kernels import build
from repro_torch.kernels.uct_select import check_arena, check_tensor

NAME = "uct_backup"
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
# 14 pointers; G X Fp D p alternating expand_all; stream
ARGTYPES = [_P] * 14 + [_I] * 7 + [_P]


def backup_arena_plain(cfg: TreeConfig, arena: UCTree, active, sel,
                       sim_nodes, values_fx, alternating_signs=False,
                       dropped=None):
    """The plain version: core.intree.backup_arena."""
    if dropped is not None:
        dropped = dropped != 0
    return intree.backup_arena(cfg, arena, active, sel, sim_nodes, values_fx,
                               alternating_signs, dropped)


def backup_arena(cfg: TreeConfig, arena: UCTree, active: torch.Tensor,
                 sel: intree.SelectionResult, sim_nodes: torch.Tensor,
                 values_fx: torch.Tensor, alternating_signs: bool = False,
                 dropped: torch.Tensor | None = None) -> None:
    """BackUp for every active slot, in place on edge_N/W/VL, node_N/O.

    All per-worker inputs are int32 [G, p] tensors on the arena's device
    (`dropped`: nonzero = straggler, recovery-only backup); paths are
    [G, p, D].  The launch goes on the current stream and does not
    synchronise."""
    global launches
    G, X, Fp, dev = check_arena(
        arena, ("child", "edge_N", "edge_W", "edge_VL", "node_N", "node_O"))
    check_tensor("active", active, (G,), torch.int32, dev)
    if sel.path_nodes.dim() != 3:
        raise ValueError(f"path_nodes must be [G, p, D], got "
                         f"{tuple(sel.path_nodes.shape)}")
    p, D = sel.path_nodes.shape[1], sel.path_nodes.shape[2]
    if D != cfg.D or X != cfg.X or Fp != cfg.Fp:
        raise ValueError("arena / paths do not match cfg")
    for k in ("path_nodes", "path_actions"):
        check_tensor(k, getattr(sel, k), (G, p, D), torch.int32, dev)
    for k in ("depths", "leaves", "expand_action"):
        check_tensor(k, getattr(sel, k), (G, p), torch.int32, dev)
    check_tensor("sim_nodes", sim_nodes, (G, p), torch.int32, dev)
    check_tensor("values_fx", values_fx, (G, p), torch.int32, dev)
    if dropped is not None:
        check_tensor("dropped", dropped, (G, p), torch.int32, dev)
    if dev.type == "cpu":
        return backup_arena_plain(cfg, arena, active, sel, sim_nodes,
                                  values_fx, alternating_signs, dropped)
    if dev.type != "cuda":
        raise ValueError(f"uct_backup runs on cuda (or cpu: plain), not {dev}")

    lib = build.load(NAME, ARGTYPES)
    a = arena
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.uct_backup_launch(
            sel.path_nodes.data_ptr(), sel.path_actions.data_ptr(),
            sel.depths.data_ptr(), sel.leaves.data_ptr(),
            sel.expand_action.data_ptr(), sim_nodes.data_ptr(),
            values_fx.data_ptr(),
            None if dropped is None else dropped.data_ptr(),
            active.data_ptr(), a.edge_N.data_ptr(), a.edge_W.data_ptr(),
            a.edge_VL.data_ptr(), a.node_N.data_ptr(), a.node_O.data_ptr(),
            G, X, Fp, D, p, int(bool(alternating_signs)),
            int(cfg.expand_all), stream)
    build.check(NAME, rc)
    launches += 1
