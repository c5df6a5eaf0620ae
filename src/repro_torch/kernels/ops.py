"""Executor-facing wrappers of the hand-written kernels, with the same API
as repro_torch.core.intree's arena ops (mirrors repro.kernels.ops).

One launch covers every tree slot; inactive slots are untouched inside
the kernels.  Host-side masks and per-worker arrays are moved to the
arena's device as int32 here, so callers may pass numpy: through pinned
memory and a non-blocking copy, so that queueing a phase (the overlap
mode's staged Selection) never waits for the device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import TreeConfig, UCTree
from repro_torch.kernels import uct_backup, uct_select


def _i32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).contiguous()
    host = torch.from_numpy(np.ascontiguousarray(np.asarray(x), np.int32))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def select_arena(cfg: TreeConfig, arena: UCTree, active, p: int):
    """Arena Selection + expansion assignment (one kernel launch).
    Updates the arena in place; returns the SelectionResult."""
    return uct_select.select_arena(cfg, arena, _i32(active, arena.child.device), p)


def backup_arena(cfg: TreeConfig, arena: UCTree, active, sel, sim_nodes,
                 values_fx, alternating_signs: bool = False, dropped=None):
    """Arena BackUp, straggler mask included (one kernel launch), in place."""
    dev = arena.child.device
    uct_backup.backup_arena(
        cfg, arena, _i32(active, dev), sel, _i32(sim_nodes, dev),
        _i32(values_fx, dev), alternating_signs,
        None if dropped is None else _i32(dropped, dev))
