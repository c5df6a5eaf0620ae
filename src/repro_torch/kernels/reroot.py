"""Re-root kernel wrapper: csrc/reroot.cu behind the arena API.

Replaces no TPU kernel: the JAX package re-roots on the host
(``repro.core.reroot.reroot`` over a numpy snapshot).  Here the
subtree-reusing re-root of one arena slot runs in place on the arena, so
a committed move no longer copies the slot's whole tree to the host and
back (csrc/reroot.cu says what bounds it and how).

  root_row(arena, g, scratch)           the root's id, child and edge_N rows
  reroot(arena, g, new_root, scratch)   the kept ids (scratch.order, with
                                        their count first) and old2new, the
                                        kept rows in the scratch tree, and
                                        the kept ids on their way to the host
  write(arena, g, scratch)              the slot from the scratch tree
  read_order(scratch)                   the kept old ids, in new-id order

``write(reroot(...))`` leaves the slot equal, field for field, to what
``core.reroot.reroot`` builds from a snapshot of it.  Each function runs
the plain version (``*_plain``, torch ops) on a CPU arena and launches
the kernel on a CUDA arena, or raises; it never falls back.  ``launches``
counts kernel launches: one row read, then three a re-root.  A `Scratch`
is allocated once per executor; the kernels allocate nothing.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.tree import NULL, UCTree
from repro_torch.kernels import build

NAME = "reroot"
launches = 0

EDGE = ("child", "edge_N", "edge_W", "edge_VL", "edge_P")
NODE = ("node_N", "node_O", "num_expanded", "num_actions", "node_depth",
        "terminal")

_P, _I = ctypes.c_void_p, ctypes.c_int
_PP = ctypes.POINTER(ctypes.c_void_p)
ENTRY_POINTS = {
    "reroot_row_launch": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "reroot_launch": [_PP, _PP, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "reroot_write_launch": [_PP, _PP, _P, _P, _P, _P, _I, _I, _I, _P],
}


def lib() -> ctypes.CDLL:
    """The kernel's library, built at first use (nvcc), then loaded."""
    return build.load(NAME, ENTRY_POINTS)


class Scratch:
    """Everything a re-root of one slot of an X x Fp arena needs besides
    the arena: a one-slot tree (5 edge arrays, then 6 node arrays, in one
    int32 buffer), the kept ids with their count first (``order``),
    ``old2new``, the root's row, and (on a card) one pinned host buffer
    for the row and another for ``order``."""

    def __init__(self, X: int, Fp: int, device):
        self.X, self.Fp = X, Fp
        dev = torch.device(device)
        i32 = dict(dtype=torch.int32, device=dev)
        self.buf = torch.empty(X * (5 * Fp + 6), **i32)
        E = X * Fp
        self.tree = {k: self.buf[i * E:(i + 1) * E].view(X, Fp)
                     for i, k in enumerate(EDGE)}
        self.tree.update({k: self.buf[5 * E + i * X:5 * E + (i + 1) * X]
                          for i, k in enumerate(NODE)})
        self.order = torch.empty(1 + X, **i32)
        self.old2new = torch.empty(X, **i32)
        self.row = torch.empty(1 + 2 * Fp, **i32)
        pin = dev.type == "cuda"
        self.row_host = torch.empty(1 + 2 * Fp, dtype=torch.int32,
                                    pin_memory=pin)
        self.order_host = torch.empty(1 + X, dtype=torch.int32,
                                      pin_memory=pin)
        self.arena = None   # the arena checked last, and its pointers
        self.edge = self.node = None


def _check(arena: UCTree, g: int, scratch: Scratch) -> torch.device:
    """Validate `arena` against `scratch` (once: the scratch keeps the
    arena it last checked, with its pointer arrays) and the slot g."""
    if not 0 <= g < arena.child.shape[0]:
        raise IndexError(f"slot {g} of a {arena.child.shape[0]}-slot arena")
    dev = scratch.buf.device
    if scratch.arena is arena:
        return dev
    X, Fp = arena.X, arena.Fp
    if (X, Fp) != (scratch.X, scratch.Fp) or arena.child.device != dev:
        raise ValueError(f"scratch is for X={scratch.X} Fp={scratch.Fp} on "
                         f"{dev}, the arena X={X} Fp={Fp} on "
                         f"{arena.child.device}")
    if Fp & (Fp - 1):
        raise ValueError(f"Fp={Fp} is not a power of two")
    for k in EDGE + NODE + ("size", "root"):
        t = getattr(arena, k)
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"arena.{k} must be contiguous int32 on {dev}")
        if k in EDGE and t.data_ptr() % 16:
            raise ValueError(f"arena.{k} is not 16-byte aligned")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"reroot runs on cuda (or cpu: plain), not {dev}")
    ptrs = lambda names: (ctypes.c_void_p * len(names))(
        *(getattr(arena, k).data_ptr() for k in names))
    scratch.arena, scratch.edge, scratch.node = arena, ptrs(EDGE), ptrs(NODE)
    return dev


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# -- the plain versions (torch ops; the CPU path and the card's yardstick) --

def root_row_plain(arena: UCTree, g: int, scratch: Scratch) -> None:
    r = arena.root[g].long()
    scratch.row[0] = r
    scratch.row[1:1 + scratch.Fp] = arena.child[g].index_select(0, r.view(1))[0]
    scratch.row[1 + scratch.Fp:] = arena.edge_N[g].index_select(0, r.view(1))[0]
    scratch.row_host.copy_(scratch.row)


def reroot_plain(arena: UCTree, g: int, new_root: int,
                 scratch: Scratch) -> None:
    child = arena.child[g]
    level = torch.tensor([new_root], dtype=torch.int64, device=child.device)
    ids = [level]
    while level.numel():          # level order: (parent's new id, lane)
        kids = child.index_select(0, level).reshape(-1)
        level = kids[kids != NULL].long()
        ids.append(level)
    order = torch.cat(ids)
    n = order.numel()
    scratch.order[0] = n
    scratch.order[1:1 + n] = order.to(torch.int32)
    scratch.old2new.fill_(NULL)
    scratch.old2new[order] = torch.arange(n, dtype=torch.int32,
                                          device=child.device)
    kept = child.index_select(0, order)
    scratch.tree["child"][:n] = torch.where(
        kept != NULL, scratch.old2new[kept.clamp(min=0).long()], NULL)
    for k in EDGE[1:] + NODE:
        scratch.tree[k][:n] = getattr(arena, k)[g].index_select(0, order)
    scratch.tree["node_depth"][:n] -= arena.node_depth[g, new_root]
    scratch.order_host.copy_(scratch.order)


def write_plain(arena: UCTree, g: int, scratch: Scratch) -> None:
    n = int(scratch.order[0])
    for k in EDGE + NODE:
        dst = getattr(arena, k)[g]
        dst[:n] = scratch.tree[k][:n]
        dst[n:] = NULL if k == "child" else 0
    arena.size[g] = n
    arena.root[g] = 0


# -- the wrappers ------------------------------------------------------------

def root_row(arena: UCTree, g: int, scratch: Scratch):
    """(root, child row, edge_N row) of slot g, on the host: one small
    read through the pinned row buffer."""
    global launches
    dev = _check(arena, g, scratch)
    if dev.type == "cpu":
        root_row_plain(arena, g, scratch)
    else:
        with torch.cuda.device(dev):
            rc = lib().reroot_row_launch(
                arena.child.data_ptr(), arena.edge_N.data_ptr(),
                arena.root.data_ptr(), g, scratch.X, scratch.Fp,
                scratch.row.data_ptr(), scratch.row_host.data_ptr(),
                _stream(dev))
            build.check(NAME, rc)
            launches += 1
            torch.cuda.current_stream(dev).synchronize()
    row = scratch.row_host.numpy()
    Fp = scratch.Fp
    return int(row[0]), row[1:1 + Fp].copy(), row[1 + Fp:].copy()


def reroot(arena: UCTree, g: int, new_root: int, scratch: Scratch) -> None:
    """Passes 1 and 2: the kept ids and old2new, and the kept rows in the
    scratch tree; then the kept ids queued to the pinned order buffer.
    The slot is read, not written.  Does not synchronise."""
    global launches
    dev = _check(arena, g, scratch)
    if not 0 <= new_root < scratch.X:
        raise IndexError(f"new_root {new_root} outside the tree's {scratch.X} ids")
    if dev.type == "cpu":
        return reroot_plain(arena, g, new_root, scratch)
    with torch.cuda.device(dev):
        rc = lib().reroot_launch(
            scratch.edge, scratch.node, scratch.buf.data_ptr(),
            scratch.order.data_ptr(), scratch.old2new.data_ptr(),
            scratch.order_host.data_ptr(), g, scratch.X, scratch.Fp,
            new_root, _stream(dev))
    build.check(NAME, rc)
    launches += 2


def write(arena: UCTree, g: int, scratch: Scratch) -> None:
    """Pass 3: slot g from the scratch tree of the last `reroot`, in place
    (every arena tensor keeps its address).  Does not synchronise."""
    global launches
    dev = _check(arena, g, scratch)
    if dev.type == "cpu":
        return write_plain(arena, g, scratch)
    with torch.cuda.device(dev):
        rc = lib().reroot_write_launch(
            scratch.edge, scratch.node, arena.size.data_ptr(),
            arena.root.data_ptr(), scratch.buf.data_ptr(),
            scratch.order.data_ptr(), g, scratch.X, scratch.Fp, _stream(dev))
    build.check(NAME, rc)
    launches += 1


def read_order(scratch: Scratch) -> np.ndarray:
    """The kept old ids of the last `reroot`, in new-id order, from the
    pinned order buffer (on a card this waits for the re-root's copy)."""
    dev = scratch.order.device
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    host = scratch.order_host.numpy()
    return host[1:1 + host[0]].copy()


def old2new_of(order: np.ndarray, X: int) -> np.ndarray:
    """The host's old-to-new id map from the kept ids (NULL elsewhere)."""
    old2new = np.full(X, NULL, np.int32)
    old2new[order] = np.arange(len(order), dtype=np.int32)
    return old2new
