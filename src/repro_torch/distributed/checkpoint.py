"""Checkpointing on torch (the port of repro.distributed.checkpoint).

The JAX package's layout and guarantees:
  * atomic: write to ``step_<n>.tmp/``, fsync, rename to ``step_<n>/`` —
    a crash mid-write never corrupts the latest checkpoint;
  * ``leaves.npz`` holds the leaves unsharded on the host, in the tree's
    leaf order (repro_torch.pytree: dict keys sorted, as jax.tree
    orders them), and ``manifest.json`` the structure, shapes and dtypes;
  * async: ``CheckpointManager(async_save=True)`` copies every leaf to
    the host before save() returns and writes on a background thread, so
    the train loop may step (in place or not) while the files are
    written;
  * retention: the last ``keep_last`` steps are kept, older ones pruned.

numpy has no bfloat16, so a bf16 leaf is stored as its uint16 bits, with
"bfloat16" as its dtype in the manifest.  Restore puts each leaf on a
device (the one given, else the target leaf's), or onto a mesh: the
elastic-restore path, where the saved layout and the restore mesh may
differ arbitrarily.  ``shardings`` is then the tree
models.sharding.make_param_shardings returns, or one ``(mesh,
placements)`` a leaf, and each host leaf becomes a DTensor on it
(``distribute_tensor``: every rank reads the whole leaf and keeps its
shard).
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.pytree import tree_leaves, tree_structure, tree_unflatten


def _to_numpy(leaf: torch.Tensor) -> tuple:
    """(host numpy array, the dtype name the manifest records)."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(a, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_checkpoint(ckpt_dir, step: int, state, extra: dict | None = None):
    """Atomic unsharded checkpoint of a tree `state` of tensors (on any
    device)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step}.tmp"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    pairs = [_to_numpy(l) for l in tree_leaves(state)]
    host, dtypes = [a for a, _ in pairs], [d for _, d in pairs]
    np.savez(tmp / "leaves.npz", **{f"l{i}": a for i, a in enumerate(host)})
    manifest = {
        "step": step,
        "n_leaves": len(host),
        "treedef": str(tree_structure(state)),
        "shapes": [list(a.shape) for a in host],
        "dtypes": dtypes,
        "time": time.time(),
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    with open(tmp / "manifest.json") as f:
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def _is_layout(x) -> bool:
    """A shardings tree's leaf: a MeshSharding or a (mesh, placements)
    pair."""
    from repro_torch.models.sharding import MeshSharding

    return isinstance(x, MeshSharding) or (
        isinstance(x, tuple) and len(x) == 2 and hasattr(x[0], "get_group"))


def _layout_leaves(tree) -> list:
    """A shardings tree's layouts in tree_leaves order (a (mesh,
    placements) pair is one leaf, not a container)."""
    if _is_layout(tree) or not isinstance(tree, (dict, list, tuple)):
        return [tree]
    kids = [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else tree
    return [l for c in kids for l in _layout_leaves(c)]


def _place(h: torch.Tensor, layout) -> torch.Tensor:
    """The host leaf h on `layout`: a device, or a mesh layout (a DTensor
    of h on it)."""
    if not _is_layout(layout):
        return h.to(layout)
    from torch.distributed.tensor import distribute_tensor

    mesh, placements = ((layout.mesh, layout.placements)
                        if hasattr(layout, "spec") else layout)
    return distribute_tensor(h.to(mesh.device_type), mesh, list(placements))


def restore_checkpoint(ckpt_dir, step: int, target, shardings=None):
    """Restore into the structure, shapes and dtypes of `target` (a tree
    of tensors, meta tensors included); returns (state, manifest).
    `shardings`: None (each leaf on the target leaf's device), one device
    for every leaf, or a tree like `target` of mesh layouts
    (MeshSharding or (mesh, placements)) onto which each leaf is
    distributed as a DTensor."""
    final = pathlib.Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((final / "manifest.json").read_text())
    leaves = tree_leaves(target)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"target {len(leaves)}")
    if shardings is None:
        layouts = [t.device for t in leaves]
    elif isinstance(shardings, (dict, list)):
        layouts = _layout_leaves(shardings)
        if len(layouts) != len(leaves):
            raise ValueError(f"shardings hold {len(layouts)} layouts, "
                             f"target {len(leaves)} leaves")
    else:
        layouts = [shardings] * len(leaves)
    out = []
    with np.load(final / "leaves.npz") as data:
        for i, t in enumerate(leaves):
            h = _from_numpy(data[f"l{i}"], manifest["dtypes"][i])
            if h.shape != t.shape:
                raise ValueError(f"leaf {i}: checkpoint shape "
                                 f"{tuple(h.shape)}, target {tuple(t.shape)}")
            out.append(_place(h.to(dtype=t.dtype), layouts[i]))
    return tree_unflatten(tree_structure(target), out), manifest


class CheckpointManager:
    """Retention + optional async save thread."""

    def __init__(self, ckpt_dir, keep_last: int = 3, async_save: bool = False):
        self.dir = pathlib.Path(ckpt_dir)
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, state, extra=None):
        if self.async_save:
            # the host snapshot is taken here, before save() returns (a
            # copy even of CPU tensors: the caller may step in place);
            # the files are written on the thread
            host = [l.detach().to("cpu", copy=True)
                    for l in tree_leaves(state)]
            host = tree_unflatten(tree_structure(state), host)
            self.wait()
            self._thread = threading.Thread(
                target=self._save_async, args=(step, host, extra), daemon=True)
            self._thread.start()
        else:
            self._save_now(step, state, extra)

    def _save_now(self, step, state, extra):
        save_checkpoint(self.dir, step, state, extra)
        self._prune()

    def _save_async(self, step, state, extra):
        try:
            self._save_now(step, state, extra)
        except Exception as e:   # raised again by wait()
            self._error = e

    def wait(self):
        """Join the writer thread; raise what an async save raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _prune(self):
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
            if not p.name.endswith(".tmp"))
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def restore_latest(self, target, shardings=None):
        s = latest_step(self.dir)
        if s is None:
            return None, None, None
        state, manifest = restore_checkpoint(self.dir, s, target, shardings)
        return s, state, manifest
