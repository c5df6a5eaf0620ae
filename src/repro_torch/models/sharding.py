"""Explicit per-device placement (the placement half of
repro.models.sharding; its logical-axis rules come with training,
ROADMAP.md queue A item 9)."""

from __future__ import annotations

import torch


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
