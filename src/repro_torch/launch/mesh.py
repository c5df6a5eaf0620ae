"""Meshes on torch (the port of repro.launch.mesh), and the device
assignment of the D-sharded serving arena.

``make_production_mesh`` returns the production meshes' *shape*
(``MeshShape``: 16x16 chips a pod, 2x16x16 for two pods).  No 256-rank
process group can exist on one host, so the dry run's arithmetic
(launch/dryrun.py, models.sharding's rules) runs on the shape alone and
lines up with the JAX package's meshes.  ``make_host_mesh`` returns a
real ``torch.distributed.device_mesh.DeviceMesh`` over the processes of
this world.

FUNCTIONS, not module-level constants: importing this module touches no
device and creates no process group.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh as names and sizes only (what models.sharding reads)."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(shape=None, axes=("data", "model"), device=None):
    """DeviceMesh over this world's processes, (1, world) by default, on
    the card (NCCL; raises without one) or with ``device="cpu"`` (gloo).
    With no process group yet, starts the world the environment describes
    (a world of one by default) through launch.distributed_init."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.distributed_init import backend_for, init_distributed

    backend_for(device)          # raises without a card unless device="cpu"
    if not dist.is_initialized():
        init_distributed(device)
    n = dist.get_world_size()
    if shape is None:
        shape = (1, n)
    dev_type = "cpu" if torch.device(
        "cuda" if device is None else device).type == "cpu" else "cuda"
    return init_device_mesh(dev_type, tuple(shape), mesh_dim_names=tuple(axes))


def serving_devices(n_shards: int, device=None) -> list:
    """The device of each of `n_shards` serving shards (service/pool.py,
    core/sharded.py): shard d lives on ``cuda:(d % device_count)``.  With
    fewer cards than shards the assignment wraps, so the D-way slot
    partition and its placement run on any host.  A non-CUDA `device`
    (``"cpu"``) puts every shard there."""
    n = max(1, int(n_shards))
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return [dev] * n
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(
            "serving shards go on CUDA devices by default and none is "
            "available; pass device='cpu' to run the plain torch path")
    return [torch.device("cuda", d % count) for d in range(n)]
