"""Device assignment for the D-sharded serving arena (the port of the
serving half of repro.launch.mesh).

A FUNCTION, not a module-level constant: importing this module touches no
device.
"""

from __future__ import annotations

import torch


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
