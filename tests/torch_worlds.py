"""gloo worlds of a few CPU processes for the port's distributed tests
(test data for tests/test_torch_launch.py, not a test module).

``run_world(fn, world, tmp, *args)`` spawns `world` processes; each
joins the world through repro_torch.launch.distributed_init (the
REPRO_* environment contract, a FileStore under `tmp`, so no TCP port is
taken), runs fn(rank, *args), destroys its process group, and hands its
result back through a file.  Returns the results in rank order.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import torch.multiprocessing as mp


def _main(rank: int, world: int, tmp: str, fn, args) -> None:
    import torch.distributed as dist

    from repro_torch.launch.distributed_init import init_distributed

    os.environ.update(REPRO_NUM_PROCESSES=str(world),
                      REPRO_PROCESS_ID=str(rank))
    init_distributed("cpu", store=dist.FileStore(f"{tmp}/store", world))
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    Path(f"{tmp}/rank{rank}.pkl").write_bytes(pickle.dumps(out))


def run_world(fn, world: int, tmp, *args) -> list:
    tmp = str(tmp)
    mp.start_processes(_main, args=(world, tmp, fn, args), nprocs=world,
                       start_method="spawn")
    return [pickle.loads(Path(f"{tmp}/rank{r}.pkl").read_bytes())
            for r in range(world)]


# ----------------------------------------------------------------- workers

def moe_params(data, arch: str) -> dict:
    """The port's MoE weights of `arch` from tests/moe_shard_map_jax.py's
    output (keys "{arch}:p:{node}" or "{arch}:p:{node}/{leaf}")."""
    import torch

    p = {}
    for key in data:
        if key.startswith(f"{arch}:p:"):
            node, *path = key.split(":p:")[1].split("/")
            leaf = torch.from_numpy(data[key])
            if path:
                p.setdefault(node, {})[path[0]] = leaf
            else:
                p[node] = leaf
    return p


def moe_shard_map_worker(rank: int, npz: str) -> dict:
    """The port's shard-map MoE path on the meshes of
    tests/moe_shard_map_jax.py, from that script's weights and tokens:
    {f"{arch}:{mesh}": (y, aux, the collectives' bytes)}, and for each
    arch whether Rules(shard_experts=True) on the (1, 2) mesh raised the
    ValueError that names the rule."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe, sharding as sh

    data = dict(np.load(npz))
    rules = sh.Rules(moe_shard_map=True, shard_experts=False)
    out = {}
    for arch in ("mixtral-8x22b", "deepseek-v3-671b"):
        cfg = configs.get_config(arch, smoke=True)
        p = moe_params(data, arch)
        x = torch.from_numpy(data[f"{arch}:x"])
        for shape in ((2, 1), (1, 2)):
            mesh = make_host_mesh(shape, device="cpu")
            sh.set_context(mesh, rules)
            try:
                with collectives.record() as rec:
                    y, aux = moe.moe_forward(cfg, p, x)
            finally:
                sh.set_context(None)
            out[f"{arch}:{shape[0]}x{shape[1]}"] = (
                y.reshape(-1, cfg.d_model).numpy(), aux.numpy(), rec.bytes)
        sh.set_context(make_host_mesh((1, 2), device="cpu"),
                       sh.Rules(moe_shard_map=True, shard_experts=True))
        try:
            moe.moe_forward(cfg, p, x)
            out[f"{arch}:raised"] = ""
        except ValueError as e:
            out[f"{arch}:raised"] = str(e)
        finally:
            sh.set_context(None)
    return out
