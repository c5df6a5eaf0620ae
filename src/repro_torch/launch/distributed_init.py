"""Process-group initialization (the port of
repro.launch.distributed_init).

Each process of a run calls ``init_distributed`` before it builds a mesh.
It wires the processes into one ``torch.distributed`` world: NCCL on the
cards by default, gloo with ``device="cpu"``.  Unlike the JAX package,
which leaves a one-process world uninitialized, it also initializes a
world of one, since a ``DeviceMesh`` needs a process group.

Environment contract (the JAX package's, set by the cluster manager):
  REPRO_COORDINATOR   host:port of process 0 (default localhost:9911)
  REPRO_NUM_PROCESSES world size (default 1)
  REPRO_PROCESS_ID    this process's rank (default 0)

Nothing here runs when the module is imported.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def backend_for(device=None) -> str:
    """"nccl" for the card (the default; raises without one), "gloo" for
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return "gloo"
    if dev.type != "cuda":
        raise ValueError(f"no process-group backend for {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "init_distributed uses NCCL on CUDA devices by default and none "
            "is available; pass device='cpu' for a gloo world")
    return "nccl"


def init_distributed(device=None, store=None) -> dict:
    """Join this process to the world the environment describes (see the
    module docstring), through `store` when the caller passes one, else
    ``tcp://REPRO_COORDINATOR``.  On the card each rank uses
    ``cuda:(rank % device_count)``.  Returns {num_processes, process_id,
    coordinator, backend}; a world that is already initialized is kept."""
    num = int(os.environ.get("REPRO_NUM_PROCESSES", "1"))
    pid = int(os.environ.get("REPRO_PROCESS_ID", "0"))
    coord = os.environ.get("REPRO_COORDINATOR", "localhost:9911")
    backend = backend_for(device)
    if not dist.is_initialized():
        if backend == "nccl":
            torch.cuda.set_device(pid % torch.cuda.device_count())
        kw = {"store": store} if store is not None else {
            "init_method": f"tcp://{coord}"}
        dist.init_process_group(backend, world_size=num, rank=pid, **kw)
    return {"num_processes": num, "process_id": pid, "coordinator": coord,
            "backend": dist.get_backend()}


def is_primary() -> bool:
    return int(os.environ.get("REPRO_PROCESS_ID", "0")) == 0
