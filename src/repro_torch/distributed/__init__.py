"""Checkpointing and the fault policy on torch (the port of
repro.distributed)."""

from repro_torch.distributed.checkpoint import (
    save_checkpoint, restore_checkpoint, latest_step, CheckpointManager,
)
from repro_torch.distributed.fault import BSPFaultPolicy, HeartbeatMonitor

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager", "BSPFaultPolicy", "HeartbeatMonitor"]
