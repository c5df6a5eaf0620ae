"""The launcher's per-arch deployment choices on torch (the optimizer
half of repro.launch.specs): which archs train with the factored
optimizer (Adafactor) and which need ZeRO-3-style parameter sharding.

The rest of the JAX module (input specs for the dry run, the sharding
rules per cell and their tuned layouts) waits for the port's DeviceMesh
(ROADMAP.md queue A item 11); on one card nothing is sharded.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.optim import make_optimizer

# archs whose param+optimizer footprint needs ZeRO-3-style sharding
FSDP_ARCHS = {"recurrentgemma-9b", "gemma3-12b", "granite-3-8b",
              "deepseek-v3-671b", "mixtral-8x22b"}
# archs whose optimizer state must be factored to fit HBM
ADAFACTOR_ARCHS = {"deepseek-v3-671b", "mixtral-8x22b"}


def optimizer_for(cfg: ModelConfig):
    """(name, (init_fn, update_fn)) of the arch's optimizer."""
    name = "adafactor" if cfg.name in ADAFACTOR_ARCHS else "adamw"
    return name, make_optimizer(name, lr=3e-4, warmup=100, total=10_000)
