"""Optimizers and gradient compression on torch (the port of
repro.optim)."""

from repro_torch.optim.optimizers import (
    adamw, adafactor, make_optimizer, clip_by_global_norm, cosine_schedule,
)
from repro_torch.optim.compression import (
    compress_int8, decompress_int8, topk_sparsify,
)

__all__ = [
    "adamw", "adafactor", "make_optimizer", "clip_by_global_norm",
    "cosine_schedule", "compress_int8", "decompress_int8", "topk_sparsify",
]
