"""Fixed-point edge-weight arithmetic (paper §IV-C), on tensors and numpy.

The port's copy of repro.core.fixedpoint.  Every tree statistic is a
Qm.16 two's-complement int32, and every float op of the scoring spec is
IEEE-754 correctly rounded, so the numpy oracle, the torch ops (CPU or
CUDA) and the hand-written CUDA kernels compute bit-identical scores.

`encode` rounds half to even and then clips: ``torch.round`` and
``np.round`` both round ties to even (as does ``rintf`` in the kernels).
"""

from __future__ import annotations

import numpy as np
import torch

FRAC_BITS = 16
FX_ONE = 1 << FRAC_BITS                  # 1.0 in Qm.16
FX_SCALE = float(FX_ONE)
FX_INV_SCALE = np.float32(1.0 / FX_ONE)

# Sentinels in the fixed-point score domain (int32).
FX_FORCE_EXPLORE = np.int32(1 << 28)     # "N_eff == 0" => +inf-like score
FX_NEG_INF = np.int32(-(1 << 30))        # invalid / unexpanded edge
FX_MAX = np.int32((1 << 27) - 1)         # clamp bound for real scores so any
FX_MIN = np.int32(-(1 << 27))            # real score < FX_FORCE_EXPLORE
# The clip bounds as the f32 values the reference clips with
# (np.float32(FX_MAX) rounds up to 2**27).
FX_MIN_F32 = float(np.float32(FX_MIN))
FX_MAX_F32 = float(np.float32(FX_MAX))


def encode(x):
    """f32 -> Qm.16 int32, round-half-even, clamped to the real-score band.

    Takes a tensor (result stays on its device) or anything numpy accepts
    (result is a numpy int32 array)."""
    if isinstance(x, torch.Tensor):
        fx = torch.round(x.to(torch.float32) * FX_SCALE)
        fx = torch.clamp(fx, FX_MIN_F32, FX_MAX_F32)
        return fx.to(torch.int32)
    fx = np.round(np.asarray(x, dtype=np.float32) * np.float32(FX_SCALE))
    fx = np.clip(fx, np.float32(FX_MIN), np.float32(FX_MAX))
    return fx.astype(np.int32)


def decode(fx):
    """Qm.16 int32 -> f32."""
    if isinstance(fx, torch.Tensor):
        return fx.to(torch.float32) * float(FX_INV_SCALE)
    return np.asarray(fx).astype(np.float32) * FX_INV_SCALE


def encode_scalar(x: float) -> int:
    return int(encode(np.float32(x)))
