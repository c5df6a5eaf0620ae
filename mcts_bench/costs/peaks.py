"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores (TF32 off)
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12


def bound_s(bytes_: float, flops: float, flops_per_s: float = F32_FLOPS) -> float:
    """The least time the chip could take: the larger of the bytes at HBM
    bandwidth and the operations at the peak rate."""
    return max(bytes_ / HBM_BYTES_PER_S, flops / flops_per_s)
