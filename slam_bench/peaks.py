"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit): float32 outside the tensor cores and HBM3 bandwidth. A run prints
the card's power limit beside the shares it reports."""

FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12


def bound_s(flops: float, bytes_: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / FP32_FLOPS, bytes_ / HBM_BYTES_S)
