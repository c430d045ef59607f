"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit)."""

# The highest published rate at which the card takes float32 operands: TF32
# on the tensor cores. An f32-accurate implementation (3xTF32, or the CUDA
# cores' 67 TFLOP/s) reaches at most a third of it, so no share of it can
# pass 100%.
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the TF32 rate and the bytes at the HBM rate."""
    return max(flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S)


def bound_by(flops: float, nbytes: float) -> str:
    return "operations" if flops / TF32_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes"
