"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at the
full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
