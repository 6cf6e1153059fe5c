"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit), against which the roofline shares are stated."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
