"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity), at its full 700 W power limit. A share of a peak is stated
against these, with the card's power limit beside it."""

BF16_FLOPS = 989e12
BYTES_PER_S = 3.35e12
