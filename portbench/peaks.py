"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit). Shares of a peak are stated
against these, with the card's power limit printed beside them."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
