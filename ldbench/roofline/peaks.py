"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
card's full power limit of 700 W) that the rooflines use."""

#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
