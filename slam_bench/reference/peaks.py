"""Published peak of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit) that the rooflines use. A roofline share is stated against
it, with the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
