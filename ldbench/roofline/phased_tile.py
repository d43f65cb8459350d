"""Bytes and operations of one call of the port's phased tile kernel
(csrc/phased_tile.cu: haplotype alt planes of both sides in, the
prefilter mask, the ALTALT counts and the per-segment survivor counts
out), off-diagonal, no window: each input read once and each output
written once.

The operations are the 1-bit AND + POPC contraction, 64 operations a
pair of 32-bit words. No data sheet gives a peak for that instruction,
so the roofline share is taken against the bytes alone; the operations
per byte are logged beside it."""

#: mask columns a survivor-count cell covers (ops/tiles.py SEG)
SEG = 128


def bytes_per_call(B: int, Wh: int) -> int:
    planes = 2 * B * Wh * 4            # alt_i, alt_j
    meta = 2 * B * (4 + 4 + 1)         # ac, an, valid of both sides
    out = B * B * (1 + 4) + B * -(-B // SEG) * 4   # mask, ALTALT, counts
    return planes + meta + out


def ops_per_call(B: int, Wh: int) -> int:
    return 64 * B * B * Wh
