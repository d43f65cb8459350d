"""Bytes and operations of one call of the port's parts tile kernel
(csrc/parts_tile.cu) for unphased genotypes with missing calls (P = 9):
the het, hom and called planes of both sides in, the prefilter mask, the
nine contraction parts and the per-segment survivor counts out),
off-diagonal, no window: each input read once, each output written
once. Operations: 64 a pair of 32-bit words in each of the nine plane
products (1-bit AND + POPC, no published peak), logged beside the
bytes' share."""

SEG = 128
PARTS = 9
PLANES = 3


def bytes_per_call(B: int, Ws: int) -> int:
    planes = 2 * PLANES * B * Ws * 4
    meta = 2 * B * (4 * 4 + 1)         # ac, an, n_het, n_hom, valid
    out = B * B * (1 + 4 * PARTS) + B * -(-B // SEG) * 4
    return planes + meta + out


def ops_per_call(B: int, Ws: int) -> int:
    return 64 * PARTS * B * B * Ws
