"""Operations of one call of the port's parts tile kernel for unphased
genotypes with missing calls (csrc/parts_tile.cu, P = 9), counted from
its contraction loop (csrc/mma_tile.cuh `Contraction::run`): a thread
block of 32 x 64 pairs walks the row's words in steps of 8 (one
m16n8k256 MMA), the last step cut at W only by its zero words, so each
block contracts ceil(W / 8) x 8 words of each of the nine plane
products; the grid covers ceil(B / 32) x ceil(B / 64) blocks. 64
operations a pair of 32-bit words (an AND and an add of each bit), as
ldbench/roofline/mma_b1.py counts them. Bytes: ldbench/roofline/
parts_tile.py."""

PARTS = 9
#: a thread block's rows and columns, and the words of one MMA step
ROWS, COLS, STEP = 32, 64, 8


def pair_words(B: int, Ws: int) -> int:
    """Pair-words one call contracts, over the nine products."""
    rows = -(-B // ROWS) * ROWS
    cols = -(-B // COLS) * COLS
    return PARTS * rows * cols * (-(-Ws // STEP) * STEP)


def ops_per_call(B: int, Ws: int) -> int:
    return 64 * pair_words(B, Ws)
