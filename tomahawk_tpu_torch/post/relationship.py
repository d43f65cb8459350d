"""Pairwise sample kinship / identity-by-state matrix.

The reference computes this with nested RLE-run loops per variant
(reference: lib/relationship.h:130-229; scoring: same homozygote -> 2,
opposite homozygotes -> 0, anything involving a heterozygote -> 1,
normalized by 2 * n_variants, diagonal = 1). Here the scoring matrix is
decomposed into matmuls, one int8 GEMM a block of variants:

    score(i, j) = sum_v [ 1 + homref_v(i) homref_v(j)
                            + homalt_v(i) homalt_v(j)
                            - homref_v(i) homalt_v(j)
                            - homalt_v(i) homref_v(j) ]
                = V + (R^T R + A^T A - R^T A - A^T R)(i, j)
                = V + ((R - A)^T (R - A))(i, j)

with R/A the [V, N] homozygote indicator planes — a single GEMM of the
+1/0/-1 genotype matrix on a card. Missing genotypes contribute the
neutral score 1, matching the reference's treatment of hets.

Note: the reference adds 2 (instead of 1) for het-het pairs that fall
inside the same RLE run but 1 across runs; we use the documented
scoring uniformly (het-het = 1).

The GEMM runs on the device the caller names (ops/kinship.py): X4 as
torch._int_mm on a card, its plain version on the CPU. Both are exact,
so the output does not depend on the route.
"""

import sys

import numpy as np

from ..device import resolve_device
from ..io.twk import TwkReader
from ..ops import kinship
from ..utils import Timer, log, pretty_int


def relationship(input_path: str, output: str = "-", block_rows: int = 512,
                 out_stream=None, intervals=None, device: str = "cuda"):
    timer = Timer()
    # before the reader opens: a card that is missing raises here
    device = resolve_device(device)

    reader = TwkReader(input_path)
    n_samples = reader.header.n_samples

    kin = kinship.new_accumulator(n_samples, device)

    def accum(kin, g):   # g: [V, N] int8 in {-1, 0, +1}
        return kinship.gram_accumulate(kin, g)

    def to_dev(b):
        return kinship.block_to_device(b, device)

    ivals = None
    if intervals:
        from .intervals import parse_intervals
        ivals = parse_intervals(intervals, reader.header)

    def _keep(rec):
        if ivals is None:
            return True
        return any(iv.rid == rec.rid and iv.start <= rec.pos <= iv.end
                   for iv in ivals)

    if intervals:
        # only decode index-overlapping blocks for region-restricted
        # kinship (same pruning as view/aggregate/decay/haplotype)
        from .intervals import blocks_for_intervals
        blk_iter = (reader.read_block(b)
                    for b in blocks_for_intervals(reader, intervals))
    else:
        blk_iter = reader.blocks()

    n_variants = 0
    buf = np.zeros((block_rows, n_samples), np.int8)
    fill = 0
    for blk in blk_iter:
        for rec in blk.rcds:
            if not _keep(rec):
                continue
            codes = rec.decode_codes()
            ca, cb = codes >> 2, codes & 0b11
            full = (ca != 2) & (cb != 2)
            homref = full & (ca == 0) & (cb == 0)
            homalt = full & (ca == 1) & (cb == 1)
            buf[fill] = homref.astype(np.int8) - homalt.astype(np.int8)
            fill += 1
            n_variants += 1
            if fill == block_rows:
                kin = accum(kin, to_dev(buf))
                fill = 0
    if fill:
        buf[fill:] = 0
        kin = accum(kin, to_dev(buf))
    reader.close()

    kin = kinship.to_host(kin, n_samples).astype(np.float64)
    kin += n_variants                       # the +1-per-variant baseline
    np.fill_diagonal(kin, 2 * n_variants)   # reference diagonal
    kin /= 2.0 * max(n_variants, 1)

    stream = out_stream
    close = False
    if stream is None:
        if output in ("-", "", None):
            stream = sys.stdout
        else:
            stream = open(output, "w")
            close = True
    # one %.6g format per cell in Python costs minutes at 2,504^2
    # cells; the native LD row formatter's fmt_g6 is the same %.6g
    from ..native import format_g6_matrix
    rows = format_g6_matrix(kin)
    if rows is not None:
        stream.write(rows)
    else:
        for i in range(n_samples):
            stream.write("\t".join(f"{kin[i, j]:.6g}"
                                   for j in range(n_samples)) + "\n")
    if close:
        stream.close()
    log("LOG", f"Kinship over {pretty_int(n_variants)} sites x "
        f"{pretty_int(n_samples)} samples in {timer.elapsed_string()}",
        sub="RELATIONSHIP")
    return kin
