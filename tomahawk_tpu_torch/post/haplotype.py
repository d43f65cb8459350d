"""Extract haplotype strings for a region (reference: lib/haplotype.h):
slice the .twk archive on an interval, transpose the variant-major
genotype matrix to haplotype-major, and emit 2N haplotype sequences as
FASTA or a TSV matrix. Bases come from each variant's ref/alt alleles
(missing = 'N'), matching the reference's fasta_lookup; numeric=True
emits '0'/'1'/'2' instead (reference -n). One deliberate divergence:
the reference emits every record of every index block that OVERLAPS
the interval (haplotype.h:144-168 has no per-record interval check);
we slice exactly to the requested range."""

import sys

import numpy as np

from ..io.twk import TwkReader
from .intervals import parse_intervals, blocks_for_intervals


def haplotype(input_path: str, output: str, interval: str,
              fmt: str = "fasta", numeric: bool = False,
              out_stream=None):
    from ..io.constants import BASE_MAP_INV
    reader = TwkReader(input_path)
    ivals = parse_intervals([interval], reader.header)
    iv = ivals[0]
    blocks = blocks_for_intervals(reader, [interval])

    cols = []      # per-variant allele codes [2N]
    positions = []
    luts = []      # per-variant code -> ASCII (ref, alt, missing)
    for b in blocks:
        blk = reader.read_block(b)
        for rec in blk.rcds:
            if rec.rid != iv.rid or not (iv.start <= rec.pos <= iv.end):
                continue
            codes = rec.decode_codes()
            ca, cb = codes >> 2, codes & 0b11
            hap = np.empty(2 * len(codes), np.uint8)
            hap[0::2] = ca
            hap[1::2] = cb
            cols.append(hap)
            positions.append(rec.pos)
            if numeric:
                luts.append((ord("0"), ord("1"), ord("2")))
            else:
                ri, ai = rec.alleles >> 4, rec.alleles & 15
                ref = BASE_MAP_INV[ri] if ri < 4 else "N"
                alt = BASE_MAP_INV[ai] if ai < 4 else "N"
                luts.append((ord(ref), ord(alt), ord("N")))
    reader.close()

    n_samples = reader.header.n_samples
    stream = out_stream
    close = False
    if stream is None:
        if output in ("-", "", None):
            stream = sys.stdout
        else:
            stream = open(output, "w")
            close = True

    if not cols:
        if close:
            stream.close()
        return 0

    mat = np.stack(cols)            # [V, 2N]
    hapmat = np.ascontiguousarray(mat.T)     # [2N, V]
    # per-variant code -> ASCII in one fancy-index over the whole
    # matrix; rows then emit via tobytes (no per-allele Python strings)
    lut = np.array(luts, np.uint8)           # [V, 3]
    V = hapmat.shape[1]
    ascii_mat = lut[np.arange(V)[None, :], hapmat]

    if fmt == "fasta":
        for h in range(ascii_mat.shape[0]):
            name = reader.header.samples[h // 2]
            stream.write(f">{name}_{h % 2}\n"
                         + ascii_mat[h].tobytes().decode() + "\n")
    else:  # tsv matrix (reference haplotype.h:183-198): "Name" header
        # row of 1-based positions, then one ">sample_h" row per
        # haplotype
        stream.write("Name\t" +
                     "\t".join(str(p + 1) for p in positions) + "\n")
        inter = np.empty((ascii_mat.shape[0], 2 * V), np.uint8)
        inter[:, 0::2] = ord("\t")
        inter[:, 1::2] = ascii_mat
        for h in range(inter.shape[0]):
            name = reader.header.samples[h // 2]
            stream.write(f">{name}_{h % 2}"
                         + inter[h].tobytes().decode() + "\n")
    if close:
        stream.close()
    return hapmat.shape[1]
