"""Concatenate .two files (reference: lib/concat.h): verify header
compatibility (same samples + contigs), then stream all record blocks
into one output with merged literals."""

from ..io.two import TwoReader, TwoWriter
from ..utils import log, pretty_int


def concat_two(inputs, output: str) -> int:
    if len(inputs) < 2:
        raise ValueError("concat requires >= 2 input files")
    readers = [TwoReader(p) for p in inputs]
    base = readers[0].header
    for r in readers[1:]:
        if r.header.samples != base.samples:
            raise ValueError(
                f"{r.path}: sample list differs from {readers[0].path}")
        if [c.name for c in r.header.contigs] != \
                [c.name for c in base.contigs]:
            raise ValueError(
                f"{r.path}: contig list differs from {readers[0].path}")

    if not output.endswith(".two"):
        output += ".two"
    hdr = base
    extra = [r.header.literals for r in readers[1:]]
    hdr.literals = hdr.literals + "".join(
        l if l.endswith("\n") or not l else l + "\n" for l in extra)

    from ..utils.logging import stamp_literals
    stamp_literals(hdr, "concat", " ".join(inputs))
    writer = TwoWriter(output, hdr)
    n = 0
    import os as _os
    for r in readers:
        for blk in r.blocks(threads=min(4, _os.cpu_count() or 1)):
            writer.write_block(blk)
            n += len(blk)
        r.close()
    writer.close()
    log("LOG", f"Concatenated {pretty_int(n)} records from "
        f"{len(inputs)} files", sub="CONCAT")
    return n
