"""External merge sort of .two files.

Mirrors the reference two-phase design (reference: lib/two_reader.cpp:
162-422, lib/two_sorter_structs.h): phase 1 sorts memory-capped runs of
records by (ridA, ridB, Apos, Bpos) and spills them as zstd-compressed
temporary chunks; phase 2 k-way-merges the runs into a sorted .two file
with a TWK_IDX_SORTED index and per-contig meta entries.

The merge is batched rather than per-record (the reference pops one
record at a time through a priority queue, two_reader.cpp:290-398):
every iteration takes the minimum of the loaded chunk tails as a safe
boundary, slices each run up to it with a searchsorted on packed sort
keys, and lexsorts the combined batch -- each record passes through one
vectorized lexsort instead of a Python heap operation.

ALREADY-SORTED inputs (index state TWK_IDX_SORTED, e.g. per-process
shards each sorted where they were produced) skip phase 1 entirely:
each input file becomes one merge run consumed directly through the
same boundary-cut batched merge -- the analogue of the reference's
phase-2 priority-queue merge over presorted runs
(reference: lib/two_reader.cpp:272-421). This is the distributed
shard-merge path: phase-1 sorting parallelizes across the processes
that produced the shards, and the merge is a single sequential pass.
"""

import os
import struct
import tempfile

import numpy as np
import zstandard

from ..io.constants import TWK_IDX_SORTED
from ..io.two import TWO_DTYPE, TwoReader, TwoWriter, concat_records
from ..utils import Timer, log, pretty_int


def _sort_indices(recs: np.ndarray) -> np.ndarray:
    """Lexsort by (ridA, ridB, Apos, Bpos) — reference twk1_two_t
    operator< (lib/core.cpp:458-468) — native adaptive radix sort over
    two packed keys, numpy 2-key lexsort fallback."""
    from .. import native
    k1, k2 = _pack_keys(recs)
    idx = native.radix_sort_idx(k1, k2)
    if idx is None:
        idx = np.lexsort((k2, k1))
    return idx


def _pack_keys(recs: np.ndarray):
    """(k1, k2) packed sort keys: k1 = ridA<<48 | ridB<<32 | posA (rids
    < 2^16, positions < 2^32 after the 2-bit flag shift), k2 = posB.
    (k1, k2) ordering equals the reference's 4-field ordering."""
    k1 = (recs["ridA"].astype(np.uint64) << 48) \
        | (recs["ridB"].astype(np.uint64) << 32) \
        | (recs["packA"].astype(np.uint64) >> 2)
    k2 = (recs["packB"] >> 2).astype(np.uint32)
    return k1, k2


def _cut_at(k1, k2, b1, b2) -> int:
    """Index of the first record with key > boundary (b1, b2) in a
    (k1, k2)-sorted run."""
    lo = int(np.searchsorted(k1, b1, "left"))
    hi = int(np.searchsorted(k1, b1, "right"))
    return lo + int(np.searchsorted(k2[lo:hi], b2, "right"))


class _MergeCursor:
    """Streams one sorted run chunk-by-chunk from a chunk iterator,
    keeping several chunks buffered so boundary batches stay large."""
    __slots__ = ("_chunks", "recs", "k1", "k2", "bufs", "cur", "done")
    BUFFER_CHUNKS = 8

    def __init__(self, chunk_iter):
        self._chunks = chunk_iter
        self.done = False
        self.recs = np.zeros(0, TWO_DTYPE)
        self.k1 = np.zeros(0, np.uint64)
        self.k2 = np.zeros(0, np.uint32)
        # ping-pong record buffers: refill() concatenates the
        # unconsumed tail with new chunks into the OTHER buffer
        # (never overlapping its own source views) and reuses
        # pages instead of re-faulting fresh allocations
        self.bufs = [np.zeros(0, TWO_DTYPE), np.zeros(0, TWO_DTYPE)]
        self.cur = 0
        self.refill()

    def refill(self):
        parts = [self.recs]
        for _ in range(self.BUFFER_CHUNKS):
            if self.done:
                break
            try:
                parts.append(next(self._chunks))
            except StopIteration:
                self.done = True
        if len(parts) > 1:
            total = sum(len(p) for p in parts)
            dst = 1 - self.cur
            if len(self.bufs[dst]) < total:
                self.bufs[dst] = np.empty(total + 4096, TWO_DTYPE)
            self.recs = concat_records(parts, out=self.bufs[dst])
            self.cur = dst
            self.k1, self.k2 = _pack_keys(self.recs)

    def consume(self, cut: int):
        self.recs = self.recs[cut:]
        self.k1 = self.k1[cut:]
        self.k2 = self.k2[cut:]
        if len(self.recs) == 0 and not self.done:
            self.refill()

    def exhausted(self):
        return len(self.recs) == 0 and self.done


def _kway_merge(cursors, writer):
    """Boundary-cut batched merge of sorted cursors into `writer`."""
    from ..native import gather_rows
    if len(cursors) == 1:
        cur = cursors[0]
        while not cur.exhausted():
            writer.add(cur.recs)
            cur.consume(len(cur.recs))
        return
    mbuf = np.zeros(0, TWO_DTYPE)
    gbuf = np.zeros(0, TWO_DTYPE)
    while True:
        live = [c for c in cursors if not c.exhausted()]
        if not live:
            break
        # safe boundary: the smallest loaded tail key -- every
        # record <= it is already in memory across all runs
        tails = [(c.k1[-1], c.k2[-1]) for c in live]
        b1, b2 = min(tails)
        batch = []
        for c in live:
            cut = (len(c.recs) if (c.k1[-1], c.k2[-1]) == (b1, b2)
                   else _cut_at(c.k1, c.k2, b1, b2))
            if cut:
                batch.append(c.recs[:cut])
                c.consume(cut)
        total = sum(len(b) for b in batch)
        if len(mbuf) < total:
            mbuf = np.empty(total + 4096, TWO_DTYPE)
            gbuf = np.empty(total + 4096, TWO_DTYPE)
        merged = concat_records(batch, out=mbuf)
        order = _sort_indices(merged)
        gathered = gather_rows(merged, order, out=gbuf)
        # safe: writer.add copies the tail and writes full
        # blocks before returning, retaining no reference
        writer.add(gathered if gathered is not None else merged[order])


def _open_readers(input_path):
    inputs = ([input_path] if isinstance(input_path, str)
              else list(input_path))
    readers = [TwoReader(p) for p in inputs]
    reader = readers[0]
    for r in readers[1:]:
        if r.header.samples != reader.header.samples:
            raise ValueError(
                f"{r.path}: sample list differs from {reader.path}")
        if [c.name for c in r.header.contigs] != \
                [c.name for c in reader.header.contigs]:
            raise ValueError(
                f"{r.path}: contig list differs from {reader.path}")
    return inputs, readers


def merge_sorted_two(input_path, output_path: str, c_level: int = 1,
                     threads: int = 0, _readers=None) -> int:
    """K-way merge of ALREADY-SORTED .two files (presorted shards) into
    one sorted .two: no phase-1 re-sort, one sequential pass. Each
    input streams through the same boundary-cut batched merge the
    external sort's phase 2 uses (reference analogue: the
    priority-queue run merge, lib/two_reader.cpp:272-421).

    `_readers`: already-open TwoReaders for input_path (sort_two hands
    its own over instead of paying a second open/header parse). The
    readers are closed here in every path, including validation
    errors."""
    timer = Timer()
    if _readers is not None:
        inputs = ([input_path] if isinstance(input_path, str)
                  else list(input_path))
        readers = _readers
    else:
        inputs, readers = _open_readers(input_path)
    try:
        for r in readers:
            if r.index.state != TWK_IDX_SORTED:
                raise ValueError(f"{r.path}: not sorted (state="
                                 f"{r.index.state}); use sort_two")
        if not output_path.endswith(".two"):
            output_path += ".two"
        n_total = sum(r.n_records for r in readers)
        log("LOG", f"Merging {len(readers)} presorted file(s), "
            f"{pretty_int(n_total)} records (no re-sort)...", sub="SORT")
        from ..utils.logging import stamp_literals
        stamp_literals(readers[0].header, "sort", " ".join(inputs))
        writer = TwoWriter(output_path, readers[0].header,
                           c_level=c_level, state=TWK_IDX_SORTED)
        dec_threads = min(2, os.cpu_count() or 1) if threads == 0 \
            else threads
        cursors = [_MergeCursor(r.blocks(threads=dec_threads))
                   for r in readers]
        _kway_merge(cursors, writer)
        writer.close()
    finally:
        for r in readers:
            r.close()
    log("LOG", f"Merged {pretty_int(n_total)} records in "
        f"{timer.elapsed_string()}", sub="SORT")
    return n_total


def sort_two(input_path, output_path: str,
             memory_limit_gb: float = 0.5, run_chunk: int = 10000,
             c_level: int = 1, threads: int = 0) -> int:
    """Sort one .two file -- or several header-compatible shards at
    once (`input_path` may be a list): phase 1 streams blocks from
    every input straight into sorted runs, so merging distributed
    shards costs no concat round-trip through the disk (the reference
    recipe is concat-then-sort, docs/job-balancing.md; feeding the
    sorter directly halves the IO and is the `merge_shards` path).
    Inputs that are ALL already sorted skip phase 1 and k-way merge
    directly (merge_sorted_two)."""
    import os as _os
    from concurrent.futures import ThreadPoolExecutor
    inputs, readers = _open_readers(input_path)
    if all(r.index.state == TWK_IDX_SORTED for r in readers):
        # hand the open readers over (no second open/header parse);
        # merge_sorted_two closes them in every path
        return merge_sorted_two(inputs, output_path, c_level=c_level,
                                threads=threads, _readers=readers)
    n_threads = threads if threads > 0 else (_os.cpu_count() or 1)
    pool = ThreadPoolExecutor(n_threads) if n_threads > 1 else None
    timer = Timer()
    reader = readers[0]
    if not output_path.endswith(".two"):
        output_path += ".two"

    limit_recs = max(run_chunk,
                     int(memory_limit_gb * (1 << 30) / TWO_DTYPE.itemsize))

    # ---------------- phase 1: sorted runs -> temp file ----------------
    tmp_fd, tmp_path = tempfile.mkstemp(suffix=".twk_sort",
                                        dir=os.path.dirname(
                                            os.path.abspath(output_path)))
    runs = []  # list of (foff, fend, n)
    cctx = zstandard.ZstdCompressor(level=c_level)
    n_total = 0
    with os.fdopen(tmp_fd, "wb") as tmp:
        buf = []
        buf_n = 0
        pending = []   # run futures, written in submission order

        import threading
        tls = threading.local()

        def _sort_and_compress(parts):
            """Runs in the pool: numpy sorts and zstd both release the
            GIL, so whole runs pipeline against the reader. Per-worker
            scratch buffers persist across runs -- fresh multi-hundred-
            MB allocations re-fault pages every run otherwise."""
            from ..native import gather_rows
            sc = getattr(tls, "bufs", None)
            total = sum(len(p) for p in parts)
            if sc is None or len(sc[0]) < total:
                sc = (np.empty(total + 1024, TWO_DTYPE),
                      np.empty(total + 1024, TWO_DTYPE))
                tls.bufs = sc
            recs = concat_records(parts, out=sc[0])
            order = _sort_indices(recs)
            gathered = gather_rows(recs, order, out=sc[1])
            recs = gathered if gathered is not None else recs[order]
            c = zstandard.ZstdCompressor(level=c_level) if pool else cctx
            out = []
            for s in range(0, len(recs), run_chunk):
                part = recs[s:s + run_chunk]
                out.append((len(part), c.compress(part.data)))
            return len(recs), out

        def _write_run(n_recs, chunks):
            foff = tmp.tell()
            for n_part, comp in chunks:
                tmp.write(struct.pack("<II", n_part, len(comp)))
                tmp.write(comp)
            runs.append((foff, tmp.tell(), n_recs))

        def flush_run(final=False):
            nonlocal buf, buf_n
            if buf_n:
                if pool:
                    pending.append(pool.submit(_sort_and_compress, buf))
                else:
                    _write_run(*_sort_and_compress(buf))
                buf, buf_n = [], 0
            # bound in-flight runs (each holds up to limit_recs records)
            while pending and (final or len(pending) > 2):
                _write_run(*pending.pop(0).result())

        for rd in readers:
            for blk in rd.blocks(threads=min(2, _os.cpu_count() or 1)):
                buf.append(blk)
                buf_n += len(blk)
                n_total += len(blk)
                if buf_n >= limit_recs:
                    flush_run()
        flush_run(final=True)
        tmp.flush()   # phase 2 reads via a separate handle

        # ------------- phase 2: k-way merge of runs -> writer -------------
        log("LOG", f"Merging {len(runs)} run(s), "
            f"{pretty_int(n_total)} records...", sub="SORT")
        from ..utils.logging import stamp_literals
        stamp_literals(reader.header, "sort", " ".join(inputs))
        writer = TwoWriter(output_path, reader.header,
                           c_level=c_level, state=TWK_IDX_SORTED)

        def run_chunks(foff, fend):
            """Decompressed chunk iterator over one temp-file run."""
            dctx = zstandard.ZstdDecompressor()
            with open(tmp_path, "rb") as fh:
                pos = foff
                while pos < fend:
                    fh.seek(pos)
                    n, nc = struct.unpack("<II", fh.read(8))
                    data = dctx.decompress(
                        fh.read(nc),
                        max_output_size=n * TWO_DTYPE.itemsize)
                    pos = fh.tell()
                    yield np.frombuffer(data, TWO_DTYPE)

        cursors = [_MergeCursor(run_chunks(f, e)) for f, e, _ in runs]
        _kway_merge(cursors, writer)
        writer.close()
    os.unlink(tmp_path)
    if pool is not None:
        pool.shutdown()
    for rd in readers:
        rd.close()
    log("LOG", f"Sorted {pretty_int(n_total)} records in "
        f"{timer.elapsed_string()}", sub="SORT")
    return n_total
