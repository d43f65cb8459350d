""".two LD-record streams.

Byte-compatible with the reference container (reference:
lib/core.cpp:470-518 record serialization, :626-642 block serialization;
include/writer.h:225-313 writer framing). Records are held as numpy
structured arrays whose in-memory layout exactly matches the 106-byte
packed wire format, so whole blocks (de)serialize with frombuffer/tobytes.

Layout:
  "TWO\\x01" | u64 b_unc | u64 b_cmp | zstd(VcfHeader)
  { u8 marker=1 | u32 b_unc | u32 b_cmp | zstd(u32 n | u32 m | n records) }*
  u8 marker=0 | u64 b_unc | u64 b_cmp | zstd(IndexOutput) | u64 index_offset
  | 32-byte EOF sentinel
"""

import struct
import sys
from typing import Iterator, Optional

import numpy as np
import zstandard

from .buffer import BufferReader
from .constants import TWO_MAGIC, FILE_EOF, TWK_IDX_UNSORTED
from .errors import (CorruptFileError, decompress_checked, parse_checked,
                     read_exact)
from .header import VcfHeader
from .index import IndexOutput, IndexEntry

# Packed wire layout of one record (106 bytes). posA/posB are stored packed:
# pos << 2 | phased << 1 | miss.
TWO_DTYPE = np.dtype([
    ("controller", "<u2"),
    ("ridA", "<u4"), ("ridB", "<u4"),
    ("packA", "<u4"), ("packB", "<u4"),
    ("cnt", "<f8", (4,)),           # REFREF, ALTREF, REFALT, ALTALT
    ("D", "<f8"), ("Dprime", "<f8"), ("R", "<f8"), ("R2", "<f8"),
    ("P", "<f8"), ("ChiSqFisher", "<f8"), ("ChiSqModel", "<f8"),
])
assert TWO_DTYPE.itemsize == 106

LD_COLUMNS = ("FLAG", "CHROM_A", "POS_A", "CHROM_B", "POS_B",
              "REF_REF", "REF_ALT", "ALT_REF", "ALT_ALT",
              "D", "Dprime", "R", "R2", "P", "ChiSqFisher", "ChiSqModel")


def pack_pos(pos, phased=0, miss=0):
    return (np.asarray(pos, np.uint32) << 2) | \
           (np.asarray(phased, np.uint32) << 1) | np.asarray(miss, np.uint32)


def unpack_pos(packed):
    packed = np.asarray(packed, np.uint32)
    return packed >> 2, (packed >> 1) & 1, packed & 1


def two_records_from_bytes(payload: bytes) -> np.ndarray:
    """Decode one uncompressed block payload into a structured array."""
    r = BufferReader(payload)
    n = r.u32()
    _m = r.u32()
    recs = np.frombuffer(payload, dtype=TWO_DTYPE, count=n, offset=8)
    return recs


def two_records_to_bytes(recs: np.ndarray) -> bytes:
    recs = np.ascontiguousarray(recs, dtype=TWO_DTYPE)
    return struct.pack("<II", len(recs), max(len(recs), 1)) + recs.tobytes()


def concat_records(parts, out=None):
    """Concatenate fixed-itemsize (structured) record arrays via raw
    uint8 views: numpy's structured-dtype concatenate/fancy-index walks
    a generic void path ~100x slower than memcpy at TWO_DTYPE sizes.
    A single non-empty part is returned as-is when no `out` is given
    (callers treat results as read-only). Pass a reusable `out` buffer
    (len >= total) on hot paths — fresh large allocations mmap new
    pages and fault latency dominates; the filled prefix is returned."""
    parts = [p for p in parts if len(p)]
    if not parts:
        return np.zeros(0, TWO_DTYPE)
    if len(parts) == 1 and out is None:
        return parts[0]
    dt = parts[0].dtype
    total = sum(len(p) for p in parts)
    if out is None:
        out = np.empty(total, dt)
    else:
        assert out.dtype == dt and len(out) >= total
        out = out[:total]
    dst = out.view(np.uint8)
    o = 0
    for p in parts:
        b = np.ascontiguousarray(p).view(np.uint8)
        dst[o:o + len(b)] = b
        o += len(b)
    return out


class _CountingWriter:
    """Unseekable sink (stdout) with a byte counter standing in for
    tell(), so block/index offsets stay internally consistent."""

    def __init__(self, raw):
        self._raw = raw
        self._n = 0

    def write(self, data):
        self._raw.write(data)
        self._n += len(data)

    def tell(self):
        return self._n

    def flush(self):
        self._raw.flush()

    def close(self):
        self._raw.flush()   # never close stdout


class TwoWriter:
    """Streaming block writer for .two files.

    `async_blocks=True` moves block zstd compression + file writes onto
    a single background worker (FIFO, so block order and index offsets
    are unchanged): `add` then costs the caller one memcpy into the
    block payload, and the compression CPU overlaps whatever the caller
    does next -- on the LD engine's consumer thread that is the next
    segment's survivor transfer (IO-bound), which is exactly the
    overlap the reference gets from compressing on its N slave threads
    (reference: ld_engine.cpp:1742-1764)."""

    def __init__(self, path: str, header: VcfHeader, c_level: int = 1,
                 block_limit: int = 10000, state: int = TWK_IDX_UNSORTED,
                 async_blocks: bool = False):
        self.path = path
        self.header = header
        self.c_level = c_level
        self.block_limit = block_limit
        self.index = IndexOutput(header.n_contigs)
        self.index.state = state
        self.n_records = 0
        self._tail_buf = None   # writer-owned sub-block tail
        self._pending_n = 0
        self._tail_rid = None
        self._cctx = zstandard.ZstdCompressor(level=c_level)
        self._wq = None         # async worker queue
        self._wthread = None
        self._werr = None
        self._async = bool(async_blocks)
        # "-" = stdout, like the reference's twk_two_writer_t::Open
        # (writer.h:173-174); offsets come from a counting wrapper so
        # the (unseekable) footer index stays internally consistent
        self._fh = _CountingWriter(sys.stdout.buffer) if path == "-" \
            else open(path, "wb")
        self._fh.write(TWO_MAGIC)
        hdr_buf = header.serialize()
        comp = self._cctx.compress(hdr_buf)
        self._fh.write(struct.pack("<QQ", len(hdr_buf), len(comp)))
        self._fh.write(comp)

    def add(self, recs: np.ndarray):
        """Queue records; flushes in block_limit-sized blocks. Full
        blocks are written straight from the caller's array (zero
        copy); only the sub-block tail is copied into a writer-owned
        buffer, so `add` retains NO reference to `recs` after it
        returns (callers may reuse scratch buffers). In sorted mode a
        block never straddles a ridA change (the reference merge
        flushes on rid change, two_reader.cpp:367-371), so each index
        entry's rid/minpos/maxpos describe one contig."""
        if len(recs) == 0:
            return
        recs = np.ascontiguousarray(recs, dtype=TWO_DTYPE)
        if self.index.state != 2:       # TWK_IDX_SORTED
            self._emit(recs)
            return
        rid = recs["ridA"]
        cuts = np.flatnonzero(rid[1:] != rid[:-1]) + 1
        for part in (np.split(recs, cuts) if len(cuts) else [recs]):
            if self._pending_n and self._tail_rid != int(part["ridA"][0]):
                self._flush_tail()
            self._emit(part)
            self._tail_rid = int(part["ridA"][-1])

    def _emit(self, recs: np.ndarray):
        i, n = 0, len(recs)
        bl = self.block_limit
        item = TWO_DTYPE.itemsize
        while i < n:
            if self._pending_n == 0 and n - i >= bl:
                self.write_block(recs[i:i + bl])
                i += bl
                continue
            take = min(bl - self._pending_n, n - i)
            if self._tail_buf is None:
                self._tail_buf = np.empty(bl, TWO_DTYPE)
            dst = self._tail_buf.view(np.uint8)
            src = recs.view(np.uint8)
            dst[self._pending_n * item:(self._pending_n + take) * item] \
                = src[i * item:(i + take) * item]
            self._pending_n += take
            i += take
            if self._pending_n == bl:
                self._flush_tail()

    def _flush_tail(self):
        if self._pending_n:
            self.write_block(self._tail_buf[:self._pending_n])
            self._pending_n = 0

    def write_block(self, recs: np.ndarray,
                    ent: Optional[IndexEntry] = None):
        """Write one block immediately (bypasses pending buffering).
        In async mode the payload is snapshotted here (so callers may
        reuse their record buffers) and compressed + written in block
        order on the worker."""
        if len(recs) == 0:
            return
        if self._async:
            # snapshot into a recycled payload buffer: fresh ~1MB bytes
            # objects are mmap'd and page-fault on first touch, which
            # dominates the copy at full block rate
            recs = np.ascontiguousarray(recs, dtype=TWO_DTYPE)
            size = 8 + len(recs) * TWO_DTYPE.itemsize
            payload = self._payload_buf(size)
            struct.pack_into("<II", payload, 0, len(recs),
                             max(len(recs), 1))
            np.frombuffer(payload, np.uint8, size - 8, 8)[:] = \
                recs.view(np.uint8).ravel()
            payload = memoryview(payload)[:size]
        else:
            payload = two_records_to_bytes(recs)
        if ent is None:
            ent = IndexEntry()
            if self.index.state == 2:  # TWK_IDX_SORTED
                rid_b = int(recs["ridB"][0])
                if not np.all(recs["ridB"] == rid_b):
                    rid_b = -1
                ent.rid = int(recs["ridA"][0])
                ent.ridB = rid_b
                ent.minpos = int(recs["packA"][0]) >> 2
                ent.maxpos = int(recs["packA"][-1]) >> 2
            else:
                ent.rid = -1
                ent.ridB = -1
        ent.n = len(recs)
        ent.b_unc = len(payload)
        self.n_records += len(recs)
        if self._async:
            if self._werr is not None:
                raise RuntimeError("async .two writer failed") \
                    from self._werr
            if self._wq is None:
                import queue
                import threading
                self._wq = queue.Queue(maxsize=8)
                self._wthread = threading.Thread(
                    target=self._write_worker, name="twk-two-write",
                    daemon=True)
                self._wthread.start()
            self._wq.put((payload, ent))
            return
        self._emit_block(payload, ent)

    def _emit_block(self, payload: bytes, ent: IndexEntry):
        comp = self._cctx.compress(payload)
        ent.b_cmp = len(comp)
        ent.foff = self._fh.tell()
        self._fh.write(struct.pack("<BII", 1, len(payload), len(comp)))
        self._fh.write(comp)
        ent.fend = self._fh.tell()
        self.index.add(ent)
        if self.index.state == 2 and ent.rid >= 0:
            self.index.add_meta(ent)

    def _payload_buf(self, size: int) -> bytearray:
        """A recycled payload bytearray of at least `size` bytes (the
        worker returns buffers after writing them)."""
        free = getattr(self, "_free_bufs", None)
        if free is None:
            free = self._free_bufs = []
        for i, b in enumerate(free):
            if len(b) >= size:
                return free.pop(i)
        return bytearray(max(size, 1 << 20))

    def _write_worker(self):
        while True:
            item = self._wq.get()
            if item is None:
                self._wq.task_done()
                return
            try:
                if self._werr is None:
                    self._emit_block(*item)
            except Exception as e:  # noqa: BLE001 - reraised on add/close
                self._werr = e
            finally:
                payload = item[0]
                if isinstance(payload, memoryview) \
                        and len(self._free_bufs) < 16:
                    self._free_bufs.append(payload.obj)
                self._wq.task_done()

    def _drain_async(self):
        """Block until every queued block is compressed, written, and
        indexed (the writer state is then a plain synchronous one)."""
        if self._wq is not None:
            self._wq.join()
        if self._werr is not None:
            err, self._werr = self._werr, None
            raise RuntimeError("async .two writer failed") from err


    def checkpoint_state(self) -> dict:
        """Durable snapshot for in-run checkpointing: flush all pending
        records into blocks, fsync, and return everything needed to
        resume appending after a crash (`TwoWriter.resume`). Flushing
        at a checkpoint may cut a block short of block_limit; readers
        are indifferent to block sizes."""
        import os
        self._flush_tail()
        self._drain_async()
        self._fh.flush()
        os.fsync(self._fh.fileno())
        return {
            "offset": self._fh.tell(),
            "n_records": self.n_records,
            "index": self.index.serialize(),
        }

    @classmethod
    def resume(cls, path: str, header: VcfHeader, state: dict,
               c_level: int = 1, block_limit: int = 10000,
               async_blocks: bool = False):
        """Reopen `path` for appending from a `checkpoint_state` dict:
        the file is truncated to the checkpointed offset (dropping any
        torn tail a crash left) and the block index restored."""
        w = cls.__new__(cls)
        w.path = path
        w.header = header
        w.c_level = c_level
        w.block_limit = block_limit
        w.index = IndexOutput.deserialize(bytes(state["index"]), path=path)
        w.n_records = state["n_records"]
        w._tail_buf = None
        w._pending_n = 0
        w._tail_rid = None
        w._cctx = zstandard.ZstdCompressor(level=c_level)
        w._wq = None
        w._wthread = None
        w._werr = None
        w._async = bool(async_blocks)
        try:
            w._fh = open(path, "r+b")
        except FileNotFoundError:
            raise CorruptFileError(
                path, "cannot resume: checkpointed output is missing "
                "(delete the checkpoint sidecar to start over)", 0
            ) from None
        end = w._fh.seek(0, 2)
        if end < state["offset"]:
            raise CorruptFileError(
                path, f"cannot resume: file shorter ({end}) than "
                f"checkpoint offset ({state['offset']})", end)
        w._fh.truncate(state["offset"])
        w._fh.seek(state["offset"])
        return w

    def close(self):
        self._flush_tail()
        if self._wq is not None:
            self._wq.put(None)
            self._wthread.join()
            self._wq = None
            self._wthread = None
        if self._werr is not None:
            err, self._werr = self._werr, None
            raise RuntimeError("async .two writer failed") from err
        idx_buf = self.index.serialize()
        comp = self._cctx.compress(idx_buf)
        index_offset = self._fh.tell()
        self._fh.write(struct.pack("<B", 0))
        self._fh.write(struct.pack("<QQ", len(idx_buf), len(comp)))
        self._fh.write(comp)
        self._fh.write(struct.pack("<Q", index_offset))
        self._fh.write(FILE_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TwoReader:
    """Random-access + streaming reader for .two files."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        self._dctx = zstandard.ZstdDecompressor()
        magic = self._fh.read(len(TWO_MAGIC))
        if magic != TWO_MAGIC:
            raise CorruptFileError(path, "not a .two file (bad magic)", 0)
        b_unc, b_cmp = struct.unpack(
            "<QQ", read_exact(self._fh, 16, path, "header sizes"))
        hoff = self._fh.tell()
        self.header = parse_checked(
            VcfHeader.deserialize,
            decompress_checked(
                self._dctx, read_exact(self._fh, b_cmp, path, "header"),
                b_unc, path, "header", hoff),
            path, "header", hoff)
        self._data_start = self._fh.tell()

        end = self._fh.seek(0, 2)
        if end < self._data_start + len(FILE_EOF) + 8:
            raise CorruptFileError(path, "truncated file (no footer)", end)
        self._fh.seek(-(len(FILE_EOF) + 8), 2)
        index_offset, = struct.unpack("<Q", self._fh.read(8))
        eof = self._fh.read(len(FILE_EOF))
        if eof != FILE_EOF:
            raise CorruptFileError(path, "truncated file (bad EOF sentinel)",
                                   end - len(FILE_EOF))
        if not self._data_start <= index_offset < end:
            raise CorruptFileError(
                path, f"corrupt footer: index offset {index_offset} "
                "out of range", end - len(FILE_EOF) - 8)
        self._fh.seek(index_offset)
        marker, ib_unc, ib_cmp = struct.unpack(
            "<BQQ", read_exact(self._fh, 17, path, "index header"))
        if marker != 0:
            raise CorruptFileError(path, "corrupt footer marker",
                                   index_offset)
        self.index = IndexOutput.deserialize(
            decompress_checked(
                self._dctx, read_exact(self._fh, ib_cmp, path, "index"),
                ib_unc, path, "index", index_offset + 17),
            path=path)
        self._fh.seek(self._data_start)

    def _read_compressed(self, i: int):
        """(compressed bytes, b_unc, foff) of block i; IO only."""
        ent = self.index.ent[i]
        self._fh.seek(ent.foff)
        marker, b_unc, b_cmp = struct.unpack(
            "<BII", read_exact(self._fh, 9, self.path, "block header"))
        if marker != 1:
            raise CorruptFileError(self.path, "corrupt block marker",
                                   ent.foff)
        return (read_exact(self._fh, b_cmp, self.path, "block"),
                b_unc, ent.foff)

    def _decode(self, comp, b_unc, foff, dctx=None) -> np.ndarray:
        payload = decompress_checked(
            dctx or self._dctx, comp, b_unc, self.path, "block", foff + 9)
        try:
            return two_records_from_bytes(payload)
        except (EOFError, struct.error, ValueError) as e:
            raise CorruptFileError(self.path, f"corrupt block payload: {e}",
                                   foff + 9) from None

    def read_block(self, i: int) -> np.ndarray:
        return self._decode(*self._read_compressed(i))

    def stream_blocks(self, ids, threads: int = 0
                      ) -> Iterator[np.ndarray]:
        """Stream the given block ids in order. threads > 1 pipelines
        the zstd decode across a pool (zstandard releases the GIL):
        compressed bytes are read sequentially here, workers decompress
        with thread-local contexts, and blocks yield in id order. The
        in-flight window bounds memory at ~2*threads blocks."""
        ids = list(ids)
        if threads <= 1 or len(ids) < 4:
            for i in ids:
                yield self.read_block(i)
            return
        import threading
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        tls = threading.local()

        def decode(args):
            comp, b_unc, foff = args
            d = getattr(tls, "d", None)
            if d is None:
                d = tls.d = zstandard.ZstdDecompressor()
            return self._decode(comp, b_unc, foff, dctx=d)

        window = 2 * threads
        with ThreadPoolExecutor(threads) as pool:
            pending = deque()
            for i in ids:
                pending.append(pool.submit(decode,
                                           self._read_compressed(i)))
                if len(pending) >= window:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()

    def blocks(self, threads: int = 0) -> Iterator[np.ndarray]:
        yield from self.stream_blocks(range(self.index.n),
                                      threads=threads)

    def records(self) -> np.ndarray:
        """All records concatenated (loads whole file)."""
        return concat_records(list(self.blocks()))

    @property
    def n_records(self) -> int:
        return sum(e.n for e in self.index.ent)

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
